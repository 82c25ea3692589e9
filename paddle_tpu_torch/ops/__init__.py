"""Operator library of the torch port; importing it registers every op."""

from paddle_tpu_torch.ops import basic  # noqa: F401
from paddle_tpu_torch.ops import nn  # noqa: F401
from paddle_tpu_torch.ops import fused_ops  # noqa: F401
from paddle_tpu_torch.ops import io_ops  # noqa: F401
from paddle_tpu_torch.ops import flash_attention  # noqa: F401
from paddle_tpu_torch.ops import optim  # noqa: F401
from paddle_tpu_torch.ops import amp  # noqa: F401
from paddle_tpu_torch.ops import epilogue  # noqa: F401
from paddle_tpu_torch.ops import conv_epilogue  # noqa: F401
from paddle_tpu_torch.ops import metrics  # noqa: F401
from paddle_tpu_torch.ops import flash_decode  # noqa: F401
from paddle_tpu_torch.ops import control_flow  # noqa: F401
from paddle_tpu_torch.ops import quant  # noqa: F401
from paddle_tpu_torch.ops import vision  # noqa: F401
from paddle_tpu_torch.ops import ps_ops  # noqa: F401
from paddle_tpu_torch.ops import collective  # noqa: F401


def kernel_launches() -> dict:
    """Every hand kernel's launch count so far, by the name of its
    wrapper's counter, beside the bf16 flash kernels' input copies
    (``*_copies``), fc_epilogue's launches on its wgmma path and
    conv_int8's on its wgmma routes (the packed stem's too).  The
    wrappers count on the host, so a CUDA graph's replay adds nothing
    here: ``CompiledProgram`` records these counts' deltas across each
    capture."""
    fa = flash_attention
    return {"flash_attention_fwd": fa.flash_attention_fwd.launches,
            "flash_attention_bwd_dq": fa.flash_attention_bwd.launches["dq"],
            "flash_attention_bwd_dkv":
                fa.flash_attention_bwd.launches["dkv"],
            "fc_epilogue": epilogue.fc_epilogue.launches,
            "conv_epilogue": conv_epilogue.conv_epilogue_kernel.launches,
            "conv_stats": conv_epilogue.conv_stats_kernel.launches,
            "bn_apply": conv_epilogue.bn_apply_kernel.launches,
            "flash_decode": flash_decode.flash_decode.launches,
            "conv_int8": quant.conv_int8.launches,
            "quantize_act": quant.quantize_act.launches,
            "flash_attention_fwd_copies": fa.flash_attention_fwd.copies,
            "flash_attention_bwd_copies": fa.flash_attention_bwd.copies,
            "fc_epilogue_wgmma": epilogue.fc_epilogue.launches_by_path[
                "wgmma"],
            "conv_int8_wgmma": quant.conv_int8.launches_by_route["wgmma"]
            + quant.conv_int8.launches_by_route["wgmma_stem"]}


def reset_kernel_launches():
    """Every count of ``kernel_launches`` (and the by-path and by-route
    ones behind it) set to 0."""
    fa, ep, cep = flash_attention, epilogue, conv_epilogue
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_fwd.copies = 0
    fa.flash_attention_bwd.launches = {"dq": 0, "dkv": 0}
    fa.flash_attention_bwd.copies = 0
    ep.fc_epilogue.launches = 0
    ep.fc_epilogue.launches_by_path = dict.fromkeys(ep.FC_PATHS, 0)
    cep.conv_epilogue_kernel.launches = 0
    cep.conv_stats_kernel.launches = 0
    cep.bn_apply_kernel.launches = 0
    flash_decode.flash_decode.launches = 0
    quant.conv_int8.launches = 0
    quant.conv_int8.launches_by_route = dict.fromkeys(
        quant.conv_int8.launches_by_route, 0)
    quant.quantize_act.launches = 0
