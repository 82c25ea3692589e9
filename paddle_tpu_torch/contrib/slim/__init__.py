"""slim: model compression (counterpart of ``paddle_tpu/contrib/slim/``).

Only the post-training int8 path of ``quantization`` is ported; the QAT
passes (``QuantizationTransformPass``, ``QuantizationFreezePass``,
``quant_aware``), pruning, distillation and NAS are not yet (ROADMAP
Queue 1 item 6).
"""

from paddle_tpu_torch.contrib.slim.quantization import (  # noqa: F401
    convert_to_int8_execution, convert_to_int8_inference,
    post_training_quantize, quantize_weights_abs_max)

__all__ = ["post_training_quantize", "quantize_weights_abs_max",
           "convert_to_int8_execution", "convert_to_int8_inference"]
