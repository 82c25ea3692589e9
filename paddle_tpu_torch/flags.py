"""Typed flags.

Counterpart of ``paddle_tpu/flags.py`` (``:19-57``): one registry of
typed flags, each read from the environment variable
``PADDLE_TPU_<NAME>`` when the module is imported, changed at run time
with ``set_flags``.  Flags are process-global.

Only the flags that the ported slices read are defined here, and
``benchmark``, which no code of either package reads; the others come
with the slices that read them.
"""

from __future__ import annotations

import os
from typing import Any

_REGISTRY: dict = {}


class _Flag:
    __slots__ = ("name", "type", "value", "help")

    def __init__(self, name, type_, default, help_):
        self.name = name
        self.type = type_
        self.value = default
        self.help = help_


def _coerce(type_, raw: str):
    if type_ is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return type_(raw)


def define_flag(name: str, default: Any, help_: str = ""):
    type_ = type(default)
    env = os.environ.get(f"PADDLE_TPU_{name.upper()}")
    value = _coerce(type_, env) if env is not None else default
    _REGISTRY[name] = _Flag(name, type_, value, help_)


def get_flag(name: str):
    return _REGISTRY[name].value


def set_flags(flags: dict):
    for name, value in flags.items():
        f = _REGISTRY.get(name)
        if f is None:
            raise KeyError(f"unknown flag '{name}'")
        if not isinstance(value, f.type):
            value = _coerce(f.type, str(value))
        f.value = value


def all_flags():
    return {name: f.value for name, f in _REGISTRY.items()}


# the executor's debug flags (reference counterparts noted)
define_flag("check_nan_inf", False,
            "sweep op outputs for NaN/Inf after each interpreted op "
            "(reference FLAGS_check_nan_inf, operator.cc:953)")
define_flag("benchmark", False,
            "block after each op to localize async failures "
            "(reference FLAGS_benchmark, operator.cc:949)")
define_flag("profile_ops", False,
            "record a host span per interpreted op "
            "(reference platform/profiler RecordEvent around op Run)")
define_flag("maxpool_grad_algo", "sas",
            "max-pool backward: 'sas' routes each output's gradient to the "
            "first maximum of its window, as XLA's select_and_scatter "
            "does; 'compare' (route to every tied maximum) is not ported "
            "and raises")
define_flag("conv_epilogue", "off",
            "NHWC conv2d and the conv2d_epilogue op (ops/conv_epilogue.py): "
            "'off' runs every NHWC conv2d as the plain convolution; any "
            "other value sends it to conv2d_epilogue, where 'xla' is the "
            "unfused chain, 'interpret' the kernel's plain PyTorch "
            "version, 'pallas' the CUDA kernel (a CPU tensor raises) and "
            "'on' the CUDA kernel on a CUDA tensor and the chain on a CPU "
            "one")
define_flag("conv_bn_stats", "off",
            "the conv2d_bn_train op (ops/conv_epilogue.py), which "
            "transpiler.fuse_conv_bn_train emits: 'off' and 'xla' run the "
            "unfused conv -> batch-norm -> residual -> relu composite, "
            "'interpret' the plain versions of the two kernels (conv with "
            "Σy/Σy² partials, then normalize + residual + act), 'pallas' "
            "the CUDA kernels (a CPU tensor raises), 'on' the CUDA "
            "kernels on a CUDA tensor and the composite on a CPU one")
define_flag("fc_epilogue", "off",
            "the fc_epilogue op (ops/epilogue.py), which "
            "transpiler.fuse_epilogue emits for mul + bias + residual + "
            "act chains: 'off' and 'xla' run the unfused chain, "
            "'interpret' the kernel's plain PyTorch version, 'pallas' "
            "the CUDA kernel (a CPU tensor raises), 'on' the CUDA kernel "
            "on a CUDA tensor and the chain on a CPU one")
define_flag("flash_packed_stats", "off",
            "the JAX package's row-statistics layout of its flash kernels "
            "(packed [B*H, T/128, 128] log-sum-exp when 'on'), a Mosaic "
            "layout.  Accepted here for parity only: the port's kernels "
            "(csrc/flash_attention_*.cu) keep lse as [B*H, T] f32 whichever "
            "value it holds")
define_flag("flash_head_pack", "off",
            "the JAX package's packing of two d<=64 heads into one grid "
            "step of its flash kernels when 'on', a Mosaic schedule.  "
            "Accepted here for parity only: no code of the port reads it")
define_flag("int8_interlayer", False,
            "int8 activations across layer boundaries "
            "(contrib.slim.quantization.convert_to_int8_execution with "
            "int8_activations=None reads it): False = each int8 op emits "
            "out_dtype and the next one quantises again (default); True = "
            "every quantized-op -> quantized-op edge folds the producer's "
            "dequant, the folded-BN bias add, a residual add and the relu "
            "and the consumer's quantisation into the producer's epilogue, "
            "so the tensor between the layers is int8")
define_flag("int8_conv_algo", "conv",
            "the s8 convolution of conv2d_int8: 'conv' (default) or "
            "'im2col'; in the JAX package two lowerings with the same "
            "bits.  Accepted here for parity only: no code of the port "
            "reads it, and conv2d_int8 runs the s8 kernel "
            "(csrc/conv_int8.cu) on a CUDA tensor and its plain version "
            "on a CPU one whichever value it holds")
define_flag("tracing", False,
            "request-scoped structured tracing (observability/tracing.py): "
            "False = off (default; every span site reduces to one "
            "module-global None check); True = spans with trace-id/span-id "
            "propagation are recorded into a bounded ring, and decode "
            "sequences span submit -> join -> step -> retire")
define_flag("paged_decode", False,
            "LLM decode KV-cache strategy of decode.py beam_search / "
            "greedy_search: False = the dense full-max_len loop (default), "
            "True = the host-stepped paged loop with an early "
            "all-finished exit, so the step fn may carry a paged KV-cache "
            "(ops/paged_kv.PagedKVCache) and attend via flash_decode")
define_flag("kv_int8", False,
            "paged KV-cache storage dtype: False = the model dtype "
            "(f32/bf16; default), True = int8 pages with per-channel "
            "(head, dim) scales (q = clip(round(x/s*127)), dequantized "
            "as x_hat = q*s/127): 2-4x less memory per cached token and "
            "2-4x less decode-step K/V traffic")
define_flag("prefill_chunk", 0,
            "chunked prefill for the continuous-decode engine: 0 = "
            "whole-prompt prefill (default), N > 0 = prompts longer than "
            "N tokens prefill in fixed N-token chunks interleaved with "
            "decode iterations (one chunk per iteration, the chunk "
            "always padded to exactly N), so a long join does not "
            "stretch the running streams' inter-token time.  Chunked "
            "output is token-identical to whole-prompt prefill")
define_flag("kv_share", False,
            "copy-on-write prefix sharing in the paged KV-cache: False = "
            "every sequence owns its pages (default), True = per-page "
            "refcounts plus a radix tree over full pages, so beams "
            "(PagedKVCache.fork) and requests with a common token prefix "
            "share physical pages; an append into a shared page copies "
            "it first.  The zero-leak invariant becomes free + "
            "unique(in_use) == num_pages")
define_flag("spec_k", 0,
            "lossless speculative decoding for the continuous-decode "
            "engine: 0 = one token per decode iteration (default), k > 0 "
            "= a small draft model proposes k tokens per iteration, one "
            "batched q-len-(k+1) flash_decode verify step scores them, "
            "greedy acceptance takes the longest agreeing prefix "
            "(decode.spec_accept_length), and rejection is a page-pointer "
            "rewind through PagedKVCache.truncate, so speculative greedy "
            "output is token-for-token identical to plain greedy")
define_flag("disagg_prefill", False,
            "disaggregated prefill/decode serving tiers (a prefill pool "
            "handing page lists to the decode pool).  False = the "
            "single-tier continuous-decode engine (default); True is "
            "not ported yet and raises NotImplementedError in "
            "serving.DecodeConfig")
define_flag("ir_verify", "off",
            "IR verifier level: 'off' = default (no check); 'on' = the "
            "structural Program/Block/Op verifier "
            "(analysis.verify: def-before-use, registered op types with "
            "their attr schemas, slot validity, dangling/duplicate vars, "
            "grad-op pairing) runs where the port calls it, raising typed "
            "VerifierError diagnostics that name block/op-index/var: the "
            "model registry at registration and at prewarm; 'full' = 'on' "
            "(the static shape check and the checks around every "
            "transpiler pass are not ported yet, ROADMAP Queue 1 item 6)")
define_flag("gspmd", False,
            "the sharding front-end (parallel/gspmd.py, "
            "transpiler/sharding_transpiler.py): False = the data-parallel "
            "and ZeRO 1-2 paths as they are (default; shard_program() "
            "returns the CompiledProgram untouched and the step is bitwise "
            "the same as never calling it); True = shard_program(plan) "
            "writes PartitionSpec annotations on the Program IR (ZeRO-3 "
            "over the data axis, the Megatron column/row splits over tp, "
            "the flash ops tagged) and CompiledProgram runs them: each "
            "rank holds its block of every annotated var, and the plan "
            "(core/sharding.py) puts the collectives at the layout "
            "boundaries, with flash attention on each rank's heads")
define_flag("serving_sharded", False,
            "tensor-parallel inference replicas: False = a Predictor is "
            "one whole model on one device (default; Predictor.shard() is "
            "a no-op returning None); True = Predictor.shard(plan) "
            "annotates the inference program's fc weights column-parallel "
            "over the plan's tp axis (parallel/gspmd.annotate_tp_inference) "
            "and each rank keeps its column block of each annotated weight "
            "and bias; the activation is all-gathered after each split "
            "layer, every contraction stays full-width, and every rank "
            "returns the whole output")
