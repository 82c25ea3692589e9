"""Convolution, pooling and normalisation ops.

Counterpart of ``paddle_tpu/ops/nn.py``: the same op types, slots, attrs
and ``data_format``/``data_layout`` handling.  Filters are OIHW in both
layouts.  NHWC tensors reach PyTorch's convolution and pooling as
permuted views (NCHW shape, channels-last memory), so no copy is made to
change the layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import REQUIRED, register_op


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v, v)


def conv_nd(x, w, strides, paddings, dilations=(1, 1), groups=1,
            fmt="NCHW"):
    """The plain convolution of ``x`` (``fmt``) with OIHW ``w``, padding
    symmetric ``paddings``; the output keeps x's dtype and layout."""
    if fmt == "NHWC":
        x = x.permute(0, 3, 1, 2)
    out = F.conv2d(x, w, stride=strides, padding=paddings,
                   dilation=dilations, groups=groups)
    return out.permute(0, 2, 3, 1) if fmt == "NHWC" else out


@register_op("conv2d", inputs=("Input", "Filter"), outputs=("Output",),
             attrs={"strides": [1, 1], "paddings": [0, 0],
                    "dilations": [1, 1], "groups": 1,
                    "data_format": "NCHW", "use_cudnn": True})
def conv2d(ins, attrs, device):
    """With the ``conv_epilogue`` flag on, an NHWC group-1 undilated conv
    goes through ``conv2d_epilogue`` with no stages, so the flag moves
    every conv of a step (``paddle_tpu/ops/nn.py:49-63``)."""
    x, w = ins["Input"], ins["Filter"]
    s, p, d = (_pair(attrs[k]) for k in ("strides", "paddings",
                                         "dilations"))
    fmt = attrs.get("data_format", "NCHW")
    if fmt == "NHWC" and attrs["groups"] == 1 and d == (1, 1) \
            and x.ndim == 4:
        from paddle_tpu_torch.flags import get_flag

        if get_flag("conv_epilogue") != "off":
            from paddle_tpu_torch.ops.conv_epilogue import (
                conv2d_epilogue, flag_impl)

            return {"Output": conv2d_epilogue(
                x, w, strides=s, paddings=p,
                impl=flag_impl("conv_epilogue"))}
    return {"Output": conv_nd(x, w, s, p, d, attrs["groups"], fmt)}


def _maxpool_cmp_bwd(window, strides, pads, x, out, dy):
    """The compare-and-route max-pool backward of the JAX package
    (``paddle_tpu/ops/nn.py:122-148``) over the last two dims of NCHW
    ``x``, ``out`` and ``dy``: dx[i] is the sum, over the window offsets
    o, of dy[w] where x[i] == out[w], w the window whose offset-o element
    is i.  A tie routes the gradient to every maximum (autograd of
    ``max_pool2d`` routes it once).  The offsets run in the JAX loop's
    order and sum in f32, then cast to dy's dtype, as there."""
    oh, ow = out.shape[-2:]
    up = ((oh - 1) * strides[0] + 1, (ow - 1) * strides[1] + 1)
    lead = tuple(out.shape[:-2])
    out_up = torch.full(lead + up, float("-inf"), dtype=out.dtype,
                        device=out.device)
    out_up[..., ::strides[0], ::strides[1]] = out
    dy_up = torch.zeros(lead + up, dtype=dy.dtype, device=dy.device)
    dy_up[..., ::strides[0], ::strides[1]] = dy
    base = tuple(k - 1 + s for k, s in zip(window, strides))
    flat = [base[1], base[1], base[0], base[0]]
    p_out = F.pad(out_up, flat, value=float("-inf"))
    p_dy = F.pad(dy_up, flat)
    h, w = x.shape[-2:]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
    for i in range(window[0]):
        for j in range(window[1]):
            r0 = base[0] + pads[0] - i
            c0 = base[1] + pads[1] - j
            hit = x == p_out[..., r0:r0 + h, c0:c0 + w]
            acc = acc + torch.where(hit, p_dy[..., r0:r0 + h, c0:c0 + w],
                                    zero).float()
    return acc.to(dy.dtype)


class _MaxPoolCompare(torch.autograd.Function):
    """Max pooling of NCHW ``x`` whose backward is ``_maxpool_cmp_bwd``
    (the JAX package's ``_maxpool_cmp`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, window, strides, pads):
        out = F.max_pool2d(x, window, strides, pads)
        ctx.save_for_backward(x, out)
        ctx.geometry = (window, strides, pads)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, out = ctx.saved_tensors
        return _maxpool_cmp_bwd(*ctx.geometry, x, out, dy), None, None, None


@register_op("pool2d", inputs=("X",), outputs=("Out",),
             attrs={"pooling_type": "max", "ksize": REQUIRED,
                    "global_pooling": False, "strides": [1, 1],
                    "paddings": [0, 0], "exclusive": True,
                    "adaptive": False, "ceil_mode": False,
                    "data_format": "NCHW"})
def pool2d(ins, attrs, device):
    """Max or average pooling; ``ceil_mode`` is read by neither package.
    The max's gradient (autograd of ``max_pool2d``) goes to the first
    maximum of each window in row-major window order, as XLA's
    select_and_scatter with ``ge`` routes it; under the flag
    ``maxpool_grad_algo="compare"`` to every maximum
    (``_MaxPoolCompare``)."""
    x = ins["X"]
    fmt = attrs.get("data_format", "NCHW")
    hw = (2, 3) if fmt == "NCHW" else (1, 2)
    if attrs["adaptive"]:
        oh, ow = _pair(attrs["ksize"])
        if fmt == "NCHW":
            n, c, h, wd = x.shape
            x6 = x.reshape(n, c, oh, h // oh, ow, wd // ow)
            red = (3, 5)
        else:
            n, h, wd, c = x.shape
            x6 = x.reshape(n, oh, h // oh, ow, wd // ow, c)
            red = (2, 4)
        if attrs["pooling_type"] == "max":
            return {"Out": torch.amax(x6, dim=red)}
        return {"Out": torch.mean(x6, dim=red)}
    if attrs["global_pooling"]:
        k = (x.shape[hw[0]], x.shape[hw[1]])
        s, p = k, (0, 0)
    else:
        k, s, p = (_pair(attrs[a]) for a in ("ksize", "strides",
                                             "paddings"))
    xn = x.permute(0, 3, 1, 2) if fmt == "NHWC" else x
    if attrs["pooling_type"] == "max":
        from paddle_tpu_torch.flags import get_flag

        if get_flag("maxpool_grad_algo") == "compare":
            out = _MaxPoolCompare.apply(xn, k, s, p)
        else:
            out = F.max_pool2d(xn, k, s, p)
    else:
        # exclusive: divide by the window's elements inside the input
        # (the JAX package's count of ones), else by the window's area
        out = F.avg_pool2d(xn, k, s, p,
                           count_include_pad=not attrs["exclusive"])
    return {"Out": out.permute(0, 2, 3, 1) if fmt == "NHWC" else out}


def _moments_1pass(xf, axes):
    """Batch mean and variance over ``axes``, term for term the JAX
    package's helper (``paddle_tpu/ops/nn.py:229-291``): shifted one-pass
    moments around a probe mean (up to 8 elements of the first reduced
    axis), then the exact two-pass variance for the channels where
    ``var <= 8 eps E[y^2]``, clamped at 0.

    The JAX package computes the two-pass variance under ``lax.cond``
    only when some channel needs it.  Here it is always computed and
    selected with ``where``: the result is the same, and no host sync
    decides the branch."""
    m = float(np.prod([xf.shape[a] for a in axes]))
    a0 = axes[0]
    k = min(8, xf.shape[a0])
    probe_idx = tuple(slice(0, k) if a == a0
                      else (slice(0, 1) if a in axes else slice(None))
                      for a in range(xf.ndim))
    # mean/var are shift-invariant: the shift carries no gradient
    shift = torch.mean(xf[probe_idx], dim=axes).detach()
    shape = [1] * xf.ndim
    for a in range(xf.ndim):
        if a not in axes:
            shape[a] = xf.shape[a]
    y = xf - shift.reshape(shape)
    s1 = torch.sum(y, dim=axes)
    s2 = torch.sum(y * y, dim=axes)
    mean_y = s1 / m
    mean = shift + mean_y
    e2 = s2 / m
    var = e2 - mean_y * mean_y
    eps = torch.finfo(xf.dtype if xf.is_floating_point()
                      else torch.float32).eps
    need = var <= 8.0 * eps * e2
    d = xf - mean.detach().reshape(shape)
    var2 = torch.sum(d * d, dim=axes) / m
    var = torch.where(need, var2, var)
    return mean, torch.maximum(var, torch.zeros_like(var))


def _bn_axes(x, layout):
    if x.ndim == 4 and layout == "NCHW":
        return (0, 2, 3)
    if layout == "NHWC":
        return tuple(i for i in range(x.ndim) if i != x.ndim - 1)
    return (0,) + tuple(range(2, x.ndim))


def _bn_shape(x, layout):
    shape = [1] * x.ndim
    c_axis = 1 if layout == "NCHW" else x.ndim - 1
    shape[c_axis] = x.shape[c_axis]
    return shape


@register_op("batch_norm",
             inputs=("X", "Scale", "Bias", "Mean", "Variance",
                     "BatchMean", "BatchVariance"),
             outputs=("Y", "MeanOut", "VarianceOut", "SavedMean",
                      "SavedVariance"),
             optional=("BatchMean", "BatchVariance"),
             attrs={"epsilon": 1e-5, "momentum": 0.9, "is_test": False,
                    "data_layout": "NCHW", "use_global_stats": False})
def batch_norm(ins, attrs, device):
    """Statistics in the running stats' dtype (f32), Y in X's dtype.
    MeanOut/VarianceOut are the updated running stats, which the layer
    wires back onto the same vars; SavedVariance is 1/sqrt(var + eps).
    BatchMean/BatchVariance, when given, replace the batch statistics in
    train mode."""
    x = ins["X"]
    scale, bias = ins["Scale"], ins["Bias"]
    mean, var = ins["Mean"], ins["Variance"]
    eps, mom = attrs["epsilon"], attrs["momentum"]
    layout = attrs["data_layout"]
    axes = _bn_axes(x, layout)
    xf = x.to(mean.dtype)
    if attrs["is_test"] or attrs["use_global_stats"]:
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
        saved_mean = torch.zeros_like(mean)
        saved_var = torch.zeros_like(var)
    else:
        if "BatchMean" in ins and "BatchVariance" in ins:
            use_mean = ins["BatchMean"].to(mean.dtype)
            use_var = ins["BatchVariance"].to(var.dtype)
        else:
            use_mean, use_var = _moments_1pass(xf, axes)
        mean_out = mean * mom + use_mean.detach() * (1 - mom)
        var_out = var * mom + use_var.detach() * (1 - mom)
        saved_mean = use_mean
        saved_var = 1.0 / torch.sqrt(use_var + eps)
    shape = _bn_shape(x, layout)
    y = (xf - use_mean.reshape(shape)) * torch.rsqrt(
        use_var.reshape(shape) + eps) * scale.reshape(shape) \
        + bias.reshape(shape)
    return {"Y": y.to(x.dtype), "MeanOut": mean_out,
            "VarianceOut": var_out, "SavedMean": saved_mean,
            "SavedVariance": saved_var}


@register_op("batch_norm_grad",
             inputs=("X", "Scale", "Bias", "Mean", "Variance",
                     "BatchMean", "BatchVariance", "Y@GRAD",
                     "MeanOut@GRAD", "VarianceOut@GRAD", "SavedMean@GRAD",
                     "SavedVariance@GRAD"),
             outputs=("X@GRAD", "Scale@GRAD", "Bias@GRAD"),
             optional=("Bias", "Mean", "Variance", "BatchMean",
                       "BatchVariance", "MeanOut@GRAD",
                       "VarianceOut@GRAD", "SavedMean@GRAD",
                       "SavedVariance@GRAD"),
             attrs={"epsilon": 1e-5, "momentum": 0.9, "is_test": False,
                    "data_layout": "NCHW", "use_global_stats": False},
             differentiable=False)
def batch_norm_grad(ins, attrs, device):
    """The hand-written BN backward (``paddle_tpu/ops/nn.py:351-417``),
    registered in place of a synthesised grad:

      dbias  = sum(dy)
      dscale = sum(dy * x_hat)
      dx     = scale*rstd * (dy - dbias/m - x_hat*dscale/m)    (train)
      dx     = scale*rstd * dy                                 (global stats)

    The batch statistics are recomputed from X (or taken from
    BatchMean/BatchVariance), in f32; dx comes out in X's dtype."""
    x, dy, scale = ins["X"], ins["Y@GRAD"], ins["Scale"]
    eps = attrs["epsilon"]
    layout = attrs["data_layout"]
    axes = _bn_axes(x, layout)
    shape = _bn_shape(x, layout)
    f32 = scale.dtype
    xf = x.to(f32)
    dyf = dy.to(f32)
    if attrs["is_test"] or attrs["use_global_stats"]:
        mean, var = ins["Mean"], ins["Variance"]
        rstd = torch.rsqrt(var + eps)
        x_hat = (xf - mean.reshape(shape)) * rstd.reshape(shape)
        dbias = torch.sum(dyf, dim=axes)
        dscale = torch.sum(dyf * x_hat, dim=axes)
        dx = (scale * rstd).reshape(shape) * dyf
        return {"X@GRAD": dx.to(x.dtype), "Scale@GRAD": dscale,
                "Bias@GRAD": dbias}
    m = float(np.prod([x.shape[a] for a in axes]))
    if "BatchMean" in ins and "BatchVariance" in ins:
        mean = ins["BatchMean"].to(f32)
        var = ins["BatchVariance"].to(f32)
    else:
        mean, var = _moments_1pass(xf, axes)
    rstd = torch.rsqrt(var + eps)
    x_hat = (xf - mean.reshape(shape)) * rstd.reshape(shape)
    dbias = torch.sum(dyf, dim=axes)
    dscale = torch.sum(dyf * x_hat, dim=axes)
    dx = (scale * rstd).reshape(shape) * (
        dyf - (dbias / m).reshape(shape)
        - x_hat * (dscale / m).reshape(shape))
    return {"X@GRAD": dx.to(x.dtype), "Scale@GRAD": dscale,
            "Bias@GRAD": dbias}


@register_op("layer_norm", inputs=("X", "Scale", "Bias"),
             outputs=("Y", "Mean", "Variance"),
             optional=("Scale", "Bias"),
             attrs={"epsilon": 1e-5, "begin_norm_axis": 1})
def layer_norm(ins, attrs, device):
    """Normalises over dims ``begin_norm_axis:`` with f32 statistics;
    Y keeps X's dtype, Mean/Variance are the f32 per-row stats."""
    x = ins["X"]
    a = attrs["begin_norm_axis"]
    axes = tuple(range(a, x.ndim))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.var(xf, dim=axes, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + attrs["epsilon"])
    norm_shape = tuple(x.shape[a:])
    if "Scale" in ins:
        y = y * ins["Scale"].reshape(norm_shape)
    if "Bias" in ins:
        y = y + ins["Bias"].reshape(norm_shape)
    return {"Y": y.to(x.dtype), "Mean": mean.reshape(x.shape[:a]),
            "Variance": var.reshape(x.shape[:a])}
