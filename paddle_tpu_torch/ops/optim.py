"""Optimizer update ops: value in, value out.

Counterpart of ``paddle_tpu/ops/optim.py`` (``sgd``, ``momentum``,
``adam``, ``fused_adam``): the same slots, attrs and ``in_place`` maps.
Each op returns new tensors; the executor stores ``ParamOut`` under the
parameter's own name, which replaces the old value (no update in place).
Updates run in the parameter's dtype, with the ``[1]`` learning rate and
beta-pow accumulators broadcast over it as in the JAX package.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import REQUIRED, register_op


def _lr(ins):
    return ins["LearningRate"].to(ins["Param"].dtype)


@register_op("sgd", inputs=("Param", "Grad", "LearningRate"),
             outputs=("ParamOut",), differentiable=False,
             in_place={"ParamOut": "Param"})
def sgd(ins, attrs, device):
    return {"ParamOut": ins["Param"] - _lr(ins) * ins["Grad"]}


@register_op("momentum",
             inputs=("Param", "Grad", "Velocity", "LearningRate"),
             outputs=("ParamOut", "VelocityOut"), differentiable=False,
             attrs={"mu": REQUIRED, "use_nesterov": False},
             in_place={"ParamOut": "Param", "VelocityOut": "Velocity"})
def momentum(ins, attrs, device):
    p, v, g = ins["Param"], ins["Velocity"], ins["Grad"]
    lr = _lr(ins)
    mu = attrs["mu"]
    v_out = mu * v + g
    if attrs["use_nesterov"]:
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("adam",
             inputs=("Param", "Grad", "Moment1", "Moment2", "Beta1Pow",
                     "Beta2Pow", "LearningRate"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out",
                      "Beta1PowOut", "Beta2PowOut"),
             differentiable=False,
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8,
                    "lazy_mode": False},
             in_place={"ParamOut": "Param", "Moment1Out": "Moment1",
                       "Moment2Out": "Moment2", "Beta1PowOut": "Beta1Pow",
                       "Beta2PowOut": "Beta2Pow"})
def adam(ins, attrs, device):
    """``lazy_mode`` is accepted and changes nothing: gradients are
    dense, as in the JAX package."""
    p, m1, m2 = ins["Param"], ins["Moment1"], ins["Moment2"]
    b1p, b2p, g = ins["Beta1Pow"], ins["Beta2Pow"], ins["Grad"]
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * torch.square(g)
    lr_t = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    p_out = p - lr_t * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out,
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2}


@register_op("fused_adam",
             inputs=("Param", "Grad", "Moment1", "Moment2", "Beta1Pow",
                     "Beta2Pow", "LearningRate"),
             outputs=("ParamOut", "Moment1Out", "Moment2Out",
                      "Beta1PowOut", "Beta2PowOut"),
             duplicable=("Param", "Grad", "Moment1", "Moment2",
                         "ParamOut", "Moment1Out", "Moment2Out"),
             differentiable=False,
             attrs={"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
             in_place={"ParamOut": "Param", "Moment1Out": "Moment1",
                       "Moment2Out": "Moment2", "Beta1PowOut": "Beta1Pow",
                       "Beta2PowOut": "Beta2Pow"})
def fused_adam(ins, attrs, device):
    """One Adam update over every (param, grad, m1, m2), as the JAX op
    computes it: per dtype group the tensors are flattened and
    concatenated, updated in one pass, and split back.  ``lr_t`` is
    computed in f32 and cast per group; the beta pows are shared, one
    step count for every parameter."""
    ps, gs = ins["Param"], ins["Grad"]
    m1s, m2s = ins["Moment1"], ins["Moment2"]
    b1p, b2p = ins["Beta1Pow"], ins["Beta2Pow"]
    b1, b2, eps = attrs["beta1"], attrs["beta2"], attrs["epsilon"]
    lr_t = ins["LearningRate"].float() * torch.sqrt(1 - b2p.float()) \
        / (1 - b1p.float())
    n = len(ps)
    p_out, m1_out, m2_out = [None] * n, [None] * n, [None] * n
    groups: dict = {}
    for i, p in enumerate(ps):
        groups.setdefault(p.dtype, []).append(i)
    for dt, idxs in groups.items():
        sizes = [ps[i].numel() for i in idxs]
        pc = torch.cat([ps[i].reshape(-1) for i in idxs])
        gc = torch.cat([gs[i].reshape(-1).to(dt) for i in idxs])
        m1c = torch.cat([m1s[i].reshape(-1) for i in idxs])
        m2c = torch.cat([m2s[i].reshape(-1) for i in idxs])
        m1n = b1 * m1c + (1 - b1) * gc
        m2n = b2 * m2c + (1 - b2) * torch.square(gc)
        pn = pc - lr_t.to(dt) * m1n / (torch.sqrt(m2n) + eps)
        for i, pi, m1i, m2i in zip(idxs, pn.split(sizes), m1n.split(sizes),
                                   m2n.split(sizes)):
            p_out[i] = pi.reshape(ps[i].shape)
            m1_out[i] = m1i.reshape(ps[i].shape)
            m2_out[i] = m2i.reshape(ps[i].shape)
    return {"ParamOut": p_out, "Moment1Out": m1_out,
            "Moment2Out": m2_out, "Beta1PowOut": b1p * b1,
            "Beta2PowOut": b2p * b2}
