"""AMP support ops: grad unscale with a finiteness check, dynamic loss
scaling.

Counterpart of ``paddle_tpu/ops/amp.py``: the same slots, attrs and
``in_place`` maps.  Both ops run on the card with no host round trip: an
overflow zeroes the unscaled grads (``zero_on_inf``) instead of skipping
the update on the host.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


@register_op("check_finite_and_unscale",
             inputs=("X", "Scale"), outputs=("Out", "FoundInfinite"),
             duplicable=("X", "Out"), differentiable=False,
             attrs={"zero_on_inf": True})
def check_finite_and_unscale(ins, attrs, device):
    """Divides every grad by Scale in f32 and casts back to its dtype;
    FoundInfinite [1] is whether any element of any grad is not finite.
    With ``zero_on_inf`` an overflow zeroes every unscaled grad."""
    scale = ins["Scale"].reshape(()).float()
    xs = ins["X"]
    found = torch.zeros((), dtype=torch.bool, device=scale.device)
    for x in xs:
        found = found | ~torch.isfinite(x).all()
    outs = []
    for x in xs:
        y = (x.float() / scale).to(x.dtype)
        if attrs["zero_on_inf"]:
            y = torch.where(found, torch.zeros_like(y), y)
        outs.append(y)
    return {"Out": outs, "FoundInfinite": found.reshape((1,))}


@register_op("update_loss_scaling",
             inputs=("FoundInfinite", "PrevLossScaling", "InGoodSteps",
                     "InBadSteps"),
             outputs=("LossScaling", "OutGoodSteps", "OutBadSteps"),
             differentiable=False,
             in_place={"LossScaling": "PrevLossScaling",
                       "OutGoodSteps": "InGoodSteps",
                       "OutBadSteps": "InBadSteps"},
             attrs={"incr_every_n_steps": 1000,
                    "decr_every_n_nan_or_inf": 2,
                    "incr_ratio": 2.0, "decr_ratio": 0.8})
def update_loss_scaling(ins, attrs, device):
    """Grows the scale by ``incr_ratio`` after ``incr_every_n_steps``
    clean steps in a row, shrinks it by ``decr_ratio`` (not below 1)
    after ``decr_every_n_nan_or_inf`` overflowing ones."""
    found = ins["FoundInfinite"].reshape(()).bool()
    scale = ins["PrevLossScaling"].reshape(()).float()
    good = ins["InGoodSteps"].reshape(()).int()
    bad = ins["InBadSteps"].reshape(()).int()

    zero = torch.zeros_like(good)
    good = torch.where(found, zero, good + 1)
    bad = torch.where(found, bad + 1, zero)

    grow = good >= attrs["incr_every_n_steps"]
    shrink = bad >= attrs["decr_every_n_nan_or_inf"]
    scale = torch.where(grow, scale * attrs["incr_ratio"], scale)
    scale = torch.where(shrink, torch.clamp_min(scale * attrs["decr_ratio"],
                                                1.0), scale)
    good = torch.where(grow, zero, good)
    bad = torch.where(shrink, zero, bad)
    return {"LossScaling": scale.reshape((1,)),
            "OutGoodSteps": good.reshape((1,)),
            "OutBadSteps": bad.reshape((1,))}
