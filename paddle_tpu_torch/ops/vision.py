"""Vision ops.

Counterpart of ``paddle_tpu/ops/vision.py``, of which the port holds
``space_to_depth`` so far (the image stem of
``transpiler.space_to_depth_stem``).
"""

from __future__ import annotations

from paddle_tpu_torch.core.registry import REQUIRED, register_op


@register_op("space_to_depth", inputs=("X",), outputs=("Out",),
             attrs={"blocksize": REQUIRED})
def space_to_depth(ins, attrs, device):
    """[N, C, H, W] -> [N, C b^2, H/b, W/b] with output channel
    (i b + j) C + c holding x[n, c, h b + i, w b + j]: the JAX op's
    transpose (0, 3, 5, 1, 2, 4).  ``F.pixel_unshuffle`` orders the
    channels c b^2 + i b + j instead, so it is not this op."""
    x = ins["X"]
    b = int(attrs["blocksize"])
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return {"Out": out.reshape(n, c * b * b, h // b, w // b)}
