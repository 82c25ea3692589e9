"""Control-flow ops of the port.

Counterpart of ``paddle_tpu/ops/control_flow.py``; only ``gather_tree``
(``:329``), which ``decode.beam_search`` finalizes with, is ported so
far.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


@register_op("gather_tree", inputs=("Ids", "Parents"), outputs=("Out",),
             differentiable=False)
def gather_tree(ins, attrs, device=None):
    """Beam-search finalization: walk the parent pointers backwards from
    the last step to emit full sequences.  Ids and Parents are [T, B, K];
    Out[t, b, k] is the token at step t of the beam that ends in slot k
    (a reverse loop over T, as the JAX package's reverse scan)."""
    ids, parents = ins["Ids"], ins["Parents"]
    t_steps, k = ids.shape[0], ids.shape[2]
    parent = torch.arange(k, dtype=parents.dtype,
                          device=parents.device).expand(ids.shape[1:])
    outs = [None] * t_steps
    for t in range(t_steps - 1, -1, -1):
        outs[t] = torch.gather(ids[t], -1, parent.long())
        parent = torch.gather(parents[t], -1, parent.long())
    if not outs:
        return {"Out": ids.clone()}
    return {"Out": torch.stack(outs)}
