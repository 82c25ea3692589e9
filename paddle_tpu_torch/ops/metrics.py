"""Metric ops (counterpart of ``paddle_tpu/ops/metrics.py``)."""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


@register_op("accuracy", inputs=("Out", "Indices", "Label"),
             outputs=("Accuracy", "Correct", "Total"),
             differentiable=False)
def accuracy(ins, attrs, device):
    """Indices: [N, k] top-k predictions; Label: [N, 1].  Accuracy is
    f32; Correct and Total are int64, the IR dtype of their vars."""
    idx, label = ins["Indices"], ins["Label"]
    correct = torch.any(idx == label.reshape(-1, 1), dim=1)
    num_correct = torch.sum(correct.to(torch.float32))
    return {"Accuracy": num_correct / idx.shape[0],
            "Correct": num_correct.to(torch.int64),
            "Total": torch.full((), idx.shape[0], dtype=torch.int64,
                                device=idx.device)}
