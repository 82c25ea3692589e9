"""Scope / Variable: hierarchical name -> value store for execution.

Counterpart of ``paddle_tpu/core/scope.py``.  Values held are torch
tensors on the executor's device (or ``SelectedRows`` of them).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


class SelectedRows:
    """Sparse rows (reference framework/selected_rows.h:32): row indices
    into a logically tall tensor plus the dense values of those rows."""

    def __init__(self, rows, values, height: int):
        self.rows = rows          # int tensor [n]
        self.values = values      # [n, ...] dense values
        self.height = height      # logical number of rows

    def to_dense(self):
        out_shape = (self.height,) + tuple(self.values.shape[1:])
        dense = torch.zeros(out_shape, dtype=self.values.dtype,
                            device=self.values.device)
        return dense.index_add(0, torch.as_tensor(self.rows).long().to(
            self.values.device), self.values)

    def __repr__(self):
        return (
            f"SelectedRows(height={self.height}, nrows="
            f"{None if self.rows is None else len(self.rows)})"
        )


class Variable:
    def __init__(self, name: str):
        self.name = name
        self.value = None

    def get(self):
        return self.value

    def set(self, v):
        self.value = v


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.vars: dict = {}

    def var(self, name: str) -> Variable:
        """Find-or-create in THIS scope."""
        v = self.vars.get(name)
        if v is None:
            v = Variable(name)
            self.vars[name] = v
        return v

    def find_var(self, name: str) -> Optional[Variable]:
        """Search this scope then its ancestors."""
        s = self
        while s is not None:
            v = s.vars.get(name)
            if v is not None:
                return v
            s = s.parent
        return None


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope):
    """Switch the global scope for the duration of the block."""
    global _global_scope
    old = _global_scope
    _global_scope = scope
    try:
        yield
    finally:
        _global_scope = old
