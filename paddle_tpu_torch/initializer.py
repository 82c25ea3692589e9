"""Initializers, appended as startup-program ops.

Counterpart of ``paddle_tpu/initializer.py``: the same op types and
attrs, so a startup program built by either package draws the same
numbers from numpy's generator (``ops/basic.py`` ``uniform_random``).
"""

from __future__ import annotations

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self.value)})


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": float(self.low), "max": float(self.high),
                   "seed": self.seed})


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class Xavier(Initializer):
    """Uniform Xavier/Glorot: U(-sqrt(6/(fan_in+fan_out)), +...)."""

    def __init__(self, fan_in=None, fan_out=None, seed=0):
        self.fan_in, self.fan_out = fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        limit = float(np.sqrt(6.0 / (fi + fo)))
        Uniform(-limit, limit, self.seed)(var, block)



class MSRA(Initializer):
    """Kaiming initialisation, uniform: U(-sqrt(6/fan_in), +...).  The
    normal form (``uniform=False``) draws from ``gaussian_random``, which
    is not ported yet, and raises."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        if not uniform:
            raise NotImplementedError(
                "MSRA(uniform=False) is not ported yet")
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        limit = float(np.sqrt(6.0 / fi))
        Uniform(-limit, limit, self.seed)(var, block)
