"""The bench's tf_train and tf_train_fcep legs of the port against the JAX
package's.

``bench.py:307-432``: the LM in training mode, under AMP with static loss
scaling 1.0 and one ``adam`` op a parameter (``Adam(1e-4, fuse=False)``);
tf_train_fcep also fuses the fc chains (``fuse_epilogue(anchors=("fc",))``
before ``minimize``) and runs them under the flag ``fc_epilogue``.  At 2
layers, d 64, 4 heads, vocab 512 and seq 32, batch 2 (``TINY_LM`` at seq
32); the port's run starts from the JAX startup program's values, carried
over by name.

- Programs: main and startup ``to_dict`` equal to the JAX build, one
  ``adam`` op a parameter, no ``fused_adam``, and 0 or 3 ``fc_epilogue``
  ops a layer.
- Steps 1-2 against the JAX Executor (tf_train_fcep under the flag
  ``interpret`` in both packages: the kernel's function, the JAX side
  through its Pallas interpreter): the products and activations run in
  bf16, so the two part by a bf16 step (2^-8) at each rounding: the loss
  within 1e-3, grads within 3e-2 of their scale, parameters within
  ``2*lr`` a step plus 1e-3 and the moments within 3e-2 (as
  ``test_torch_amp.py`` and ``test_torch_bert.py``).
- ``CompiledProgram`` (the plan run eagerly on the CPU) gives the
  interpreter's bits.
"""

from __future__ import annotations

import contextlib
import json

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu.contrib.mixed_precision import decorate as jax_decorate
from paddle_tpu.flags import set_flags as jax_set_flags
from paddle_tpu.models.transformer import \
    transformer_encoder_model as jax_model
from paddle_tpu.transpiler import fuse_epilogue as jax_fuse_epilogue
from torch_port_helpers import (TINY_LM, assert_compiled_equals_interpreted,
                                assert_same_two_steps, fresh_port_programs,
                                jax_two_steps, port_two_steps)

import paddle_tpu_torch as pt
from paddle_tpu_torch.models.transformer import \
    transformer_encoder_model as port_model

LM = dict(TINY_LM, max_len=32, is_test=False)
LR = 1e-4
TOL = dict(loss_rtol=1e-3, grad_tol=3e-2, param_atol=2 * 2 * LR + 1e-3,
           moment_tol=3e-2)
LEGS = {"tf_train": False, "tf_train_fcep": True}


@contextlib.contextmanager
def fc_flag(mode):
    try:
        jax_set_flags({"fc_epilogue": mode})
        pt.set_flags({"fc_epilogue": mode})
        yield
    finally:
        jax_set_flags({"fc_epilogue": "off"})
        pt.set_flags({"fc_epilogue": "off"})


def _build(pkg, model_fn, fuse, decorate, fcep):
    """The bench's sequence in the default programs; returns the model."""
    model = model_fn(**LM)
    if fcep:
        fuse(pkg.default_main_program(), protected=[model["loss"].name],
             anchors=("fc",))
    opt = decorate(pkg.optimizer.Adam(LR, fuse=False),
                   init_loss_scaling=1.0, use_dynamic_loss_scaling=False)
    opt.minimize(model["loss"])
    return model


def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _feed():
    rng = np.random.RandomState(8)
    ids = rng.randint(0, LM["vocab_size"], (2, LM["max_len"], 1)) \
        .astype(np.int64)
    return {"src_ids": ids, "tgt_label": ids}


@pytest.fixture(scope="module", params=list(LEGS))
def jax_run(request):
    """The JAX-built leg and its two steps."""
    from conftest import _reset_program_state

    _reset_program_state()
    leg = request.param
    model = _build(fluid, jax_model, jax_fuse_epilogue, jax_decorate,
                   LEGS[leg])
    main, startup = fluid.default_main_program(), \
        fluid.default_startup_program()
    with fc_flag("interpret" if LEGS[leg] else "off"):
        start, step1, end = jax_two_steps(main, startup, model["loss"].name,
                                          _feed())
    return dict(leg=leg, main=_canon(main), startup=_canon(startup),
                loss=model["loss"].name, start=start, want=(step1, end))


def _port_program(leg):
    model = _build(pt, port_model, pt.transpiler.fuse_epilogue,
                   pt.contrib.mixed_precision.decorate, LEGS[leg])
    return model, pt.default_main_program(), pt.default_startup_program()


def test_port_builds_the_jax_leg_program(jax_run):
    with fresh_port_programs():
        _, main, startup = _port_program(jax_run["leg"])
        assert _canon(main) == jax_run["main"]
        assert _canon(startup) == jax_run["startup"]
        types = [op.type for op in main.global_block().ops]
        n_params = len(main.all_parameters())
    assert types.count("adam") == n_params and "fused_adam" not in types
    assert types.count("fc_epilogue") == \
        (3 * LM["n_layer"] if LEGS[jax_run["leg"]] else 0)
    assert types.count("flash_attention") == LM["n_layer"]
    assert types.count("cast") > 0          # AMP


def test_port_trains_the_leg_as_jax(jax_run):
    with fresh_port_programs():
        model, main, _ = _port_program(jax_run["leg"])
        with fc_flag("interpret" if LEGS[jax_run["leg"]] else "off"):
            got = port_two_steps(main, model["loss"].name, _feed(),
                                 jax_run["start"])
    assert_same_two_steps(got, jax_run["want"], **TOL)


def test_compiled_leg_step_equals_interpreted(jax_run):
    with fresh_port_programs():
        model, main, _ = _port_program(jax_run["leg"])
        with fc_flag("interpret" if LEGS[jax_run["leg"]] else "off"):
            assert_compiled_equals_interpreted(main, model["loss"].name,
                                               _feed(), jax_run["start"])
