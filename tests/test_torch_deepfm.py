"""The port's DeepFM (``models/deepfm.py``) against the JAX package's.

A small DeepFM of the bench's configuration (``bench.py:557-585``): 26
fields, vocab 1000, embed 16, dense 13, hidden (32, 32), batch 16 of
``deepfm_inputs_synthetic``, Adam(1e-3) in f32 as the bench trains it,
and under the AMP decoration beside it; each with ``is_sparse`` False
(the bench's) and True.  The JAX package densifies a sparse grad before
the optimizer (``paddle_tpu/ops/optim.py:24-27``), so the port's dense
grads must equal its under both values.  The port's run starts from the
JAX startup program's values, carried over by name.

- Programs: ``to_dict`` equal, main and startup.
- f32: step 1's loss within 1e-5 relative and every grad within 1e-4 of
  its largest magnitude (f32 sums in other orders); every parameter
  after step 2 within ``2*lr`` a step plus 1e-4 (Adam's step is about
  ``lr*sign(m1)``, which a grad near 0 may flip), the moments within
  1e-4.
- AMP: the fc products and their relus run in bf16: the loss within
  1e-3, grads within 3e-2 of their scale, parameters within ``2*lr`` a
  step plus 1e-3 (as ``test_torch_amp.py``).
- ``CompiledProgram`` (the plan run eagerly on the CPU) gives the
  interpreter's bits.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.contrib.mixed_precision import decorate as jax_decorate
from paddle_tpu.models.deepfm import deepfm_inputs_synthetic as jax_inputs
from paddle_tpu.models.deepfm import deepfm_model as jax_deepfm
from torch_port_helpers import (assert_compiled_equals_interpreted,
                                assert_same_two_steps, fresh_port_programs,
                                jax_two_steps, port_two_steps)

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib.mixed_precision import decorate as pt_decorate
from paddle_tpu_torch.models.deepfm import deepfm_inputs_synthetic
from paddle_tpu_torch.models.deepfm import deepfm_model as port_deepfm

SMALL = dict(vocab_size=1000, hidden=(32, 32))
BATCH = 16
LR = 1e-3
TOL = {False: dict(loss_rtol=1e-5, grad_tol=1e-4,
                   param_atol=2 * 2 * LR + 1e-4, moment_tol=1e-4),
       True: dict(loss_rtol=1e-3, grad_tol=3e-2,
                  param_atol=2 * 2 * LR + 1e-3, moment_tol=3e-2)}
CONFIGS = [(sparse, amp) for amp in (False, True)
           for sparse in (False, True)]


def _minimize(optimizer, decorate, loss, amp):
    opt = optimizer.Adam(LR)
    if amp:
        opt = decorate(opt, init_loss_scaling=1.0,
                       use_dynamic_loss_scaling=False)
    opt.minimize(loss)


def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _feed():
    feed = deepfm_inputs_synthetic(BATCH, vocab_size=SMALL["vocab_size"])
    want = jax_inputs(BATCH, vocab_size=SMALL["vocab_size"])
    assert all(np.array_equal(feed[k], want[k]) for k in want)
    return feed


@pytest.fixture(scope="module", params=CONFIGS,
                ids=[f"sparse_{s}-{'amp' if a else 'f32'}"
                     for s, a in CONFIGS])
def jax_run(request):
    from conftest import _reset_program_state

    _reset_program_state()
    sparse, amp = request.param
    model = jax_deepfm(**SMALL, is_sparse=sparse)
    _minimize(jax_optimizer, jax_decorate, model["loss"], amp)
    main, startup = fluid.default_main_program(), \
        fluid.default_startup_program()
    start, step1, end = jax_two_steps(main, startup, model["loss"].name,
                                      _feed())
    return dict(sparse=sparse, amp=amp, main=_canon(main),
                startup=_canon(startup), start=start, want=(step1, end))


def _port_program(run):
    model = port_deepfm(**SMALL, is_sparse=run["sparse"])
    _minimize(pt.optimizer, pt_decorate, model["loss"], run["amp"])
    return model, pt.default_main_program(), pt.default_startup_program()


def test_port_appends_the_jax_deepfm_program(jax_run):
    with fresh_port_programs():
        _, main, startup = _port_program(jax_run)
        assert _canon(main) == jax_run["main"]
        assert _canon(startup) == jax_run["startup"]
        types = [op.type for op in main.global_block().ops]
    for t in ("concat_grad", "elementwise_sub_grad", "square_grad",
              "sigmoid", "sigmoid_cross_entropy_with_logits_grad",
              "reduce_sum_grad"):
        assert t in types
    lookups = [op for op in main.global_block().ops
               if op.type == "lookup_table"]
    assert [op.attrs["is_sparse"] for op in lookups] == \
        [jax_run["sparse"]] * 2


def test_port_trains_deepfm_as_jax(jax_run):
    with fresh_port_programs():
        model, main, _ = _port_program(jax_run)
        got = port_two_steps(main, model["loss"].name, _feed(),
                             jax_run["start"])
    assert_same_two_steps(got, jax_run["want"], **TOL[jax_run["amp"]])


def test_compiled_deepfm_step_equals_interpreted(jax_run):
    with fresh_port_programs():
        model, main, _ = _port_program(jax_run)
        assert_compiled_equals_interpreted(main, model["loss"].name,
                                           _feed(), jax_run["start"])
