"""The port's BERT (``models/bert.py``) against the JAX package's.

A tiny BERT of the bench's configuration (``bench.py:476-510``): 2
layers, d_model 32, 4 heads, d_inner 64, vocab 128, seq 16, dropout 0,
batch 2 of ``bert_inputs_synthetic``; Adam(1e-3), and the bench's AMP
configuration ``decorate(Adam, init_loss_scaling=1.0,
use_dynamic_loss_scaling=False)``.  The port's run starts from the JAX
startup program's values, carried over by name.

- Programs: the port's front-end appends the JAX package's forward,
  backward and optimizer ops (``to_dict`` equal, main and startup).
- f32: step 1's loss within 1e-5 relative and every grad within 1e-4 of
  its largest magnitude (f32 in other orders, erf and tanh of other
  libraries); every parameter after step 2 within ``2*lr`` a step plus
  1e-4 (Adam's step is about ``lr*sign(m1)``, which a grad near 0 may
  flip), the moments within 1e-4.
- AMP: the products and the activations between them run in bf16, so
  the two packages part by a bf16 step (2^-8) at each rounding: the loss
  within 1e-3, grads within 3e-2 of their scale, parameters within
  ``2*lr`` a step plus 1e-3 (as ``test_torch_amp.py``).
- ``CompiledProgram`` (the plan run eagerly on the CPU) gives the
  interpreter's bits in both configurations.
- Training dropout raises, as the LM's does.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import paddle_tpu as fluid
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.contrib.mixed_precision import decorate as jax_decorate
from paddle_tpu.models.bert import bert_inputs_synthetic as jax_inputs
from paddle_tpu.models.bert import bert_model as jax_bert
from torch_port_helpers import (assert_compiled_equals_interpreted,
                                assert_same_two_steps, fresh_port_programs,
                                jax_two_steps, port_two_steps)

import paddle_tpu_torch as pt
from paddle_tpu_torch.contrib.mixed_precision import decorate as pt_decorate
from paddle_tpu_torch.models.bert import bert_inputs_synthetic
from paddle_tpu_torch.models.bert import bert_model as port_bert

TINY_BERT = dict(vocab_size=128, max_len=16, d_model=32, n_head=4,
                 d_inner=64, n_layer=2, dropout_rate=0.0)
BATCH = 2
LR = 1e-3
TOL = {False: dict(loss_rtol=1e-5, grad_tol=1e-4,
                   param_atol=2 * 2 * LR + 1e-4, moment_tol=1e-4),
       True: dict(loss_rtol=1e-3, grad_tol=3e-2,
                  param_atol=2 * 2 * LR + 1e-3, moment_tol=3e-2)}


def _minimize(optimizer, decorate, loss, amp):
    opt = optimizer.Adam(LR)
    if amp:
        opt = decorate(opt, init_loss_scaling=1.0,
                       use_dynamic_loss_scaling=False)
    opt.minimize(loss)


def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _feed():
    feed = bert_inputs_synthetic(BATCH, TINY_BERT["max_len"],
                                 TINY_BERT["vocab_size"])
    want = jax_inputs(BATCH, TINY_BERT["max_len"], TINY_BERT["vocab_size"])
    assert all(np.array_equal(feed[k], want[k]) for k in want)
    return feed


@pytest.fixture(scope="module", params=[False, True], ids=["f32", "amp"])
def jax_run(request):
    """The JAX-built program and its run."""
    from conftest import _reset_program_state

    _reset_program_state()
    amp = request.param
    model = jax_bert(**TINY_BERT)
    _minimize(jax_optimizer, jax_decorate, model["loss"], amp)
    main, startup = fluid.default_main_program(), \
        fluid.default_startup_program()
    start, step1, end = jax_two_steps(main, startup, model["loss"].name,
                                      _feed())
    return dict(amp=amp, main=_canon(main), startup=_canon(startup),
                loss=model["loss"].name, start=start, want=(step1, end))


def _port_program(amp):
    model = port_bert(**TINY_BERT)
    _minimize(pt.optimizer, pt_decorate, model["loss"], amp)
    return model, pt.default_main_program(), pt.default_startup_program()


def test_port_appends_the_jax_bert_program(jax_run):
    with fresh_port_programs():
        model, main, startup = _port_program(jax_run["amp"])
        assert _canon(main) == jax_run["main"]
        assert _canon(startup) == jax_run["startup"]
        types = [op.type for op in main.global_block().ops]
    assert types.count("flash_attention") == TINY_BERT["n_layer"]
    for t in ("one_hot", "matmul_grad", "slice_grad", "tanh_grad",
              "elementwise_div_grad", "reduce_sum_grad"):
        assert t in types


def test_port_trains_bert_as_jax(jax_run):
    with fresh_port_programs():
        model, main, _ = _port_program(jax_run["amp"])
        got = port_two_steps(main, model["loss"].name, _feed(),
                             jax_run["start"])
    assert_same_two_steps(got, jax_run["want"], **TOL[jax_run["amp"]])


def test_compiled_bert_step_equals_interpreted(jax_run):
    with fresh_port_programs():
        model, main, _ = _port_program(jax_run["amp"])
        assert_compiled_equals_interpreted(main, model["loss"].name,
                                           _feed(), jax_run["start"])


def test_bert_refuses_training_dropout():
    with fresh_port_programs():
        with pytest.raises(NotImplementedError, match="dropout"):
            port_bert(**dict(TINY_BERT, dropout_rate=0.1))
        # inference ignores dropout, as the JAX package's model does
        port_bert(**dict(TINY_BERT, dropout_rate=0.1, is_test=True))
