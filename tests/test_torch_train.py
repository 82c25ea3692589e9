"""The port's training slice against the JAX package.

A 2-layer, d64, 4-head, vocab-512, seq-64 LM trained with Adam.  The
same numpy inputs go to both packages.

- Grad ops: the port's synthesised ``<op>_grad`` (autograd) against the
  JAX package's (``jax.vjp``), one case per op and attr variant on the
  path, with the same upstream grads: f32 within atol=rtol=1e-5 (other
  summation orders).
- Optimizer ops: ``sgd``, ``momentum`` and ``adam`` within 1e-6.
- Programs: the port's ``Adam.minimize`` appends the JAX package's ops,
  slots, var names, attrs and roles (``to_dict`` equal).
- Training both ways: 3 Adam steps (lr 1e-3) from the same weights, a
  program built by either package run by the other's Executor.  Losses
  agree within rtol=atol=1e-5 and grads within 1e-4 (per-op f32 against
  XLA's f32, in other orders).  Adam's update ``lr*m1/(sqrt(m2)+eps)``
  is close to ``lr*sign(g)`` for a tiny grad, so a rounding difference
  can flip it: parameters after step 3 agree within ``2*lr`` per step
  plus the grad tolerance, moments within the grad tolerance.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as fluid
from paddle_tpu import optimizer as jax_optimizer
from paddle_tpu.core import registry as jax_registry
from paddle_tpu.core.program import Program as JaxProgram
from paddle_tpu.core.scope import Scope as JaxScope
from paddle_tpu.core.scope import scope_guard as jax_scope_guard
from paddle_tpu.models.transformer import \
    transformer_encoder_model as jax_model
from torch_port_helpers import TINY_LM, fresh_port_programs, to_numpy

import paddle_tpu_torch as pt
from paddle_tpu_torch import convert
from paddle_tpu_torch.core import registry as pt_registry
from paddle_tpu_torch.core.program import Program as PortProgram
from paddle_tpu_torch.models.transformer import \
    transformer_encoder_model as port_model

TRAIN_LM = dict(TINY_LM, is_test=False)
LR = 1e-3
STEPS = 3
GRAD_TOL = 1e-4
PARAM_ATOL = 2 * LR * STEPS + GRAD_TOL
_rng = np.random.RandomState(5)


def _f(*shape):
    return _rng.standard_normal(shape).astype(np.float32)


def _ids(shape, high):
    return _rng.randint(0, high, shape).astype(np.int64)


# ---------------------------------------------------------------------------
# (a) grad synthesis, op by op
# ---------------------------------------------------------------------------

# (forward op, forward inputs, attrs, output slots that get a grad)
GRAD_CASES = [
    ("mul", {"X": _f(6, 4), "Y": _f(4, 5)}, {"x_num_col_dims": 1},
     ("Out",)),
    ("mul", {"X": _f(2, 3, 4), "Y": _f(4, 5)}, {"x_num_col_dims": 2},
     ("Out",)),
    ("elementwise_add", {"X": _f(2, 3, 4), "Y": _f(2, 3, 4)}, {"axis": -1},
     ("Out",)),
    ("elementwise_add", {"X": _f(2, 3, 4), "Y": _f(4)}, {"axis": 2},
     ("Out",)),
    ("layer_norm", {"X": _f(2, 3, 8), "Scale": _f(8), "Bias": _f(8)},
     {"begin_norm_axis": 2}, ("Y",)),
    ("lookup_table", {"W": _f(10, 4),
                      "Ids": np.array([[[3], [3], [7]], [[0], [3], [7]]],
                                      np.int64)}, {}, ("Out",)),
    ("softmax_with_cross_entropy",
     {"Logits": _f(2, 3, 7), "Label": _ids((2, 3, 1), 7)}, {}, ("Loss",)),
    ("mean", {"X": _f(3, 5)}, {}, ("Out",)),
    ("reshape2", {"X": _f(2, 3, 8)}, {"shape": [-1, 3, 2, 4]}, ("Out",)),
    ("transpose2", {"X": _f(2, 3, 4, 5)}, {"axis": [0, 2, 1, 3]},
     ("Out",)),
    ("scale", {"X": _f(3, 4)}, {"scale": 2.5, "bias": 0.5}, ("Out",)),
    ("relu", {"X": _f(3, 5)}, {}, ("Out",)),
    ("sum", {"X": [_f(3, 4), _f(3, 4), _f(3, 4)]}, {}, ("Out",)),
    ("flash_attention", {"Q": _f(1, 2, 24, 16), "K": _f(1, 2, 24, 16),
                         "V": _f(1, 2, 24, 16)}, {"causal": True},
     ("Out",)),
]


def _tree(x, fn):
    return [fn(v) for v in x] if isinstance(x, list) else fn(x)


@pytest.mark.parametrize("op_type,ins,attrs,grad_slots", GRAD_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(GRAD_CASES)])
def test_grad_op_matches_jax(op_type, ins, attrs, grad_slots):
    jdef = jax_registry.get_op_def(op_type + "_grad")
    pdef = pt_registry.get_op_def(op_type + "_grad")
    assert pt_registry.has_op_def(op_type + "_grad")
    assert (pdef.inputs, pdef.outputs, pdef.duplicable, pdef.optional,
            pdef.differentiable) == (jdef.inputs, jdef.outputs,
                                     jdef.duplicable, jdef.optional,
                                     jdef.differentiable)
    fwd = jax_registry.get_op_def(op_type)
    jattrs = fwd.canonical_attrs(attrs)
    jouts = fwd.compute({k: _tree(v, jnp.asarray) for k, v in ins.items()},
                        jattrs)
    rng = np.random.RandomState(len(op_type))
    cts = {s + "@GRAD": rng.standard_normal(jouts[s].shape)
           .astype(np.float32) for s in grad_slots}
    jgrads = jdef.compute({**{k: _tree(v, jnp.asarray)
                              for k, v in {**ins, **cts}.items()}}, jattrs)
    pgrads = pdef.compute({k: _tree(v, torch.from_numpy)
                           for k, v in {**ins, **cts}.items()},
                          pdef.canonical_attrs(attrs), torch.device("cpu"))
    assert set(pgrads) == set(jgrads)
    for slot in jgrads:
        p_list, j_list = pgrads[slot], jgrads[slot]
        if not isinstance(p_list, list):
            p_list, j_list = [p_list], [j_list]
        for p, j in zip(p_list, j_list):
            p, j = to_numpy(p), to_numpy(j)
            assert p.shape == j.shape, slot
            np.testing.assert_allclose(p, j, rtol=1e-5, atol=1e-5,
                                       err_msg=slot)
    assert not any(g.requires_grad for v in pgrads.values()
                   for g in (v if isinstance(v, list) else [v]))


def test_mean_grad_takes_a_squeeze_compatible_cotangent():
    """A ``[1]`` upstream grad for mean's ``[]`` output is reshaped, as
    the JAX package's synthesised grad does; a mismatch that is not
    squeeze-compatible raises."""
    pdef = pt_registry.get_op_def("mean_grad")
    x = torch.from_numpy(_f(3, 5))
    g = pdef.compute({"X": x, "Out@GRAD": torch.tensor([2.0])}, {},
                     torch.device("cpu"))["X@GRAD"]
    np.testing.assert_allclose(g.numpy(), np.full((3, 5), 2.0 / 15),
                               rtol=1e-6)
    with pytest.raises(RuntimeError):
        pdef.compute({"X": x, "Out@GRAD": torch.ones(2)}, {},
                     torch.device("cpu"))


# ---------------------------------------------------------------------------
# (c) optimizer ops
# ---------------------------------------------------------------------------

_P, _G = _f(4, 5), _f(4, 5)
OPT_CASES = [
    ("sgd", {"Param": _P, "Grad": _G,
             "LearningRate": np.array([0.1], np.float32)}, {}),
    ("momentum", {"Param": _P, "Grad": _G, "Velocity": _f(4, 5),
                  "LearningRate": np.array([0.1], np.float32)},
     {"mu": 0.9}),
    ("momentum", {"Param": _P, "Grad": _G, "Velocity": _f(4, 5),
                  "LearningRate": np.array([0.1], np.float32)},
     {"mu": 0.9, "use_nesterov": True}),
    ("adam", {"Param": _P, "Grad": _G, "Moment1": _f(4, 5),
              "Moment2": np.abs(_f(4, 5)),
              "Beta1Pow": np.array([0.9 ** 3], np.float32),
              "Beta2Pow": np.array([0.999 ** 3], np.float32),
              "LearningRate": np.array([1e-3], np.float32)}, {}),
    ("adam", {"Param": _P, "Grad": _G, "Moment1": np.zeros((4, 5),
                                                           np.float32),
              "Moment2": np.zeros((4, 5), np.float32),
              "Beta1Pow": np.array([0.8], np.float32),
              "Beta2Pow": np.array([0.99], np.float32),
              "LearningRate": np.array([1e-2], np.float32)},
     {"beta1": 0.8, "beta2": 0.99, "epsilon": 1e-6, "lazy_mode": True}),
]


@pytest.mark.parametrize("op_type,ins,attrs", OPT_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(OPT_CASES)])
def test_optimizer_op_matches_jax(op_type, ins, attrs):
    jdef = jax_registry.get_op_def(op_type)
    pdef = pt_registry.get_op_def(op_type)
    assert (pdef.inputs, pdef.outputs, pdef.in_place) == \
        (jdef.inputs, jdef.outputs, jdef.in_place)
    assert {k: repr(v) for k, v in pdef.attrs.items()} == \
        {k: repr(v) for k, v in jdef.attrs.items()}
    jout = jdef.compute({k: jnp.asarray(v) for k, v in ins.items()},
                        jdef.canonical_attrs(attrs))
    pout = pdef.compute({k: torch.from_numpy(v) for k, v in ins.items()},
                        pdef.canonical_attrs(attrs), torch.device("cpu"))
    assert set(pout) == set(jout)
    for slot in jout:
        p, j = to_numpy(pout[slot]), to_numpy(jout[slot])
        assert p.shape == j.shape and p.dtype == j.dtype, slot
        np.testing.assert_allclose(p, j, rtol=1e-6, atol=1e-6,
                                   err_msg=slot)


def test_optimizer_refuses_what_it_cannot_honour():
    with fresh_port_programs():
        model = port_model(**TRAIN_LM)
        # Adam(fuse=True) is honoured: one fused_adam op, no adam op
        with fresh_port_programs():
            fused = port_model(**TRAIN_LM)
            pt.optimizer.Adam(LR, fuse=True).minimize(fused["loss"])
            types = [op.type for op in
                     pt.default_main_program().global_block().ops]
        assert types.count("fused_adam") == 1 and "adam" not in types
        with pytest.raises(NotImplementedError, match="regularization"):
            pt.optimizer.SGD(LR, regularization=object())
        with pytest.raises(NotImplementedError, match="grad_clip"):
            pt.optimizer.Adam(LR).minimize(model["loss"],
                                           grad_clip=lambda pg: pg)
        x = pt.layers.data("x", shape=[4])
        y = pt.layers.fc(x, 2, param_attr=pt.ParamAttr(regularizer=object()))
        with pytest.raises(NotImplementedError, match="regularizers"):
            pt.optimizer.SGD(LR).minimize(pt.layers.mean(y))


# ---------------------------------------------------------------------------
# (d) the same program
# ---------------------------------------------------------------------------

def _canon(program):
    return json.dumps(program.to_dict(), sort_keys=True)


def _build_jax():
    model = jax_model(**TRAIN_LM)
    jax_optimizer.Adam(LR).minimize(model["loss"])
    return (model, fluid.default_main_program(),
            fluid.default_startup_program())


def _build_port():
    model = port_model(**TRAIN_LM)
    pt.optimizer.Adam(LR).minimize(model["loss"])
    return model, pt.default_main_program(), pt.default_startup_program()


def test_port_appends_the_jax_train_program():
    _, jmain, jstart = _build_jax()
    with fresh_port_programs():
        _, pmain, pstart = _build_port()
        assert _canon(pmain) == _canon(jmain)
        assert _canon(pstart) == _canon(jstart)
        types = [op.type for op in pmain.global_block().ops]
    assert types.count("adam") == 26 and types.count("sum") > 0
    assert "flash_attention_grad" in types


# ---------------------------------------------------------------------------
# (e) the slice both ways, (f) no graph kept
# ---------------------------------------------------------------------------

def _batch():
    rng = np.random.RandomState(6)
    shape = (2, TRAIN_LM["max_len"], 1)
    return {"src_ids": rng.randint(0, TRAIN_LM["vocab_size"], shape)
            .astype(np.int64),
            "tgt_label": rng.randint(0, TRAIN_LM["vocab_size"], shape)
            .astype(np.int64)}


def _persistable_names(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _grad_names(main):
    return sorted(v.name + "@GRAD" for v in main.all_parameters())


def _train_jax(main, startup, loss_name, init=None):
    """Startup (or ``init`` values), then STEPS steps.  Returns the
    losses, the first step's grads and the persistables after."""
    exe = fluid.Executor(fluid.CPUPlace())
    with jax_scope_guard(JaxScope()):
        np.random.seed(0)
        exe.run(startup)
        scope = fluid.global_scope()
        if init is not None:
            for name, arr in init.items():
                scope.var(name).set(jnp.asarray(arr))
        names = _persistable_names(main)
        start = {n: to_numpy(scope.find_var(n).get()) for n in names}
        losses, grads = [], None
        for _ in range(STEPS):
            out = exe.run(main, feed=_batch(),
                          fetch_list=[loss_name] + _grad_names(main))
            losses.append(float(out[0]))
            grads = grads or dict(zip(_grad_names(main), out[1:]))
        end = {n: to_numpy(scope.find_var(n).get()) for n in names}
    return losses, grads, start, end


def _train_port(main, startup, loss_name, init=None):
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    if init is None:
        np.random.seed(0)
        exe.run(startup, scope=scope)
    else:
        convert.params_from_numpy(init, scope, "cpu")
    losses, grads = [], None
    for _ in range(STEPS):
        out = exe.run(main, feed=_batch(), scope=scope,
                      fetch_list=[loss_name] + _grad_names(main))
        losses.append(float(out[0]))
        grads = grads or dict(zip(_grad_names(main), out[1:]))
    leaked = [n for n, v in scope.vars.items()
              if isinstance(v.get(), torch.Tensor)
              and (v.get().requires_grad or v.get().grad_fn is not None)]
    assert leaked == []               # (f) no autograd graph kept
    end = convert.params_to_numpy(scope, _persistable_names(main))
    return losses, grads, end


def _assert_same_training(got, want):
    (p_losses, p_grads, p_end), (j_losses, j_grads, j_end) = got, want
    assert np.isfinite(p_losses).all() and p_losses[-1] < p_losses[0]
    np.testing.assert_allclose(p_losses, j_losses, rtol=1e-5, atol=1e-5)
    assert sorted(p_grads) == sorted(j_grads)
    for name in j_grads:
        np.testing.assert_allclose(p_grads[name], j_grads[name],
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
    assert sorted(p_end) == sorted(j_end)
    for name in j_end:
        is_moment = "_moment" in name or "_beta" in name
        np.testing.assert_allclose(
            p_end[name], j_end[name], rtol=GRAD_TOL if is_moment else 0,
            atol=GRAD_TOL if is_moment else PARAM_ATOL, err_msg=name)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX-built program, its dict, and its JAX Executor run."""
    from conftest import _reset_program_state

    _reset_program_state()
    model, main, startup = _build_jax()
    losses, grads, start, end = _train_jax(main, startup,
                                           model["loss"].name)
    return dict(main=main.to_dict(), startup=startup.to_dict(),
                loss=model["loss"].name, run=(losses, grads, end),
                start=start)


def test_port_executor_trains_a_jax_built_program(jax_run):
    main = PortProgram.from_dict(jax_run["main"])
    startup = PortProgram.from_dict(jax_run["startup"])
    got = _train_port(main, startup, jax_run["loss"])
    _assert_same_training(got, jax_run["run"])


def test_jax_executor_trains_a_port_built_program():
    with fresh_port_programs():
        model, pmain, pstart = _build_port()
        port = _train_port(pmain, pstart, model["loss"].name)
        main = JaxProgram.from_dict(pmain.to_dict())
        startup = JaxProgram.from_dict(pstart.to_dict())
    losses, grads, _, end = _train_jax(main, startup, model["loss"].name)
    _assert_same_training(port, (losses, grads, end))


def test_port_front_end_trains_from_jax_weights(jax_run):
    """The port's own build, with the JAX run's starting parameters and
    optimizer state carried in by name."""
    with fresh_port_programs():
        model, pmain, pstart = _build_port()
        assert _persistable_names(pmain) == sorted(jax_run["start"])
        got = _train_port(pmain, pstart, model["loss"].name,
                          init=jax_run["start"])
    _assert_same_training(got, jax_run["run"])
