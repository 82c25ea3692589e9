"""The port's decode loops (paddle_tpu_torch/decode.py) and gather_tree
op against the JAX package's (paddle_tpu/decode.py,
paddle_tpu/ops/control_flow.py).

Both packages get the same step function: a recurrent toy model with
numpy weights made from a seed (h = 0.5 h + emb[id], logits = h @ proj),
written once in jnp and once in torch.  Tokens and beam parents must be
equal; scores agree within 1e-5 (f32 log-softmax sums in other orders).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import decode as jdecode
from paddle_tpu.core.registry import get_op_def as jax_op_def
from paddle_tpu_torch import decode as tdecode
from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.flags import get_flag, set_flags

V, D = 19, 8
SCORE_ATOL = 1e-5


def _weights(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(V, D).astype(np.float32),
            rng.randn(D, V).astype(np.float32))


def _jax_fn(seed):
    emb, proj = (jnp.asarray(w) for w in _weights(seed))

    def fn(ids, state, t):
        h = 0.5 * state["h"] + emb[ids[:, 0]]
        return h @ proj, {"h": h}

    return fn


def _torch_fn(seed):
    emb, proj = (torch.from_numpy(w) for w in _weights(seed))

    def fn(ids, state, t):
        h = 0.5 * state["h"] + emb[ids[:, 0].long()]
        return h @ proj, {"h": h}

    return fn


def test_gather_tree_matches_jax():
    rng = np.random.RandomState(0)
    t, b, k = 7, 3, 4
    ids = rng.randint(0, 50, (t, b, k)).astype(np.int32)
    parents = rng.randint(0, k, (t, b, k)).astype(np.int32)
    want = jax_op_def("gather_tree").compute(
        {"Ids": jnp.asarray(ids), "Parents": jnp.asarray(parents)},
        {})["Out"]
    got = get_op_def("gather_tree").compute(
        {"Ids": torch.from_numpy(ids), "Parents": torch.from_numpy(parents)},
        {}, torch.device("cpu"))["Out"]
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
@pytest.mark.parametrize("eos", [1, 8])
def test_greedy_search_matches_jax(kv_cache, eos):
    b, t = 4, 12
    js, jsc = jdecode.greedy_search(_jax_fn(5), {"h": jnp.zeros((b, D))},
                                    b, t, eos_id=eos, kv_cache=kv_cache)
    steps = []
    ts, tsc = tdecode.greedy_search(
        _torch_fn(5), {"h": torch.zeros((b, D))}, b, t, eos_id=eos,
        kv_cache=kv_cache, device="cpu", on_step=lambda t_, tok: steps.append(t_))
    assert ts.dtype == torch.int32 and ts.shape == (b, t)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.allclose(tsc.numpy(), np.asarray(jsc), atol=SCORE_ATOL)
    assert (len(steps) > 0) == (kv_cache == "paged")


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
@pytest.mark.parametrize("length_penalty", [0.0, 0.8])
def test_beam_search_matches_jax(kv_cache, length_penalty):
    b, k, t = 2, 3, 9
    js, jsc = jdecode.beam_search(_jax_fn(3), {"h": jnp.zeros((b * k, D))},
                                  b, k, V, t, eos_id=8,
                                  length_penalty=length_penalty,
                                  kv_cache=kv_cache)
    parents = []
    ts, tsc = tdecode.beam_search(
        _torch_fn(3), {"h": torch.zeros((b * k, D))}, b, k, V, t, eos_id=8,
        length_penalty=length_penalty, kv_cache=kv_cache,
        device="cpu", on_step=lambda t_, tok, par: parents.append(par))
    assert ts.shape == (b, k, t)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.allclose(tsc.numpy(), np.asarray(jsc), atol=SCORE_ATOL)
    if kv_cache == "paged":
        assert parents and parents[0].shape == (b, k)


def test_paged_early_exit_pads_to_dense():
    """The host loop stops at all-finished; the padded tail equals the
    full loop's."""
    fn = _torch_fn(2)
    b, t = 3, 14
    sd, _ = tdecode.greedy_search(fn, {"h": torch.zeros((b, D))}, b, t,
                                  kv_cache="dense", device="cpu")
    eos = int(sd[0, 1])                    # force an early finish
    sd2, scd2 = tdecode.greedy_search(fn, {"h": torch.zeros((b, D))}, b, t,
                                      eos_id=eos, kv_cache="dense", device="cpu")
    steps = []
    sp2, scp2 = tdecode.greedy_search(
        fn, {"h": torch.zeros((b, D))}, b, t, eos_id=eos, kv_cache="paged",
        device="cpu", on_step=lambda t_, tok: steps.append(t_))
    assert torch.equal(sd2, sp2) and torch.equal(scd2, scp2)
    assert len(steps) < t                  # it really exited early
    k = 2
    init = {"h": torch.zeros((b * k, D))}
    bd = tdecode.beam_search(fn, init, b, k, V, t, eos_id=eos,
                             kv_cache="dense", device="cpu")
    bp = tdecode.beam_search(fn, init, b, k, V, t, eos_id=eos,
                             kv_cache="paged", device="cpu")
    assert torch.equal(bd[0], bp[0]) and torch.equal(bd[1], bp[1])


def test_paged_flag_dispatch_and_validation():
    fn = _torch_fn(4)
    b, t = 2, 6
    assert get_flag("paged_decode") is False
    base, _ = tdecode.greedy_search(fn, {"h": torch.zeros((b, D))}, b, t,
                                    device="cpu")
    try:
        set_flags({"paged_decode": True})
        steps = []
        via_flag, _ = tdecode.greedy_search(
            fn, {"h": torch.zeros((b, D))}, b, t, device="cpu",
            on_step=lambda t_, tok: steps.append(t_))
        assert steps and torch.equal(base, via_flag)
    finally:
        set_flags({"paged_decode": False})
    with pytest.raises(ValueError):
        tdecode.greedy_search(fn, {"h": torch.zeros((1, D))}, 1, 2,
                              kv_cache="sparse", device="cpu")


def test_spec_accept_length_rule_matches_jax():
    cases = [([5, 6, 7], [5, 6, 7, 9]), ([5, 6, 7], [5, 9, 7, 9]),
             ([5, 6, 7], [4, 6, 7, 9]), ([], [4])]
    for draft, target in cases:
        assert tdecode.spec_accept_length(draft, target) == \
            jdecode.spec_accept_length(draft, target)
    assert [tdecode.spec_accept_length(*c) for c in cases] == [3, 1, 0, 0]
