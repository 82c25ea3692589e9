"""The port's DecodeServer (paddle_tpu_torch/serving/decode_engine.py) on
the CPU against the JAX package's DecodeServer and a dense oracle.

The model is TinyDecodeLM at vocab 128, d_model 64, 4 heads of 16, from
the same seed in both packages (the weights are equal, asserted below).
Prompts are made with numpy from a seed.  The port's server must emit
the JAX server's tokens exactly, in plain, chunked-prefill,
prefix-sharing and speculative runs, and match a dense full-prefix
oracle written in torch.  The serving contracts (exactly-once under a
seeded kill/drop plan, zero page leaks after drain, typed deadline and
shutdown errors, preemption under pool pressure) are checked on the
port as the JAX package's tests check them there.  Every ``result()``
has a timeout.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from paddle_tpu_torch import convert, serving
from paddle_tpu_torch.distributed import faultinject
from paddle_tpu_torch.distributed.faultinject import FaultPlan

WAIT_S = 60.0


def _config(**kw):
    cfg = dict(max_batch=4, max_new_tokens=10, page_size=16, num_pages=60,
               n_replicas=1, eos_id=1, default_deadline_s=120.0)
    cfg.update(kw)
    return cfg


def _run(prompts, **kw):
    srv = serving.DecodeServer(
        config=serving.DecodeConfig(device="cpu", **_config(**kw))).start()
    try:
        futs = [srv.submit(p) for p in prompts]
        outs = [list(f.result(timeout=WAIT_S)[0]) for f in futs]
    finally:
        srv.stop()
    ok, detail = srv.page_accounting()
    assert ok, detail
    st = srv.stats()
    assert st["accounted"]
    for rep in st["replicas"].values():
        assert rep["cache"]["in_use_pages"] == 0
        if "draft_cache" in rep:
            assert rep["draft_cache"]["in_use_pages"] == 0
    return outs, st, srv


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(2, 128, size=int(rng.randint(1, 40)))
            for _ in range(8)]


@pytest.fixture(scope="module")
def jax_outputs(prompts):
    from paddle_tpu import serving as jserving

    srv = jserving.DecodeServer(
        config=jserving.DecodeConfig(**_config())).start()
    try:
        futs = [srv.submit(p) for p in prompts]
        return [list(f.result(timeout=WAIT_S)[0]) for f in futs]
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def port_outputs(prompts):
    return _run(prompts)


def _dense_oracle(model, prompt, max_new=10, eos=1):
    """Greedy decode re-running attention over the whole prefix every
    step: no cache at all."""
    hist, gen = list(prompt), []
    for _ in range(max_new):
        q, k, v = model.qkv(np.asarray(hist))
        s = torch.einsum("hd,thd->ht", q[-1], k) / np.sqrt(model.head_dim)
        o = torch.einsum("ht,thd->hd", torch.softmax(s, dim=-1), v)
        tok = int(torch.argmax(model.logits(o[None])[0]))
        gen.append(tok)
        hist.append(tok)
        if tok == eos:
            break
    return gen


def test_seeded_weights_equal_the_jax_model():
    from paddle_tpu.serving.decode_engine import TinyDecodeLM as JaxLM

    jm = JaxLM(vocab=128, d_model=64, num_heads=4, head_dim=16, seed=3)
    tm = serving.TinyDecodeLM(vocab=128, d_model=64, num_heads=4,
                              head_dim=16, seed=3, device="cpu")
    params = {n: np.asarray(getattr(jm, n))
              for n in ("embed", "wq", "wk", "wv", "wo")}
    for name, w in params.items():
        assert np.array_equal(getattr(tm, name).detach().numpy(), w), name
    carried = convert.tiny_decode_lm_from_numpy(
        dict(params, num_heads=4), device="cpu")
    assert (carried.num_heads, carried.head_dim) == (4, 16)
    toks = np.arange(2, 9)
    for a, b, c in zip(tm.qkv(toks), carried.qkv(toks), jm.qkv(toks)):
        assert torch.equal(a, b)
        assert np.allclose(a.numpy(), np.asarray(c), atol=1e-5)
    assert not any(p.requires_grad for p in tm.parameters())


def test_server_matches_jax_and_dense_oracle(prompts, jax_outputs,
                                             port_outputs):
    outs, st, srv = port_outputs
    assert outs == jax_outputs
    model = srv.replicas[0].model
    for p, out in zip(prompts, outs):
        assert out == _dense_oracle(model, p)
    assert st["decode"]["iterations"] > 0
    assert st["decode"]["prefills"] == len(prompts)


@pytest.mark.parametrize("knob", [dict(prefill_chunk=8), dict(kv_share=True),
                                  dict(spec_k=2),
                                  dict(spec_k=2, prefill_chunk=8,
                                       kv_share=True)])
def test_options_emit_the_same_tokens(prompts, jax_outputs, knob):
    outs, st, _ = _run(prompts, **knob)
    assert outs == jax_outputs
    if "prefill_chunk" in knob:
        assert st["decode"]["prefill_chunks"] > 0
    if "spec_k" in knob:
        assert st["decode"]["spec_proposed"] > 0
        assert 0.0 <= st["spec_acceptance_rate"] <= 1.0


@pytest.mark.parametrize("knob", [dict(kv_int8=True),
                                  dict(kv_int8=True, spec_k=2,
                                       prefill_chunk=8, kv_share=True)])
def test_int8_server_matches_jax(prompts, knob):
    """int8 pools calibrated once, on the first prefill (the JAX
    package's static-scale contract): the port's server emits the JAX
    server's tokens, and its scales equal the JAX cache's to 1e-6."""
    from paddle_tpu import serving as jserving

    jsrv = jserving.DecodeServer(
        config=jserving.DecodeConfig(**_config(**knob))).start()
    try:
        futs = [jsrv.submit(p) for p in prompts]
        want = [list(f.result(timeout=WAIT_S)[0]) for f in futs]
    finally:
        jsrv.stop()
    outs, _, srv = _run(prompts, **knob)
    assert outs == want
    for got, ref in zip(srv.replicas[0].cache.kv_scales(),
                        jsrv.replicas[0].cache.kv_scales()):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_shared_system_prompt_amortizes():
    rng = np.random.RandomState(9)
    sys_prompt = rng.randint(2, 128, size=48)
    prompts = [np.concatenate([sys_prompt, rng.randint(2, 128, size=4)])
               for _ in range(4)]
    base, _, _ = _run(prompts)
    outs, st, _ = _run(prompts, kv_share=True)
    assert outs == base
    assert max(r["cache"]["peak_shared_pages"]
               for r in st["replicas"].values()) >= 3


def test_spec_decode_self_draft_full_acceptance(prompts, jax_outputs):
    outs, st, _ = _run(prompts[:4], spec_k=3, draft_factory=lambda i:
                       serving.TinyDecodeLM(device="cpu"))
    assert outs == jax_outputs[:4]
    assert st["spec_acceptance_rate"] == 1.0


def test_chaos_exactly_once_zero_page_leaks():
    """A seeded kill/drop plan over serving_decode: every admitted
    sequence is answered exactly once, the kill fails its batch over to
    the survivor, and after drain no page is leaked."""
    plan = FaultPlan()
    plan.on("serving_decode", 2, "kill")
    plan.on("serving_decode", 5, "drop")
    plan.on("serving_decode", 9, "delay=0.01+drop")
    rng = np.random.RandomState(3)
    with faultinject.installed(plan):
        srv = serving.DecodeServer(config=serving.DecodeConfig(
            device="cpu", **_config(n_replicas=2, restart_dead=False))
        ).start()
        futures = [srv.submit(rng.randint(2, 128,
                                          size=int(rng.randint(1, 6))))
                   for _ in range(12)]
        answered = 0
        for f in futures:
            try:
                f.result(timeout=WAIT_S)
            except serving.ServingError:
                pass
            answered += 1
        leftovers = srv.stop()
        st = srv.stats()
    assert answered == len(futures) and leftovers == 0
    assert st["accounted"] and st["outstanding"] == 0
    assert st["decode"]["kills"] == 1 and st["decode"]["failovers"] >= 1
    assert st["decode"]["step_faults"] >= 1
    ok, detail = srv.page_accounting()
    assert ok, detail
    for rep in st["replicas"].values():
        assert rep["cache"]["in_use_pages"] == 0


def test_deadline_expires_typed_mid_generation():
    plan = FaultPlan(seed=1, rate=1.0, actions=("delay=0.05",),
                     max_faults=1000)
    with faultinject.installed(plan):
        srv = serving.DecodeServer(config=serving.DecodeConfig(
            device="cpu", **_config(max_new_tokens=64))).start()
        try:
            req = srv.submit(np.asarray([2, 3, 4]), deadline_s=0.15)
            with pytest.raises(serving.DeadlineExpiredError):
                req.result(timeout=30.0)
        finally:
            srv.stop()
    ok, detail = srv.page_accounting()
    assert ok, detail


def test_drain_answers_typed_shutdown():
    srv = serving.DecodeServer(
        config=serving.DecodeConfig(device="cpu", **_config())).start()
    req = srv.submit(np.asarray([2, 3, 4]), max_new_tokens=5)
    assert len(req.result(timeout=WAIT_S)[0]) <= 5
    srv.admission.start_drain()
    with pytest.raises(serving.ShutdownError):
        srv.submit(np.asarray([5, 6]))
    assert srv.stop() == 0
    assert srv.stats()["accounted"]
    with pytest.raises(serving.ShutdownError):
        srv.submit(np.asarray([5, 6]))


@pytest.mark.parametrize("spec_k", [0, 3])
def test_preemption_under_pool_pressure(spec_k):
    """A pool too small for the whole batch preempts (deadline-aware)
    instead of corrupting pages: every request answers, accounting
    exact, tokens unchanged."""
    rng = np.random.RandomState(5 + spec_k)
    prompts = [rng.randint(2, 128, size=6) for _ in range(6)]
    base, _, _ = _run(prompts, max_new_tokens=8)
    outs, st, _ = _run(prompts, spec_k=spec_k, page_size=4,
                       num_pages=10 if spec_k else 8, max_new_tokens=8)
    assert outs == base
    assert st["decode"]["preemptions"] > 0


def test_submit_validation_and_refusals():
    srv = serving.DecodeServer(
        config=serving.DecodeConfig(device="cpu", **_config())).start()
    try:
        with pytest.raises(ValueError):
            srv.submit(np.zeros((2, 2), np.int32))       # not 1-D
        with pytest.raises(ValueError):
            srv.submit(np.asarray([1.5, 2.5]))           # not ints
        with pytest.raises(ValueError):
            srv.submit(np.asarray([99999]))              # out of vocab
        with pytest.raises(ValueError):
            srv.submit(np.asarray([2] * 10000))          # never fits
    finally:
        srv.stop()
    with pytest.raises(NotImplementedError, match="item 4.3"):
        serving.DecodeConfig(device="cpu", collector="localhost:1")
    assert serving.DecodeConfig(device="cpu",
                                metrics_port=0).metrics_port == 0


def test_decode_entry_points_refuse_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the server runs there")
    from paddle_tpu_torch.core.types import NoCUDADeviceError

    with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
        serving.DecodeConfig()
    with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
        serving.TinyDecodeLM()
    from paddle_tpu_torch import decode

    for search, args in ((decode.greedy_search, (1, 2)),
                         (decode.beam_search, (1, 2, 5, 2))):
        with pytest.raises(NoCUDADeviceError, match="device='cpu'"):
            search(lambda ids, state, t: None, {}, *args)
