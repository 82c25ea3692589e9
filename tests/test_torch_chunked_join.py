"""A chunked-prefill join on the port's DecodeServer against the JAX
package's, on the CPU.

The shape of ``tests/test_decode_act2.py``'s fast join
(``_chunked_join_slo(join_len=2048, chunk=128)``): TinyDecodeLM at its
defaults (vocab 128, d_model 64, 4 heads of 16; the same weights in both
packages), page 64, max_batch 4, 3 streams of 6-token prompts decoding 24
tokens while one 2048-token prompt joins once they are running and
prefills in 128-token chunks, then decodes 4 tokens.  The same prompts
go to both servers.  Bars: every stream's tokens and the joiner's equal
to the JAX server's, and to the port's run of the same requests with no
chunking (the contract: chunked prefill == whole prefill); at least
2048/128 - 1 chunks prefilled; zero pages in use after ``stop()`` and
the page accounting whole.  The bench's 32768-token join in 512-token
chunks runs on the card (``chip_smoke.py``).
"""

from __future__ import annotations

import time

import numpy as np
import pytest

from paddle_tpu_torch import serving

JOIN_LEN, CHUNK, PAGE = 2048, 128, 64
WAIT_S = 300.0


def _config(chunk):
    return dict(max_batch=4, max_new_tokens=24, page_size=PAGE,
                num_pages=-(-(JOIN_LEN + 64) // PAGE) + 40, n_replicas=1,
                default_deadline_s=300.0, prefill_chunk=chunk)


def _prompts():
    rng = np.random.RandomState(3)
    return ([rng.randint(2, 128, size=6) for _ in range(3)],
            rng.randint(2, 128, size=JOIN_LEN))


def _join(srv):
    """The streams submitted, the joiner once they have decoded two
    iterations; returns (stream tokens, joiner tokens, stats)."""
    streams, joiner = _prompts()
    try:
        futs = [srv.submit(p) for p in streams]
        deadline = time.monotonic() + WAIT_S
        while srv.stats()["decode"]["iterations"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.001)
        jf = srv.submit(joiner, max_new_tokens=4)
        outs = [list(f.result(timeout=WAIT_S)[0]) for f in futs]
        jout = list(jf.result(timeout=WAIT_S)[0])
    finally:
        srv.stop()
    return outs, jout, srv.stats()


@pytest.fixture(scope="module")
def jax_join():
    from paddle_tpu import serving as jserving

    return _join(jserving.DecodeServer(
        config=jserving.DecodeConfig(**_config(CHUNK))).start())


def _port_join(chunk):
    srv = serving.DecodeServer(config=serving.DecodeConfig(
        device="cpu", **_config(chunk))).start()
    outs, jout, st = _join(srv)
    ok, detail = srv.page_accounting()
    assert ok, detail
    assert st["accounted"]
    assert all(r["cache"]["in_use_pages"] == 0
               for r in st["replicas"].values())
    return outs, jout, st


@pytest.mark.parametrize("chunk", [CHUNK, 0], ids=["chunked", "whole"])
def test_join_emits_the_jax_servers_tokens(jax_join, chunk):
    outs, jout, st = _port_join(chunk)
    j_outs, j_jout, j_st = jax_join
    assert outs == j_outs and jout == j_jout
    # each up to its max_new tokens (an eos ends a sequence early)
    assert all(1 <= len(o) <= 24 for o in outs) and 1 <= len(jout) <= 4
    if chunk:
        assert st["decode"]["prefill_chunks"] >= JOIN_LEN // CHUNK - 1
        assert st["decode"]["prefill_chunks"] == \
            j_st["decode"]["prefill_chunks"]
    else:
        assert st["decode"]["prefill_chunks"] == 0
