"""Sequence decoding: beam search, greedy search, the speculative rule.

Counterpart of ``paddle_tpu/decode.py``.  The state is dense: [B, K]
scores, finished flags and parent pointers, and ``gather_tree``
(``ops/control_flow.py``) rebuilds the sequences at the end.

``kv_cache="dense"`` runs all ``max_len`` steps (the JAX package's one
``lax.scan``, as a Python loop).  ``kv_cache="paged"`` runs the same
step and stops as soon as every sequence is finished; the skipped
steps are eos no-ops and are padded exactly (tokens with eos, beam
parents with the identity), so both give the same output.  The step fn
may then carry a paged KV-cache, and ``on_step(t, token[, parent])``
fires after each step for its bookkeeping.  ``None`` defers to the
``paged_decode`` flag.

Both loops run on ``device``, the card unless the caller passes
``"cpu"`` (without a card the default raises).
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import get_op_def
from paddle_tpu_torch.ops.paged_kv import resolve_device

_NEG_INF = -1e9


def spec_accept_length(draft_tokens, target_tokens):
    """The lossless greedy acceptance rule of speculative decoding.

    ``draft_tokens`` d_1..d_k are the draft model's proposals;
    ``target_tokens`` t_0..t_k are the target model's greedy picks at
    the k+1 verify positions (t_0 follows the pending token, t_i follows
    d_i).  Returns m, the largest count with d_j == t_{j-1} for every
    j <= m, so the caller emits t_0..t_m: m+1 tokens, each exactly what
    sequential greedy decoding would have produced."""
    draft_tokens = [int(t) for t in draft_tokens]
    target_tokens = [int(t) for t in target_tokens]
    m = 0
    while m < len(draft_tokens) and draft_tokens[m] == target_tokens[m]:
        m += 1
    return m


def _resolve_kv_cache(kv_cache):
    """None -> the ``paged_decode`` flag; an explicit str wins."""
    if kv_cache is None:
        from paddle_tpu_torch.flags import get_flag

        return "paged" if get_flag("paged_decode") else "dense"
    if kv_cache not in ("dense", "paged"):
        raise ValueError("kv_cache must be 'dense' or 'paged', got %r"
                         % (kv_cache,))
    return kv_cache


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _gather_beams(x, parent, batch, beam):
    """x: [B*K, ...] -> reorder beams by parent [B, K]."""
    shaped = x.reshape((batch, beam) + tuple(x.shape[1:]))
    idx = parent.reshape((batch, beam) + (1,) * (x.dim() - 1)).expand(
        shaped.shape)
    out = torch.gather(shaped, 1, idx)
    return out.reshape((batch * beam,) + tuple(x.shape[1:]))


def _top_k(x, k):
    """``lax.top_k`` over the last axis: values descending, ties to the
    lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(symbols_to_logits_fn, init_state, batch_size, beam_size,
                vocab_size, max_len, bos_id=0, eos_id=1,
                length_penalty=0.0, kv_cache=None, on_step=None,
                device="cuda"):
    """Returns (sequences [B, K, T], scores [B, K]), best beam first.

    symbols_to_logits_fn(ids, state, t) -> (logits [B*K, V], new_state);
    ``ids`` is [B*K, 1] (tokens chosen at the previous step).  All state
    leaves carry leading dim B*K.  ``on_step(t, token [B, K], parent
    [B, K])`` fires after each step of the paged loop."""
    device = resolve_device(device)
    b, k, v = batch_size, beam_size, vocab_size
    eos_row = torch.full((v,), _NEG_INF, device=device)
    eos_row[eos_id] = 0.0

    def step(carry, t):
        ids, log_probs, finished, state = carry
        logits, state = symbols_to_logits_fn(ids, state, t)
        lp = torch.log_softmax(logits.float(), dim=-1).reshape(b, k, v)
        # finished beams may only emit EOS, at no additional cost
        lp = torch.where(finished[:, :, None], eos_row[None, None, :], lp)
        total = log_probs[:, :, None] + lp
        top_scores, top_idx = _top_k(total.reshape(b, k * v), k)
        parent = top_idx // v
        token = top_idx % v
        finished = torch.gather(finished, 1, parent) | (token == eos_id)
        state = _tree_map(lambda s: _gather_beams(s, parent, b, k), state)
        new_ids = token.reshape(b * k, 1).to(torch.int32)
        return ((new_ids, top_scores, finished, state),
                (token.to(torch.int32), parent.to(torch.int32)))

    init_lp = torch.full((b, k), _NEG_INF, device=device)
    init_lp[:, 0] = 0.0          # only beam 0 is live: a unique expansion
    carry = (torch.full((b * k, 1), bos_id, dtype=torch.int32,
                        device=device), init_lp,
             torch.zeros((b, k), dtype=torch.bool, device=device),
             init_state)
    paged = _resolve_kv_cache(kv_cache) == "paged"
    tok_steps, par_steps = [], []
    for t in range(max_len):
        carry, (token, parent) = step(carry, t)
        tok_steps.append(token)
        par_steps.append(parent)
        if paged:
            if on_step is not None:
                on_step(t, token, parent)
            if bool(carry[2].all()):
                break
    # the skipped steps are no-ops: with every beam finished, each next
    # step emits eos at zero added cost and parent = identity
    n_pad = max_len - len(tok_steps)
    if n_pad:
        tok_steps += [torch.full((b, k), eos_id, dtype=torch.int32,
                                 device=device)] * n_pad
        par_steps += [torch.arange(k, dtype=torch.int32, device=device)
                      .expand(b, k)] * n_pad
    scores = carry[1]
    seqs = get_op_def("gather_tree").compute(
        {"Ids": torch.stack(tok_steps), "Parents": torch.stack(par_steps)},
        {}, device)["Out"]                  # [T, B, K]
    seqs = seqs.permute(1, 2, 0)                          # [B, K, T]
    if length_penalty:
        lengths = (seqs != eos_id).float().sum(dim=-1)
        scores = scores / ((5.0 + lengths) / 6.0) ** length_penalty
        order = torch.argsort(-scores, dim=-1, stable=True)
        scores = torch.gather(scores, 1, order)
        seqs = torch.gather(seqs, 1, order[:, :, None].expand(seqs.shape))
    return seqs, scores


def greedy_search(symbols_to_logits_fn, init_state, batch_size, max_len,
                  bos_id=0, eos_id=1, kv_cache=None, on_step=None,
                  device="cuda"):
    """Argmax decode; returns (sequences [B, T], scores [B]).
    ``on_step(t, token [B])`` fires after each step of the paged loop."""
    device = resolve_device(device)

    def step(carry, t):
        ids, score, finished, state = carry
        logits, state = symbols_to_logits_fn(ids, state, t)
        lp = torch.log_softmax(logits.float(), dim=-1)
        token = torch.argmax(lp, dim=-1)
        tok_lp = lp.amax(dim=-1)
        token = torch.where(finished, eos_id, token)
        score = score + torch.where(finished, 0.0, tok_lp)
        finished = finished | (token == eos_id)
        return ((token[:, None].to(torch.int32), score, finished, state),
                token.to(torch.int32))

    carry = (torch.full((batch_size, 1), bos_id, dtype=torch.int32,
                        device=device),
             torch.zeros((batch_size,), device=device),
             torch.zeros((batch_size,), dtype=torch.bool, device=device),
             init_state)
    paged = _resolve_kv_cache(kv_cache) == "paged"
    toks = []
    for t in range(max_len):
        carry, token = step(carry, t)
        toks.append(token)
        if paged:
            if on_step is not None:
                on_step(t, token)
            if bool(carry[2].all()):
                break
    # skipped steps are eos no-ops (token eos, zero added score)
    toks += [torch.full((batch_size,), eos_id, dtype=torch.int32,
                        device=device)] * (max_len - len(toks))
    return torch.stack(toks).permute(1, 0), carry[1]
