"""Transformer LM built from the port's IR layers.

Counterpart of ``paddle_tpu/models/transformer.py`` (``:18-208``,
``:265-268``): ``transformer_encoder_model`` emits the same ops and the
same parameter names as the JAX package, so parameters carry across by
name.  Attention is the fused ``flash_attention`` op.  With
``dropout_rate=0.0`` the training graph (``is_test=False``) is the same
as the test graph, and ``optimizer.Adam(lr).minimize(loss)`` trains it.
Dropout (``is_test=False`` with a nonzero ``dropout_rate``) and label
smoothing are not ported yet and raise.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch import layers
from paddle_tpu_torch.param_attr import ParamAttr as _ParamAttr


def _w(pfx, part):
    """Deterministic weight name under a prefix (None -> auto names)."""
    return _ParamAttr(name=f"{pfx}_{part}.w") if pfx else None


def _b(pfx, part):
    return _ParamAttr(name=f"{pfx}_{part}.b") if pfx else None


def _sub(pfx):
    """_sub("tfm")("l0") -> "tfm_l0"; a None prefix propagates None."""
    return (lambda s: f"{pfx}_{s}") if pfx else (lambda s: None)


def _positional_encoding(max_len, d_model, dtype="float32"):
    pos = np.arange(max_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    enc = np.zeros((max_len, d_model), np.float64)
    enc[:, 0::2] = np.sin(angle[:, 0::2])
    enc[:, 1::2] = np.cos(angle[:, 1::2])
    return enc.astype(dtype)


def _split_heads(x, t, n_head, head_dim):
    x = layers.reshape(x, [-1, t, n_head, head_dim])
    return layers.transpose(x, [0, 2, 1, 3])          # [B, H, T, hd]


def multi_head_attention(q_in, kv_in, d_model, n_head, causal=False,
                         pfx=None):
    """q_in: [B, Tq, D]; kv_in: [B, Tk, D] -> [B, Tq, D] through one
    fused ``flash_attention`` op."""
    tq = q_in.shape[1]
    tk = kv_in.shape[1]
    head_dim = d_model // n_head
    q = layers.fc(q_in, d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=_w(pfx, "q"))
    k = layers.fc(kv_in, d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=_w(pfx, "k"))
    v = layers.fc(kv_in, d_model, num_flatten_dims=2, bias_attr=False,
                  param_attr=_w(pfx, "v"))
    q = _split_heads(q, tq, n_head, head_dim)
    k = _split_heads(k, tk, n_head, head_dim)
    v = _split_heads(v, tk, n_head, head_dim)
    out = layers.flash_attention(q, k, v, causal=causal)
    out = layers.transpose(out, [0, 2, 1, 3])
    out = layers.reshape(out, [-1, tq, d_model])
    return layers.fc(out, d_model, num_flatten_dims=2, bias_attr=False,
                     param_attr=_w(pfx, "out"))


def _ffn(x, d_model, d_inner, pfx=None):
    h = layers.fc(x, d_inner, num_flatten_dims=2, act="relu",
                  param_attr=_w(pfx, "fc1"), bias_attr=_b(pfx, "fc1"))
    return layers.fc(h, d_model, num_flatten_dims=2,
                     param_attr=_w(pfx, "fc2"), bias_attr=_b(pfx, "fc2"))


def _residual_norm(x, sub, pfx=None):
    return layers.layer_norm(
        layers.elementwise_add(x, sub), begin_norm_axis=2,
        param_attr=(_ParamAttr(name=f"{pfx}.scale") if pfx else None),
        bias_attr=(_ParamAttr(name=f"{pfx}.bias") if pfx else None))


def _embed(ids, vocab_size, d_model, max_len, pfx=None):
    emb = layers.embedding(
        ids, size=[vocab_size, d_model],
        param_attr=(_ParamAttr(name=f"{pfx}.w") if pfx else None))
    emb = layers.scale(emb, scale=float(d_model) ** 0.5)
    pe = layers.assign(_positional_encoding(max_len, d_model)[None, :, :])
    return layers.elementwise_add(emb, pe)


def transformer_encoder_model(
    vocab_size=32000, max_len=256, d_model=512, n_head=8, d_inner=2048,
    n_layer=6, dropout_rate=0.1, is_test=False, tie_embeddings=False,
    label_smooth_eps=0.0, param_prefix=None,
):
    """Encoder-only causal LM over one token stream.  Returns the feed
    vars, the logits and the mean next-token loss."""
    if dropout_rate and not is_test:
        raise NotImplementedError(
            "dropout is not ported yet: build with is_test=True or "
            "dropout_rate=0")
    if label_smooth_eps:
        raise NotImplementedError("label smoothing is not ported yet")
    p = param_prefix
    sp = _sub(p)
    src = layers.data("src_ids", shape=[max_len, 1], dtype="int64")
    label = layers.data("tgt_label", shape=[max_len, 1], dtype="int64")
    x = _embed(src, vocab_size, d_model, max_len, pfx=sp("emb"))
    for li in range(n_layer):
        lp = _sub(sp(f"l{li}"))
        attn = multi_head_attention(x, x, d_model, n_head, causal=True,
                                    pfx=lp("self"))
        x = _residual_norm(x, attn, pfx=lp("ln1"))
        ffn = _ffn(x, d_model, d_inner, pfx=lp("ffn"))
        x = _residual_norm(x, ffn, pfx=lp("ln2"))
    logits = layers.fc(x, vocab_size, num_flatten_dims=2, bias_attr=False,
                       param_attr=_w(p, "out_fc"))
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    return {"src_ids": src, "tgt_label": label, "logits": logits,
            "loss": loss}
