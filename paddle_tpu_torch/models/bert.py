"""BERT-base pretraining model built from the port's IR layers.

Counterpart of ``paddle_tpu/models/bert.py:17-102``: the embeddings (token,
position, sentence) and their layer norm, ``n_layer`` encoder layers of
the port's ``models/transformer.py`` (fused ``flash_attention``, not
causal), the masked-LM head (gelu fc, layer norm, an untied decoder to
the vocabulary, the masked positions gathered by a one-hot ``matmul``)
and the next-sentence head on the first position.  The same ops, attrs
and variable names as the JAX package's program, so parameters carry
across by name.  Dropout in training (``dropout_rate`` above 0 with
``is_test=False``) is not ported yet and raises.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch import layers
from paddle_tpu_torch.models.transformer import (
    _ffn,
    _residual_norm,
    multi_head_attention,
)


def bert_model(
    vocab_size=30522, max_len=512, d_model=768, n_head=12, d_inner=3072,
    n_layer=12, type_vocab_size=2, dropout_rate=0.1, is_test=False,
):
    """Returns the feed vars and the loss (MLM + NSP) with its parts."""
    if dropout_rate and not is_test:
        raise NotImplementedError(
            "dropout in training is not ported yet (ROADMAP Queue 1 item "
            "6): build with is_test=True or dropout_rate=0")
    src = layers.data("src_ids", shape=[max_len, 1], dtype="int64")
    pos = layers.data("pos_ids", shape=[max_len, 1], dtype="int64")
    sent = layers.data("sent_ids", shape=[max_len, 1], dtype="int64")
    mask_pos = layers.data("mask_pos", shape=[max_len, 1], dtype="int64")
    mask_label = layers.data("mask_label", shape=[max_len, 1],
                             dtype="int64")
    mask_weight = layers.data("mask_weight", shape=[max_len, 1],
                              dtype="float32")
    nsp_label = layers.data("nsp_label", shape=[1], dtype="int64")

    emb = layers.embedding(src, size=[vocab_size, d_model])
    pos_emb = layers.embedding(pos, size=[max_len, d_model])
    sent_emb = layers.embedding(sent, size=[type_vocab_size, d_model])
    x = layers.elementwise_add(
        layers.elementwise_add(emb, pos_emb), sent_emb)
    x = layers.layer_norm(x, begin_norm_axis=2)
    for _ in range(n_layer):
        attn = multi_head_attention(x, x, d_model=d_model, n_head=n_head,
                                    causal=False)
        x = _residual_norm(x, attn)
        x = _residual_norm(x, _ffn(x, d_model=d_model, d_inner=d_inner))

    # masked-LM head: the masked positions gathered per batch row
    mlm_h = layers.fc(x, d_model, num_flatten_dims=2, act="gelu")
    mlm_h = layers.layer_norm(mlm_h, begin_norm_axis=2)
    mlm_logits = layers.fc(mlm_h, vocab_size, num_flatten_dims=2,
                           bias_attr=False)
    mlm_sel = _gather_time(mlm_logits, mask_pos, max_len)
    mlm_loss_tok = layers.softmax_with_cross_entropy(mlm_sel, mask_label)
    weighted = layers.elementwise_mul(mlm_loss_tok, mask_weight)
    mlm_loss = layers.elementwise_div(
        layers.reduce_sum(weighted),
        layers.elementwise_add(layers.reduce_sum(mask_weight),
                               layers.fill_constant([], "float32", 1e-6)))

    # next-sentence head on the first position
    cls = layers.slice(x, axes=[1], starts=[0], ends=[1])
    cls = layers.reshape(cls, [-1, d_model])
    pooled = layers.fc(cls, d_model, act="tanh")
    nsp_logits = layers.fc(pooled, 2)
    nsp_loss = layers.mean(
        layers.softmax_with_cross_entropy(nsp_logits, nsp_label))

    loss = layers.elementwise_add(mlm_loss, nsp_loss)
    return {"src_ids": src, "pos_ids": pos, "sent_ids": sent,
            "mask_pos": mask_pos, "mask_label": mask_label,
            "mask_weight": mask_weight, "nsp_label": nsp_label,
            "loss": loss, "mlm_loss": mlm_loss, "nsp_loss": nsp_loss}


def _gather_time(x, idx, t):
    """x: [B, T, V]; idx: [B, T, 1] int64 positions -> [B, T, V], the rows
    of x at those positions: a one-hot [B, T, T] times x."""
    sel = layers.one_hot(idx, t)
    return layers.matmul(sel, x)


def bert_inputs_synthetic(batch, max_len=512, vocab_size=30522, seed=0):
    """The bench's feeds: random tokens and masked positions, the first
    ``max_len // 7`` positions of each row weighted 1."""
    rng = np.random.RandomState(seed)
    n_mask = max(1, max_len // 7)
    mask_weight = np.zeros((batch, max_len, 1), np.float32)
    mask_weight[:, :n_mask] = 1.0
    return {
        "src_ids": rng.randint(0, vocab_size,
                               (batch, max_len, 1)).astype(np.int64),
        "pos_ids": np.tile(np.arange(max_len)[None, :, None],
                           (batch, 1, 1)).astype(np.int64),
        "sent_ids": np.zeros((batch, max_len, 1), np.int64),
        "mask_pos": rng.randint(0, max_len,
                                (batch, max_len, 1)).astype(np.int64),
        "mask_label": rng.randint(0, vocab_size,
                                  (batch, max_len, 1)).astype(np.int64),
        "mask_weight": mask_weight,
        "nsp_label": rng.randint(0, 2, (batch, 1)).astype(np.int64),
    }
