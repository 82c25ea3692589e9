"""DeepFM CTR model built from the port's IR layers.

Counterpart of ``paddle_tpu/models/deepfm.py``: one embedding table
shared by the fields, first-order terms from a second table of width 1,
the factorisation machine's second-order term ``0.5 * ((sum v)^2 - sum
v^2)``, and an MLP over the flattened embeddings and the dense features;
the sigmoid of their sum is the click probability.  The same ops, attrs
and variable names as the JAX package's program.  ``is_sparse`` is an
attr of the lookups: the JAX package densifies a sparse grad before the
optimizer (``paddle_tpu/ops/optim.py:24-27``), and the port's grads are
dense, so both values train alike.  ``is_distributed`` marks the tables
for parameter-server sharding, which is not ported (ROADMAP Queue 1 item
5): on one card it is an attr and nothing reads it.
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch import layers


def deepfm_model(num_fields=26, vocab_size=100_000, embed_dim=16,
                 dense_dim=13, hidden=(400, 400, 400), is_test=False,
                 is_sparse=True, is_distributed=False):
    """Returns the feed vars, the click probability and the mean loss."""
    sparse_ids = layers.data("sparse_ids", shape=[num_fields, 1],
                             dtype="int64")
    dense_x = layers.data("dense_x", shape=[dense_dim], dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")

    # the shared table; field-wise lookup [B, F, E]
    emb = layers.embedding(sparse_ids, size=[vocab_size, embed_dim],
                           is_sparse=is_sparse,
                           is_distributed=is_distributed)

    # first-order terms
    first = layers.embedding(sparse_ids, size=[vocab_size, 1],
                             is_sparse=is_sparse,
                             is_distributed=is_distributed)
    first_sum = layers.reduce_sum(first, dim=[1, 2], keep_dim=False)
    first_sum = layers.reshape(first_sum, [-1, 1])

    # second order: 0.5 * ((sum v)^2 - sum v^2)
    sum_emb = layers.reduce_sum(emb, dim=[1])            # [B, E]
    sum_sq = layers.square(sum_emb)
    sq_emb = layers.square(emb)
    sq_sum = layers.reduce_sum(sq_emb, dim=[1])
    fm = layers.scale(layers.elementwise_sub(sum_sq, sq_sum), scale=0.5)
    fm = layers.reduce_sum(fm, dim=[1], keep_dim=True)   # [B, 1]

    # the deep part
    deep_in = layers.concat(
        [layers.reshape(emb, [-1, num_fields * embed_dim]), dense_x],
        axis=1)
    h = deep_in
    for width in hidden:
        h = layers.fc(h, size=width, act="relu")
    deep_out = layers.fc(h, size=1)

    logits = layers.elementwise_add(
        layers.elementwise_add(first_sum, fm), deep_out)
    predict = layers.sigmoid(logits)
    loss = layers.mean(layers.sigmoid_cross_entropy_with_logits(
        logits, layers.cast(label, "float32")))
    return {"sparse_ids": sparse_ids, "dense_x": dense_x, "label": label,
            "predict": predict, "loss": loss}


def deepfm_inputs_synthetic(batch, num_fields=26, vocab_size=100_000,
                            dense_dim=13, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "sparse_ids": rng.randint(
            0, vocab_size, (batch, num_fields, 1)).astype(np.int64),
        "dense_x": rng.rand(batch, dense_dim).astype(np.float32),
        "label": rng.randint(0, 2, (batch, 1)).astype(np.int64),
    }
