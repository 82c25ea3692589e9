"""VGG for ImageNet and CIFAR.

Counterpart of ``paddle_tpu/models/vgg.py``, function for function: the
same layers in the same order, so both packages build the same program.
Plain conv(3x3) + batch-norm stacks with a max pool between groups, two
fc-4096 heads (the second fc's batch norm takes the 2-D fc output), the
head's dropouts in inference form.  NCHW; ``transpiler.nhwc_transpile``
moves the conv stack to NHWC, as the bench does before ``bf16_transpile``.
"""

from __future__ import annotations

from paddle_tpu_torch import layers

_CFGS = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


def _conv_block(x, num_filter, groups, is_test=False):
    for _ in range(groups):
        x = layers.conv2d(x, num_filters=num_filter, filter_size=3,
                          stride=1, padding=1, bias_attr=False)
        x = layers.batch_norm(x, act="relu", is_test=is_test)
    return layers.pool2d(x, pool_size=2, pool_type="max", pool_stride=2)


def vgg(depth=16, class_dim=1000, img_shape=(3, 224, 224),
        is_test=False, with_head_dropout=True):
    """VGG-{11,13,16,19}; returns image/logits (+label/loss when
    training).  Training with the head's dropouts is not ported (the
    dropout layer refuses is_test=False)."""
    if depth not in _CFGS:
        raise ValueError(f"depth must be one of {sorted(_CFGS)}")
    groups = _CFGS[depth]
    widths = (64, 128, 256, 512, 512)
    image = layers.data(name="image", shape=list(img_shape),
                        dtype="float32")
    x = image
    for width, g in zip(widths, groups):
        x = _conv_block(x, width, g, is_test=is_test)
    if with_head_dropout:
        x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    x = layers.fc(x, size=4096, act=None, num_flatten_dims=1)
    x = layers.batch_norm(x, act="relu", is_test=is_test)
    if with_head_dropout:
        x = layers.dropout(x, dropout_prob=0.5, is_test=is_test)
    x = layers.fc(x, size=4096, act="relu")
    logits = layers.fc(x, size=class_dim)
    out = {"image": image, "logits": logits}
    if not is_test:
        label = layers.data(name="label", shape=[1], dtype="int64")
        loss = layers.mean(layers.softmax_with_cross_entropy(
            logits, label))
        out["label"] = label
        out["loss"] = loss
    return out


def vgg16(class_dim=1000, img_shape=(3, 224, 224), is_test=False):
    """The float16 benchmark's headline network."""
    return vgg(16, class_dim, img_shape, is_test=is_test)
