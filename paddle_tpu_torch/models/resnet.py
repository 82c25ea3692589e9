"""ResNet for ImageNet and CIFAR.

Counterpart of ``paddle_tpu/models/resnet.py``, function for function: the
same layers in the same order, so both packages build the same program
(op types, var names, startup ops).  NCHW, conv + batch-norm blocks;
``transpiler.nhwc_transpile`` moves the conv stack to NHWC.
"""

from __future__ import annotations

from paddle_tpu_torch import layers


def _conv_bn(x, num_filters, filter_size, stride=1, groups=1, act=None,
             is_test=False):
    conv = layers.conv2d(
        input=x, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        bias_attr=False)
    return layers.batch_norm(conv, act=act, is_test=is_test)


def _shortcut(x, ch_out, stride, is_test=False):
    ch_in = x.shape[1]
    if ch_in != ch_out or stride != 1:
        return _conv_bn(x, ch_out, 1, stride, is_test=is_test)
    return x


def _bottleneck(x, num_filters, stride, is_test=False):
    conv0 = _conv_bn(x, num_filters, 1, act="relu", is_test=is_test)
    conv1 = _conv_bn(conv0, num_filters, 3, stride, act="relu",
                     is_test=is_test)
    conv2 = _conv_bn(conv1, num_filters * 4, 1, is_test=is_test)
    short = _shortcut(x, num_filters * 4, stride, is_test=is_test)
    return layers.elementwise_add(short, conv2, act="relu")


def _basic_block(x, num_filters, stride, is_test=False):
    conv0 = _conv_bn(x, num_filters, 3, stride, act="relu",
                     is_test=is_test)
    conv1 = _conv_bn(conv0, num_filters, 3, is_test=is_test)
    short = _shortcut(x, num_filters, stride, is_test=is_test)
    return layers.elementwise_add(short, conv1, act="relu")


_DEPTH_CFG = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}


def resnet(depth=50, num_classes=1000, image_shape=(3, 224, 224),
           is_test=False, with_data_vars=True, image=None, label=None):
    block_type, counts = _DEPTH_CFG[depth]
    block = _bottleneck if block_type == "bottleneck" else _basic_block
    if image is None:
        image = layers.data("image", shape=list(image_shape),
                            dtype="float32")
    if label is None:
        label = layers.data("label", shape=[1], dtype="int64")
    x = _conv_bn(image, 64, 7, stride=2, act="relu", is_test=is_test)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    num_filters = [64, 128, 256, 512]
    for stage, count in enumerate(counts):
        for i in range(count):
            stride = 2 if i == 0 and stage > 0 else 1
            x = block(x, num_filters[stage], stride, is_test=is_test)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    logits = layers.fc(pool, size=num_classes)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return {"image": image, "label": label, "logits": logits,
            "loss": loss, "acc": acc}


def resnet50(**kwargs):
    return resnet(depth=50, **kwargs)


def resnet_cifar10(depth=32, num_classes=10, image_shape=(3, 32, 32),
                   is_test=False):
    """The classic CIFAR ResNet: 3x3/16ch stem, three stages of
    (depth-2)/6 basic blocks at widths 16/32/64 with strides 1/2/2,
    global average pool, fc head."""
    if (depth - 2) % 6 != 0:
        raise ValueError("cifar resnet depth must be 6n+2, got %d"
                         % depth)
    n = (depth - 2) // 6
    image = layers.data("image", shape=list(image_shape),
                        dtype="float32")
    label = layers.data("label", shape=[1], dtype="int64")
    x = _conv_bn(image, 16, 3, act="relu", is_test=is_test)
    for stage, width in enumerate((16, 32, 64)):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            x = _basic_block(x, width, stride, is_test=is_test)
    pool = layers.pool2d(x, pool_type="avg", global_pooling=True)
    logits = layers.fc(pool, size=num_classes)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return {"image": image, "label": label, "logits": logits,
            "loss": loss, "acc": acc}
