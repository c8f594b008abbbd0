"""ResNet for ImageNet/CIFAR (counterpart of ``paddle_tpu/models/resnet.py``:
the same bottleneck/basicblock structure, layer for layer, so the two
packages build the same program).

data_format="NHWC" keeps activations channels-last end to end: the
convolutions read them in cuDNN's channels_last format without copies,
and each BatchNorm sees a contiguous [N*H*W, C] view.  Filter and
BatchNorm parameters are layout-independent.
"""
from __future__ import annotations

from .. import layers


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False, data_format="NCHW"):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False,
                         data_format=data_format)
    return layers.batch_norm(input=conv, act=act, is_test=is_test,
                             data_layout=data_format)


def _shortcut(input, ch_out, stride, is_test=False, data_format="NCHW"):
    ch_in = (input.shape[-1] if data_format.endswith("C")
             else input.shape[1])
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test, data_format=data_format)
    return input


def basicblock(input, ch_out, stride, is_test=False, data_format="NCHW"):
    short = _shortcut(input, ch_out, stride, is_test, data_format)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test,
                          data_format=data_format)
    return layers.elementwise_add(short, conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False, data_format="NCHW"):
    short = _shortcut(input, ch_out * 4, stride, is_test, data_format)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test,
                          data_format=data_format)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test, data_format=data_format)
    return layers.elementwise_add(short, conv3, act="relu")


def _layer_warp(block_func, input, ch_out, count, stride, is_test=False,
                data_format="NCHW"):
    res_out = block_func(input, ch_out, stride, is_test, data_format)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test, data_format)
    return res_out


_IMAGENET_DEPTHS = {
    18: (basicblock, [2, 2, 2, 2]),
    34: (basicblock, [3, 4, 6, 3]),
    50: (bottleneck, [3, 4, 6, 3]),
    101: (bottleneck, [3, 4, 23, 3]),
    152: (bottleneck, [3, 8, 36, 3]),
}


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False,
                    data_format="NCHW"):
    """benchmark/fluid/resnet.py resnet_imagenet parity."""
    block_func, stages = _IMAGENET_DEPTHS[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_test=is_test,
                          data_format=data_format)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                          pool_stride=2, pool_padding=1,
                          data_format=data_format)
    res = pool1
    for i, count in enumerate(stages):
        stride = 1 if i == 0 else 2
        res = _layer_warp(block_func, res, 64 * (2 ** i), count, stride,
                          is_test, data_format)
    pool2 = layers.pool2d(input=res, pool_size=7, pool_type="avg",
                          global_pooling=True, data_format=data_format)
    out = layers.fc(input=pool2, size=class_dim, act="softmax")
    return out


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False,
                   data_format="NCHW"):
    """benchmark/fluid/resnet.py resnet_cifar10 parity (6n+2 layers)."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test,
                          data_format=data_format)
    res1 = _layer_warp(basicblock, conv1, 16, n, 1, is_test, data_format)
    res2 = _layer_warp(basicblock, res1, 32, n, 2, is_test, data_format)
    res3 = _layer_warp(basicblock, res2, 64, n, 2, is_test, data_format)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         global_pooling=True, data_format=data_format)
    out = layers.fc(input=pool, size=class_dim, act="softmax")
    return out


def resnet_train_program(batch_size=None, depth=50, class_dim=1000,
                         image_shape=(3, 224, 224), lr=0.01,
                         optimizer="momentum", data_format="NCHW"):
    """Build (avg_cost, acc) training graph on fresh data vars.

    With data_format NHWC, `image_shape` (and the fed arrays) are
    [H, W, C]."""
    from .. import optimizer as opt_mod
    img = layers.data(name="data", shape=list(image_shape), dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    predict = resnet_imagenet(img, class_dim=class_dim, depth=depth,
                              data_format=data_format)
    cost = layers.cross_entropy(input=predict, label=label)
    avg_cost = layers.mean(cost)
    acc = layers.accuracy(input=predict, label=label)
    if optimizer == "momentum":
        opt = opt_mod.Momentum(learning_rate=lr, momentum=0.9)
    else:
        opt = opt_mod.SGD(learning_rate=lr)
    opt.minimize(avg_cost)
    return img, label, avg_cost, acc
