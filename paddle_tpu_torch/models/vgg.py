"""VGG-16 with BatchNorm and dropout (counterpart of
``paddle_tpu/models/vgg.py``; ``benchmark/fluid/vgg.py``
vgg16_bn_drop)."""
from __future__ import annotations

from .. import layers, nets


def vgg16_bn_drop(input, class_dim=1000, is_test=False):
    """Five conv groups (64, 128, 256, 512, 512 filters; 2, 2, 3, 3, 3
    convs), each conv followed by batch_norm with relu and, but for a
    group's last, by dropout; then dropout, fc 512, batch_norm relu,
    dropout, fc 512 and the softmax classifier.  Returns the
    prediction."""
    def conv_block(ipt, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", is_test=is_test)
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return layers.fc(input=fc2, size=class_dim, act="softmax")
