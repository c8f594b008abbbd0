"""LeNet-5 for MNIST (counterpart of ``paddle_tpu/models/lenet.py``;
``benchmark/fluid/mnist.py`` cnn_model)."""
from __future__ import annotations

from .. import layers, nets


def lenet(img, label, class_num: int = 10):
    """img: [N, 1, 28, 28] (or [N, 784], reshaped); returns (avg_cost,
    accuracy, prediction)."""
    if img.shape and len(img.shape) == 2:
        img = layers.reshape(img, shape=[-1, 1, 28, 28])
    conv1 = nets.simple_img_conv_pool(img, filter_size=5, num_filters=20,
                                      pool_size=2, pool_stride=2, act="relu")
    conv2 = nets.simple_img_conv_pool(conv1, filter_size=5, num_filters=50,
                                      pool_size=2, pool_stride=2, act="relu")
    prediction = layers.fc(input=conv2, size=class_num, act="softmax")
    avg_cost = layers.mean(layers.cross_entropy(input=prediction,
                                                label=label))
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction
