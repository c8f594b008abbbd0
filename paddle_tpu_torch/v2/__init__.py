"""paddle.v2-compatible API surface (reference: python/paddle/v2/__init__.py;
counterpart of ``paddle_tpu/v2``).

``import paddle_tpu_torch.v2 as paddle`` then the classic flow:

    paddle.init(use_gpu=False)
    images = paddle.layer.data(name="pixel", type=paddle.data_type.dense_vector(784))
    ...
    trainer = paddle.trainer.SGD(cost, parameters, paddle.optimizer.Momentum(...))
    trainer.train(paddle.batch(reader, 128), num_passes=5, event_handler=...)

``trainer.SGD`` and ``infer`` run on the card unless given
``place=CPUPlace()``.
"""
from __future__ import annotations

from . import activation  # noqa: F401
from . import attr  # noqa: F401
from . import data_type  # noqa: F401
from . import event  # noqa: F401
from . import image  # noqa: F401
from . import inference  # noqa: F401
from . import layer  # noqa: F401
from . import master  # noqa: F401
from . import minibatch  # noqa: F401
from . import networks  # noqa: F401
from . import optimizer  # noqa: F401
from . import parameters  # noqa: F401
from . import plot  # noqa: F401
from . import pooling  # noqa: F401
from . import topology  # noqa: F401
from . import trainer  # noqa: F401

from .. import dataset  # noqa: F401
from .. import reader  # noqa: F401
from ..reader.decorator import shuffle  # noqa: F401
from .minibatch import batch  # noqa: F401
from .inference import infer  # noqa: F401
from .topology import Topology  # noqa: F401

__all__ = [
    "master","init", "batch", "infer", "layer", "activation", "attr",
           "data_type", "event", "image", "inference", "minibatch",
           "networks", "optimizer", "parameters", "plot", "pooling",
           "topology", "trainer", "dataset", "reader", "shuffle",
           "Topology"]


def init(use_gpu=False, trainer_count=1, seed=None, **kwargs):
    """paddle.init parity: in the reference this boots the C++ runtime
    (gflags, devices).  Here it only seeds the default programs and
    chooses no device (``use_gpu`` is ignored): ``trainer.SGD`` and
    ``infer`` pick theirs from ``place``, the card by default."""
    if seed is not None:
        from ..core.program import default_main_program, default_startup_program
        default_main_program().random_seed = seed
        default_startup_program().random_seed = seed
