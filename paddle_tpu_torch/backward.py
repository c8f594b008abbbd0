"""Re-export of the autodiff program transform (counterpart of
``paddle_tpu/backward.py``, ``fluid.backward``)."""
from .core.backward import append_backward, calc_gradient  # noqa: F401

__all__ = ["append_backward", "calc_gradient"]
