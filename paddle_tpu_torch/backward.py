"""Re-export of the autodiff program transform (counterpart of
``paddle_tpu/backward.py``, ``fluid.backward``).  ``calc_gradient`` waits
for the sparse branches."""
from .core.backward import append_backward  # noqa: F401

__all__ = ["append_backward"]
