"""v2 activation namespace (reference: python/paddle/v2/activation.py —
re-exports v1 activations under their stem names: TanhActivation → Tanh)."""
from __future__ import annotations

from ..trainer_config_helpers import activations as _acts

__all__ = []

for _name in _acts.__all__:
    if _name == "BaseActivation":
        continue
    _new = _name[:-len("Activation")] if _name.endswith("Activation") else _name
    globals()[_new] = getattr(_acts, _name)
    __all__.append(_new)
