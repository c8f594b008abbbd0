"""``FLAGS_*`` environment bootstrap (counterpart of ``paddle_tpu/flags.py``).

The same table as the JAX package's: names, parsers, defaults and
aliases, each read from ``FLAGS_<name>`` in the environment at import,
so a launcher written for either package (``FLAGS_check_nan_inf=1
python train.py``) keeps working.  Flags are plain Python state consulted
by the executor, the program and the fault injector.

What each flag gates in the port:

- ``check_nan_inf``: default of ``Executor.check_nan_inf`` (every float
  op output is poisoned when not finite, and ``run`` / the ``train_loop``
  window sync raise `NonFiniteError`);
- ``benchmark``: ``Executor.run`` synchronizes the card before it
  returns, so wall-clock timers measure finished device work;
- ``amp``: default of ``Program.amp``;
- ``fault_points``: the spec `fault` arms at import.

Flags without effect in the port (accepted so launchers keep parsing;
ROADMAP queue C lists them):

- ``use_pinned_memory``: `DataFeeder` hands back host arrays; pinned
  staging is ``reader.device_prefetch``'s;
- ``fraction_of_tpu_memory_to_use`` (alias
  ``fraction_of_gpu_memory_to_use``): the port leaves the caching
  allocator's limit alone;
- ``eager_delete_scope``: op temporaries never enter the Scope;
- ``cudnn_algo_use_autotune``: cuDNN picks its algorithms itself;
- ``scan_unroll`` and ``dynrnn_hoist``: the DynamicRNN runs its step
  block eagerly, one step at a time;
- ``bn_onepass_bwd``: the BatchNorm backward on the card is always the
  port's kernel;
- ``paged_attention``: paged attention on the card is always the port's
  kernel.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Sequence


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


class _FlagRegistry:
    def __init__(self):
        self._defs: Dict[str, tuple] = {}   # name -> (parser, default, doc, aliases)
        self._values: Dict[str, Any] = {}

    def define(self, name: str, parser: Callable[[str], Any], default: Any,
               doc: str, aliases: Sequence[str] = ()) -> None:
        self._defs[name] = (parser, default, doc, tuple(aliases))
        self._values[name] = default

    def __getattr__(self, name: str) -> Any:
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(f"unknown flag {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        elif name in self._defs:
            self._values[name] = value
        else:
            raise AttributeError(f"unknown flag {name!r}")

    def names(self):
        return sorted(self._defs)

    def refresh_from_env(self) -> None:
        """Read ``FLAGS_<name>`` (or an alias) for every flag."""
        for name, (parser, _default, _doc, aliases) in self._defs.items():
            for key in (name,) + aliases:
                raw = os.environ.get("FLAGS_" + key)
                if raw is not None:
                    self._values[name] = parser(raw)
                    break


FLAGS = _FlagRegistry()

FLAGS.define("check_nan_inf", _parse_bool, False,
             "poison non-finite op outputs and raise NonFiniteError")
FLAGS.define("benchmark", _parse_bool, False,
             "Executor.run synchronizes the card before it returns")
FLAGS.define("use_pinned_memory", _parse_bool, False,
             "accepted; no effect in the port")
FLAGS.define("fraction_of_tpu_memory_to_use", float, 0.0,
             "accepted; no effect in the port",
             aliases=("fraction_of_gpu_memory_to_use",))
FLAGS.define("amp", _parse_bool, False,
             "default Program.amp (bf16-activation mixed precision)")
FLAGS.define("eager_delete_scope", _parse_bool, True,
             "accepted; temporaries never enter the Scope")
FLAGS.define("cudnn_algo_use_autotune", _parse_bool, True,
             "accepted; no effect in the port")
FLAGS.define("scan_unroll", int, 4, "accepted; no effect in the port")
FLAGS.define("dynrnn_hoist", str, "auto", "accepted; no effect in the port")
FLAGS.define("fault_points", str, "",
             "deterministic fault-injection spec (paddle_tpu_torch.fault): "
             "comma list of point[@n][:exit|raise|drop] kill points")
FLAGS.define("bn_onepass_bwd", _parse_bool, False,
             "accepted; no effect in the port")
FLAGS.define("paged_attention", str, "1", "accepted; no effect in the port")

FLAGS.refresh_from_env()
