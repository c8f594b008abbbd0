"""Data-source config (parity: trainer_config_helpers/data_sources.py
define_py_data_sources2:158 — bind @provider objects to the trainer).

The reference stores module/obj names in the TrainerConfig proto for the
C++ trainer to import; here the binding is a registry the v2 trainer (or
any caller) reads back to obtain live DataProvider sample sources.
"""
from __future__ import annotations

import importlib
from typing import Optional

_SOURCES = {}


def define_py_data_sources2(train_list, test_list, module, obj, args=None):
    """Register train/test providers.

    train_list/test_list: file-list path (a text file of data paths) or a
    list of paths or None.  module/obj: the python module and @provider
    name — or `obj` may be the DataProvider object itself.
    """
    def resolve(o):
        if isinstance(o, str):
            m = (importlib.import_module(module) if isinstance(module, str)
                 else module)
            return getattr(m, o)
        return o

    def files(lst):
        if lst is None:
            return []
        if isinstance(lst, (list, tuple)):
            return list(lst)
        with open(lst) as f:
            return [ln.strip() for ln in f if ln.strip()]

    dp = resolve(obj)
    _SOURCES["train"] = (dp, files(train_list), args or {})
    if test_list is not None:
        _SOURCES["test"] = (dp, files(test_list), args or {})
    else:
        _SOURCES.pop("test", None)   # no stale entry from a prior config
    return dict(_SOURCES)


def get_data_source(which: str = "train") -> Optional[tuple]:
    """(provider, file_list, args) registered for 'train'/'test'."""
    return _SOURCES.get(which)


def clear_data_sources():
    _SOURCES.clear()
