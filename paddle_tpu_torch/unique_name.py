"""Unique name generation (counterpart of ``paddle_tpu/unique_name.py``;
the same names in the same order, so parameters such as ``fc_0.w_0`` and
its ``fc_0.w_0.moment1_0`` carry across)."""
from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self):
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        uid = self.ids[key]
        self.ids[key] += 1
        return f"{key}_{uid}"


generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return generator(key)


@contextlib.contextmanager
def guard(new_generator: UniqueNameGenerator | None = None):
    global generator
    old = generator
    generator = new_generator or UniqueNameGenerator()
    try:
        yield
    finally:
        generator = old
