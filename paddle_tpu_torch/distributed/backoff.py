"""Bounded exponential backoff with deterministic jitter (counterpart
of ``paddle_tpu/distributed/backoff.py``).

Delays grow ``base * factor**n`` up to ``cap``, each scaled by a jitter
factor drawn from a seeded PRNG, so two clients with different seeds
desynchronize while each schedule stays reproducible for tests.
"""
from __future__ import annotations

import random
import time
import zlib
from typing import Optional

__all__ = ["Backoff"]


class Backoff:
    """One retry schedule.  ``next_delay()`` advances it; ``reset()``
    snaps back to ``base`` after a success."""

    def __init__(self, base: float = 0.05, cap: float = 2.0,
                 factor: float = 2.0, jitter: float = 0.5,
                 seed: Optional[object] = None):
        if not (0.0 <= jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1], got {jitter}")
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        # strings (worker ids) seed via crc32 so the schedule is stable
        # across processes and python hash randomization
        if isinstance(seed, str):
            seed = zlib.crc32(seed.encode())
        self._rng = random.Random(seed)
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt

    def reset(self):
        self._attempt = 0

    def next_delay(self) -> float:
        """Delay for the next retry: min(cap, base*factor^n), scaled into
        [1-jitter, 1] — full delay never exceeded, herd desynchronized."""
        raw = min(self.cap, self.base * (self.factor ** self._attempt))
        self._attempt += 1
        scale = 1.0 - self.jitter * self._rng.random()
        return raw * scale

    def sleep(self) -> float:
        d = self.next_delay()
        time.sleep(d)
        return d

    def next_deadline(self, now: Optional[float] = None) -> float:
        """The ``time.monotonic`` instant of the next allowed attempt:
        the non-blocking companion of ``sleep()``."""
        return (time.monotonic() if now is None else now) + self.next_delay()
