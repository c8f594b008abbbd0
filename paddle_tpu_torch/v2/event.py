"""v2 training events (reference: python/paddle/v2/event.py).

The event-driven trainer fires these into the user's ``event_handler``.
"""
from __future__ import annotations

__all__ = [
    "BeginPass", "EndPass", "BeginIteration", "EndIteration",
    "EndForwardBackward", "TestResult", "WithMetric",
]


class WithMetric(object):
    def __init__(self, metrics=None):
        self._metrics = metrics or {}

    @property
    def metrics(self):
        return self._metrics


class TestResult(WithMetric):
    """Result of Trainer.test: mean cost + aggregated metrics."""

    def __init__(self, cost, metrics=None):
        super().__init__(metrics)
        self.cost = cost


class BeginPass(object):
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, metrics=None):
        super().__init__(metrics)
        self.pass_id = pass_id


class BeginIteration(object):
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndForwardBackward(object):
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, metrics=None):
        super().__init__(metrics)
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
