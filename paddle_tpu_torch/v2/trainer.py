"""v2 event-driven trainer (reference: python/paddle/v2/trainer.py SGD:37;
counterpart of ``paddle_tpu/v2/trainer.py``).

The reference loop calls ``gradient_machine.forwardBackward`` per batch and
updates each parameter through a ParameterUpdater (local or pserver-remote).
Here the whole topology + backward + optimizer-update lowers into one
Program, which the port's Executor runs as one step a batch; events fire
around it unchanged.  Each step's cost comes back to the host (one sync a
batch), as ``EndIteration.cost`` is a float.

``SGD(place=None)`` trains on the card (``CUDAPlace(0)``) and raises where
CUDA is absent; pass ``place=CPUPlace()`` to train on the host.
"""
from __future__ import annotations

import numpy as np

from . import event as v2_event
from .topology import Topology
from .parameters import Parameters
from ..core.program import Program, program_guard
from ..core.scope import Scope
from ..core.executor import Executor
from ..core.place import CUDAPlace
from ..data_feeder import DataFeeder
from ..trainer_config_helpers.layers import parse_network

__all__ = ["SGD"]


def default_event_handler(event):
    pass


class SGD(object):
    """paddle.v2.trainer.SGD — train(reader, num_passes, event_handler)."""

    def __init__(self, cost, parameters, update_equation, extra_layers=None,
                 is_local=True, update_equation_kwargs=None, place=None):
        if not isinstance(parameters, Parameters):
            raise TypeError("parameters must be v2.parameters.Parameters")
        self._topology = Topology(cost, extra_layers)
        self._parameters = parameters

        self._prog, self._startup = Program(), Program()
        with program_guard(self._prog, self._startup):
            outs = parse_network(*(self._topology.layers +
                                   self._topology.extra_layers))
        self._cost_var = outs[0]
        self._metric_vars = outs[1:]
        # test program = forward only, frozen before update ops are added
        self._test_prog = self._prog.clone(for_test=True)
        with program_guard(self._prog, self._startup):
            update_equation.to_fluid().minimize(self._cost_var)

        self._scope = Scope()
        self._exe = Executor(place if place is not None else CUDAPlace(0))
        self._exe.run(self._startup, scope=self._scope)
        # push any user-preloaded values (from_tar etc.), then hand the
        # parameters object a live view of the scope
        self._parameters.attach_scope(self._scope, self._exe.device)

        feed_names = list(self._topology.data_layers().keys())
        block = self._prog.global_block()
        self._feed_vars = [block.var(n) for n in feed_names]
        self._feed_names = feed_names

    # ------------------------------------------------------------------
    def _feeder(self, feeding):
        if feeding is None:
            order = list(range(len(self._feed_names)))
        else:
            order = [feeding[name] for name in self._feed_names]
        feeder = DataFeeder(feed_list=self._feed_vars)

        def make_feed(batch):
            rows = [[sample[i] for i in order] for sample in batch]
            return feeder.feed(rows)

        return make_feed

    def train(self, reader, num_passes=1, event_handler=None, feeding=None):
        """Reader yields BATCHES of samples (wrap with paddle.batch)."""
        if event_handler is None:
            event_handler = default_event_handler
        make_feed = self._feeder(feeding)
        fetch = [self._cost_var] + self._metric_vars
        metric_names = [m.name for m in self._metric_vars]

        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))
            for batch_id, batch in enumerate(reader()):
                event_handler(v2_event.BeginIteration(pass_id, batch_id))
                results = self._exe.run(self._prog, feed=make_feed(batch),
                                        fetch_list=fetch, scope=self._scope)
                event_handler(v2_event.EndForwardBackward(pass_id, batch_id))
                cost = float(np.asarray(results[0]))
                metrics = {n: np.asarray(v)
                           for n, v in zip(metric_names, results[1:])}
                event_handler(v2_event.EndIteration(pass_id, batch_id, cost,
                                                    metrics))
            event_handler(v2_event.EndPass(pass_id))

    def test(self, reader, feeding=None):
        make_feed = self._feeder(feeding)
        fetch = [self._cost_var] + self._metric_vars
        metric_names = [m.name for m in self._metric_vars]
        costs, n, metrics = 0.0, 0, {}
        for batch in reader():
            results = self._exe.run(self._test_prog, feed=make_feed(batch),
                                    fetch_list=fetch, scope=self._scope)
            costs += float(np.asarray(results[0])) * len(batch)
            n += len(batch)
            for name, v in zip(metric_names, results[1:]):
                metrics[name] = np.asarray(v)
        return v2_event.TestResult(cost=costs / max(n, 1), metrics=metrics)

    def save_parameter_to_tar(self, f):
        self._parameters.to_tar(f)
