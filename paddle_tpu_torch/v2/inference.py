"""v2 inference (reference: python/paddle/v2/inference.py; counterpart of
``paddle_tpu/v2/inference.py``).

``Inference(place=None)`` and ``infer(place=None)`` run on the card
(``CUDAPlace(0)``) and raise where CUDA is absent; pass
``place=CPUPlace()`` to run on the host.
"""
from __future__ import annotations

import numpy as np

from .topology import Topology
from ..core.program import Program, program_guard
from ..core.scope import Scope
from ..core.executor import Executor
from ..core.place import CUDAPlace
from ..data_feeder import DataFeeder
from ..trainer_config_helpers.layers import parse_network

__all__ = ["Inference", "infer"]


class Inference(object):
    def __init__(self, output_layer, parameters, place=None):
        self._topology = Topology(output_layer)
        self._prog, self._startup = Program(), Program()
        with program_guard(self._prog, self._startup):
            self._out_vars = parse_network(*self._topology.layers)
        self._scope = Scope()
        self._exe = Executor(place if place is not None else CUDAPlace(0))
        self._exe.run(self._startup, scope=self._scope)
        parameters.attach_scope(self._scope, self._exe.device)
        feed_names = list(self._topology.data_layers().keys())
        block = self._prog.global_block()
        self._feed_vars = [block.var(n) for n in feed_names]
        self._feed_names = feed_names

    def iter_infer_field(self, field, input, feeding=None):
        if feeding is None:
            order = list(range(len(self._feed_names)))
        else:
            order = [feeding[name] for name in self._feed_names]
        feeder = DataFeeder(feed_list=self._feed_vars)
        rows = [[sample[i] for i in order] for sample in input]
        results = self._exe.run(self._prog, feed=feeder.feed(rows),
                                fetch_list=self._out_vars,
                                scope=self._scope)
        yield [np.asarray(r) for r in results]

    def infer(self, input, field="value", feeding=None):
        outs = None
        for res in self.iter_infer_field(field, input, feeding):
            outs = res
        if outs is None:
            return None
        return outs[0] if len(outs) == 1 else outs


def infer(output_layer, parameters, input, feeding=None, field="value",
          place=None):
    """One-shot inference over a list of samples (reference infer())."""
    return Inference(output_layer, parameters, place).infer(
        input, field=field, feeding=feeding)
