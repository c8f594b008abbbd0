"""v2 Topology (reference: python/paddle/v2/topology.py).

Wraps the output LayerOutputs of a network; knows its data layers and can
lower itself into a Program (the reference serializes a ModelConfig proto
instead — our "proto" is the serialized Program IR).
"""
from __future__ import annotations

from collections import OrderedDict

from ..trainer_config_helpers.layers import LayerOutput

__all__ = ["Topology"]


class Topology(object):
    def __init__(self, layers, extra_layers=None):
        if isinstance(layers, LayerOutput):
            layers = [layers]
        if extra_layers is not None and isinstance(extra_layers, LayerOutput):
            extra_layers = [extra_layers]
        self.layers = list(layers)
        self.extra_layers = list(extra_layers or [])

    def _walk(self):
        seen, order = set(), []

        def visit(node):
            if id(node) in seen:
                return
            seen.add(id(node))
            for p in node.parents:
                visit(p)
            order.append(node)

        for out in self.layers + self.extra_layers:
            visit(out)
        return order

    def data_layers(self):
        """OrderedDict name → data LayerOutput, in dependency order."""
        out = OrderedDict()
        for node in self._walk():
            if node.layer_type == "data":
                out[node.name] = node
        return out

    def data_type(self):
        """[(name, InputType-ish)] for every data layer (reference order)."""
        result = []
        for name, node in self.data_layers().items():
            result.append((name, node.extra.get("spec")))
        return result

    def proto(self):
        """Serialized Program for these outputs (ModelConfig analog)."""
        from ..core.program import Program
        from .. import core
        prog = Program()
        startup = Program()
        from ..core.program import program_guard
        from ..trainer_config_helpers.layers import parse_network
        with program_guard(prog, startup):
            parse_network(*(self.layers + self.extra_layers))
        return prog.to_string()
