"""Logical-axis rule tables (counterpart of
``paddle_tpu/parallel/logical_axes.py``; the T5X ``logical_axis_rules``
idiom).

A `LogicalAxisRules` table decides placement in two steps:

1. **Param rules** map ``(name, shape)`` to a tuple of *logical* axis
   names, one per dim: ``("embed", "mlp")`` for an FFN input projection,
   ``("mlp", "embed")`` for its output projection.
2. **Axis rules** map each logical axis to a mesh axis (or None =
   replicated): ``("batch", "dp"), ("mlp", "tp"), ("embed", None)``.

The same table resolves the ``sharding_constraint`` ops the layers put
on activations (`Partitioner.activation_spec`).  ``dp_default()`` is
plain data parallelism: batch over ``dp``, every parameter replicated.
``transformer_tp_rules`` is the Megatron layout of the transformer
family (qkv and FFN-in column-sharded, FFN-out row-sharded, the LM head
vocab-sharded); `layers.fc` names its parameters generically
(``fc_N.w_0``), so the param rules match on shapes built from the
model's sizes.  `PartitionSpec` is the port's own tuple type.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Optional, Sequence, Tuple



class PartitionSpec(tuple):
    """The port's placement of one array: per dim an axis name, a tuple
    of axis names, or None (that dim is whole).  A tuple, as the JAX
    ``PartitionSpec`` is, and printed as it prints."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self) if self else '()'}"

    __str__ = __repr__

    def __reduce__(self):
        return (PartitionSpec, tuple(self))


__all__ = ["LogicalAxisRules", "PartitionSpec", "transformer_tp_rules"]


def _shape_key(name: str, shape: Sequence[int]) -> str:
    """The string param rules match against: ``"fc_0.w_0:64x192"``."""
    return f"{name}:{'x'.join(str(int(d)) for d in shape)}"


class LogicalAxisRules:
    """An ordered, fingerprintable logical-axis rule table.

    ``axis_rules``  — ordered ``(logical_axis, mesh_axis_or_None)``
                      pairs; first match wins (the T5X contract).
    ``param_rules`` — ordered ``(pattern, logical_axes)`` pairs.  The
                      pattern is a regex **fullmatch**ed against
                      ``"name:D0xD1x..."`` — so rules can key on the
                      name, the shape, or both; first match whose axes
                      tuple has the parameter's rank wins.  Entries in
                      ``logical_axes`` are logical axis names or None
                      (that dim never shards).
    ``name``        — table identity for compile-cache keys; two
                      distinct tables must not share a name AND equal
                      rule tuples (``fingerprint()`` covers both).

    The instance is itself usable wherever a ``param_spec`` rule is
    accepted (`Partitioner(param_spec=rules)`, `train_loop`,
    `ShardedPredictor`) — the partitioner detects the table and also
    adopts it for activation-constraint resolution.
    """

    def __init__(self, axis_rules: Iterable[Tuple[str, Optional[str]]] = (),
                 param_rules: Iterable[Tuple[str, Sequence[Optional[str]]]]
                 = (), name: str = "logical_axes"):
        self.axis_rules: Tuple[Tuple[str, Optional[str]], ...] = tuple(
            (str(l), None if m is None else str(m)) for l, m in axis_rules)
        self.param_rules: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] \
            = tuple((str(pat),
                     tuple(None if a is None else str(a) for a in axes))
                    for pat, axes in param_rules)
        self.name = str(name)
        self._compiled = [(re.compile(pat), axes)
                          for pat, axes in self.param_rules]
        self._axis_map: Dict[str, Optional[str]] = {}
        for logical, mesh_axis in self.axis_rules:
            self._axis_map.setdefault(logical, mesh_axis)  # first wins

    # -- resolution ----------------------------------------------------
    def mesh_axis(self, logical: Optional[str]) -> Optional[str]:
        """One logical axis -> its mesh axis (None = replicated).  An
        axis the table does not name replicates — the safe default."""
        if logical is None:
            return None
        return self._axis_map.get(str(logical))

    def logical_to_mesh(self, logical_axes: Sequence[Optional[str]]
                        ) -> PartitionSpec:
        """A per-dim logical-axes tuple -> `PartitionSpec`."""
        return PartitionSpec(
            *[self.mesh_axis(a) for a in logical_axes])

    def param_axes(self, name: str, shape: Sequence[int]
                   ) -> Optional[Tuple[Optional[str], ...]]:
        """First param rule matching ``name:shape`` at the right rank,
        or None (a rule miss — the caller replicates and warns)."""
        key = _shape_key(name, shape)
        for pat, axes in self._compiled:
            if len(axes) == len(shape) and pat.fullmatch(key):
                return axes
        return None

    def param_rule(self, name: str, shape: Sequence[int]
                   ) -> Optional[PartitionSpec]:
        """The :data:`ParamSpecRule` view of the table (what
        `Partitioner.param_spec` calls)."""
        axes = self.param_axes(name, shape)
        if axes is None:
            return None
        return self.logical_to_mesh(axes)

    # keep the table itself callable as a ParamSpecRule, so existing
    # call sites that invoke `rule(name, shape)` work unchanged
    def __call__(self, name: str, shape: Sequence[int]
                 ) -> Optional[PartitionSpec]:
        return self.param_rule(name, shape)

    @property
    def has_param_rules(self) -> bool:
        return bool(self.param_rules)

    # -- identity ------------------------------------------------------
    def fingerprint(self) -> Tuple:
        """Hashable identity for compile-cache keys: the full rule
        content, not the object id — two processes building the same
        table must hit the same disk cache entry."""
        return ("logical_axes", self.name, self.axis_rules,
                self.param_rules)

    def describe(self) -> Dict:
        return {"name": self.name,
                "axis_rules": [list(r) for r in self.axis_rules],
                "param_rules": [[pat, list(axes)]
                                for pat, axes in self.param_rules]}

    def __repr__(self):
        return (f"LogicalAxisRules({self.name!r}, "
                f"{len(self.axis_rules)} axis rules, "
                f"{len(self.param_rules)} param rules)")

    # -- stock tables --------------------------------------------------
    @classmethod
    def dp_default(cls, data_axis: str = "dp") -> "LogicalAxisRules":
        """Today's placement, as a table: batch -> data axis, every
        parameter replicated (no param rules => every lookup misses =>
        `PartitionSpec()`), bitwise-identical to running with no rule."""
        return cls(axis_rules=(("batch", data_axis),), param_rules=(),
                   name=f"dp_default[{data_axis}]")


def transformer_tp_rules(d_model: int, d_ff: int, vocab: Optional[int] = None,
                         *, data_axis: str = "dp", model_axis: str = "tp",
                         shard_embedding: bool = False,
                         name: Optional[str] = None) -> LogicalAxisRules:
    """Megatron-style tensor-parallel rules for the transformer family
    (`models.transformer`, `nets.scaled_dot_product_attention`).

    Column -> row sharding per Megatron-LM: the qkv projection
    ``[d, 3d]`` and FFN input ``[d, d_ff]`` split their *output*
    features over ``model_axis`` (each device computes a head/neuron
    slice with no communication), the FFN output ``[d_ff, d]`` splits
    its *input* features (XLA inserts the one all-reduce of the
    partial sums).  Biases follow their matmul's output sharding; the
    lm head ``[d, vocab]`` column-shards over the vocabulary (the
    softmax-xent reduction all-reduces over it).  LayerNorm scales,
    the positional encoding, and (by default) the token embedding
    replicate — their logical axes map to None.

    `layers.fc` parameters are named generically, so the param rules
    key on shape patterns built from ``d_model``/``d_ff``/``vocab``.
    Pass distinct hyperparameters (``d_ff != d_model`` etc.) or the
    patterns will overlap — first match wins, in the order below.
    """
    d, f = int(d_model), int(d_ff)
    if f == d:
        raise ValueError("transformer_tp_rules matches params by shape: "
                         f"d_ff must differ from d_model (both {d})")
    axis_rules = (
        ("batch", data_axis),
        ("length", None),
        ("embed", None),
        ("heads", model_axis),   # qkv output features / head dim
        ("kv", None),            # per-head feature dim stays whole
        ("mlp", model_axis),     # FFN hidden features
        ("vocab", model_axis),   # lm-head output features
        ("vocab_in", model_axis if shard_embedding else None),
    )
    param_rules = [
        # attention qkv projection [d, 3d] + bias [3d]: column-sharded
        (rf".*:{d}x{3 * d}", ("embed", "heads")),
        (rf".*:{3 * d}", ("heads",)),
        # FFN input projection [d, d_ff] + bias [d_ff]: column-sharded
        (rf".*:{d}x{f}", ("embed", "mlp")),
        (rf".*:{f}", ("mlp",)),
        # FFN output projection [d_ff, d]: ROW-sharded (all-reduce)
        (rf".*:{f}x{d}", ("mlp", "embed")),
        # LayerNorm scale/shift, FFN-out + lm-head-adjacent [d] vectors
        (rf".*:{d}", ("embed",)),
        # positional encoding [max_len, d] and any other [*, d] param
        # that is not an FFN output projection: replicated
        (rf".*:\d+x{d}", (None, "embed")),
    ]
    if vocab is not None:
        v = int(vocab)
        param_rules = [
            # lm head [d, vocab] + bias [vocab]: vocab-column-sharded
            (rf".*:{d}x{v}", ("embed", "vocab")),
            (rf".*:{v}", ("vocab",)),
            # token embedding [vocab, d]
            (rf".*:{v}x{d}", ("vocab_in", "embed")),
        ] + param_rules
    return LogicalAxisRules(
        axis_rules=axis_rules, param_rules=param_rules,
        name=name or (f"transformer_tp[d={d},f={f},v={vocab},"
                      f"{data_axis}x{model_axis}]"))
