"""Partitioner: one placement-rule implementation for training and
serving (counterpart of ``paddle_tpu/parallel/partitioner.py``).

What a `Partitioner` decides, as in the JAX package:

- **Param placement.**  ``param_spec(name, shape)`` runs the rule; a
  miss replicates, and so does a spec the shape cannot honour (an axis
  that does not divide its dim).  Misses of a rule that tried to place
  something are logged once (`warn_rule_misses`).
- **Feed placement.**  The batch dim shards along ``data_axis`` when the
  axis divides it, else the feed is replicated (``feed_spec``).
- **Numerics.**  ``"exact"`` gathers the batch on the data axis and
  every parameter shard at step entry, runs the single-device step and
  keeps each rank's shard of the new state: losses and parameters are
  bitwise the single-process run.  A `LogicalAxisRules` table is skipped
  in exact mode (its params live replicated); explicit ``table_specs``
  and plain callable rules keep their placement.  ``"fast"`` runs the
  step partitioned (`StepSharding`).
- **One device.**  A one-rank mesh runs the plain path with no
  collectives (``use_sharding`` False).

SPMD (the port's idiom; `parallel.mesh`): every rank runs the same step
on the same global feeds.  The resident state holds only the rank's
shard (`core.scope.Scope` gathers a sharded var on ``get``); fetches are
the global values on every rank.

Fast mode, per step (`StepSharding`):

- each rank keeps its data-axis slice of the feed;
- a column-sharded weight (``PartitionSpec(None, "tp")``) is read as
  its shard by the ``mul`` that multiplies it (its replicated input
  passes Megatron's f); the product stays sharded on its last axis
  through bias adds of a sharded bias and activations up to a
  ``sharding_constraint`` that asks for the same axis and feeds only
  row-sharded products (``PartitionSpec("tp", None)``), whose partial
  sums pass Megatron's g.  Elsewhere the column product's output is
  gathered: the QKV projection (its column split is not head-aligned,
  so attention runs whole on each tp rank) and the LM head's logits
  (before the softmax-xent kernel);
- every other sharded var the forward reads is gathered at step entry;
- the ``backward`` rule's gradients are reduced over the data axis as
  the loss asks (`reduce_gradients`): averaged for a mean over the
  batch, summed for a sum (or a per-row loss, whose gradient is that of
  its sum), left alone for a loss that reads no sliced feed; any other
  loss raises, since no reduction of the ranks' gradients gives the
  global one (`placement`).  A gathered parameter's gradient is cut back
  to its shard (summed over the data axis first when it is sharded there),
  and the optimizer rules update the local shards; an accumulator
  sharded on the data axis beside a replicated parameter
  (``transpile(zero_stage=1)``) updates its local rows and all-gathers
  the parameter (`ops.optimizer_ops`);
- the loss scaler's found-inf flag is max-reduced over the mesh
  (`ops.amp_ops`), so every rank skips together;
- a fetch is made global by the same placement: a mean over the batch
  averaged, a sum summed, a batch-sliced value gathered on the data
  axis, a sharded value gathered; any other value read from the slice
  raises.

``lookup_exchange="a2a"`` and ``a2a_capacity`` belong to the sharded
embeddings and are refused (ROADMAP queue A item 4).
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import collectives as coll
from . import mesh as mesh_lib
from .logical_axes import LogicalAxisRules, PartitionSpec

logger = logging.getLogger(__name__)

#: a param-spec rule: (var name, shape) -> PartitionSpec or None (replicate)
ParamSpecRule = Callable[[str, tuple], Optional[PartitionSpec]]

#: numerics modes (module docstring)
NUMERICS = ("fast", "exact")
#: sharded-lookup exchange policies of the JAX package; only "psum"
#: (no sharded lookup) runs here
LOOKUP_EXCHANGES = ("psum", "a2a")

_SHARDED_EMBEDDINGS = "queue A item 4"

#: ops a column-sharded product's output may pass through and stay
#: sharded on its last axis
_LOCAL_UNARY = frozenset({"relu", "gelu", "tanh", "sigmoid", "softsign",
                          "leaky_relu", "elu", "swish", "relu6",
                          "softplus", "dropout", "scale", "amp_cast"})
#: ops whose output is their input "X" in another shape or dtype
_RESHAPES = frozenset({"reshape", "reshape2", "squeeze", "squeeze2",
                       "unsqueeze", "unsqueeze2", "flatten", "flatten2",
                       "assign", "cast", "amp_cast"})


def parse_mesh_axes(text: str) -> Optional[Dict[str, int]]:
    """``"dp=4"`` / ``"dp=2,tp=4"`` -> axes dict; ``"none"``/"" -> None.
    Axis order is the mesh's rank-major order."""
    text = (text or "").strip()
    if not text or text.lower() in ("none", "off", "0"):
        return None
    axes: Dict[str, int] = {}
    for part in text.split(","):
        name, _, n = part.partition("=")
        name, n = name.strip(), n.strip()
        if not name or not n.isdigit() or int(n) < 1:
            raise ValueError(f"bad mesh spec {text!r}: want AXIS=N[,AXIS=N]")
        axes[name] = int(n)
    return axes


def resolve_mesh(mesh) -> mesh_lib.Mesh:
    """Mesh | axes dict | spec string | None (process mesh) -> Mesh."""
    if mesh is None:
        mesh = mesh_lib.get_mesh()
        if mesh is None:
            raise ValueError(
                "no mesh: pass mesh={'dp': N} (or a parallel Mesh), or set "
                "a process mesh via parallel.set_mesh")
    if isinstance(mesh, str):
        axes = parse_mesh_axes(mesh)
        if axes is None:
            raise ValueError(f"mesh spec {mesh!r} names no axes")
        mesh = axes
    if isinstance(mesh, dict):
        mesh = mesh_lib.create_training_mesh(mesh)
    if not isinstance(mesh, mesh_lib.Mesh):
        raise TypeError(f"mesh must be a Mesh, axes dict, or 'ax=N' spec, "
                        f"got {type(mesh).__name__}")
    return mesh


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def spec_fits(spec: Optional[PartitionSpec], shape: Tuple[int, ...],
              mesh) -> bool:
    """True when every sharded dim of ``shape`` is divisible by the
    product of its spec axes' sizes."""
    if spec is None:
        return True
    sizes = dict(mesh.shape)
    parts = tuple(spec)
    if len(parts) > len(shape):
        return False
    for d, part in enumerate(parts):
        axes = _axes(part)
        if not axes:
            continue
        try:
            n = int(np.prod([sizes[a] for a in axes]))
        except KeyError:
            return False
        if n > 1 and shape[d] % n != 0:
            return False
    return True


class Partitioner:
    """Placement rules and mesh for one train or serve deployment (see
    the module docstring; the arguments are the JAX class's)."""

    def __init__(self, mesh=None, data_axis: str = "dp",
                 param_spec: Optional[ParamSpecRule] = None,
                 numerics: str = "fast",
                 table_specs: Optional[Dict[str, PartitionSpec]] = None,
                 lookup_exchange: str = "psum",
                 a2a_capacity: Optional[int] = None):
        self.mesh = resolve_mesh(mesh)
        if data_axis not in self.mesh.shape:
            raise ValueError(f"data_axis {data_axis!r} not in mesh axes "
                             f"{tuple(self.mesh.shape)}")
        if numerics not in NUMERICS:
            raise ValueError(f"numerics must be one of {NUMERICS}, "
                             f"got {numerics!r}")
        if lookup_exchange not in LOOKUP_EXCHANGES:
            raise ValueError(
                f"lookup_exchange must be one of {LOOKUP_EXCHANGES}, "
                f"got {lookup_exchange!r}")
        if lookup_exchange != "psum" or a2a_capacity is not None:
            raise NotImplementedError(
                "lookup_exchange='a2a' and a2a_capacity exchange the ids "
                "of row-sharded embeddings, which are not ported "
                f"(ROADMAP {_SHARDED_EMBEDDINGS})")
        self.lookup_exchange = "psum"
        self.a2a_capacity = None
        self.data_axis = str(data_axis)
        self.logical_rules: Optional[LogicalAxisRules] = None
        if isinstance(param_spec, LogicalAxisRules):
            self.logical_rules = param_spec
        self.rule = param_spec
        self.numerics = str(numerics)
        self.table_specs: Dict[str, PartitionSpec] = dict(table_specs or {})
        self._rule_misses: Dict[str, str] = {}
        self._warned_misses = False
        self._plans: Dict[Any, "TPPlan"] = {}

    # -- topology ------------------------------------------------------
    @property
    def num_devices(self) -> int:
        return self.mesh.size

    @property
    def use_sharding(self) -> bool:
        """False on a one-rank mesh: the plain path, no collectives."""
        return self.num_devices > 1

    def mesh_shape(self) -> Dict[str, int]:
        return {ax: int(n) for ax, n in self.mesh.shape.items()}

    def axis_size(self, axis: str) -> int:
        return int(self.mesh.shape.get(axis, 1))

    # -- placement decisions -------------------------------------------
    def param_spec(self, name: str, shape) -> PartitionSpec:
        """table_specs override, then the rule; misses and specs the
        shape cannot honour replicate (and are recorded for the one-time
        warning).  Exact numerics skips a `LogicalAxisRules` table."""
        spec = self.table_specs.get(name)
        if spec is None and self.numerics == "exact" \
                and self.logical_rules is not None:
            return PartitionSpec()
        if spec is None and self.rule is not None:
            spec = self.rule(name, tuple(shape))
            declares = (self.logical_rules.has_param_rules
                        if self.logical_rules is not None else True)
            notable = (int(np.prod(tuple(shape) or (1,))) > 1
                       and not name.startswith("@"))
            if spec is None and declares and notable:
                self._rule_misses.setdefault(name, "no rule matched")
            elif not spec_fits(spec, tuple(shape), self.mesh):
                self._rule_misses.setdefault(
                    name, f"spec {spec} does not fit shape "
                          f"{tuple(shape)} on mesh {self.mesh_shape()}")
        if spec is None or not spec_fits(spec, tuple(shape), self.mesh):
            return PartitionSpec()
        return PartitionSpec(*tuple(spec))

    def warn_rule_misses(self):
        """One WARNING naming every param the rule failed to place."""
        if self._warned_misses or not self._rule_misses:
            return
        self._warned_misses = True
        detail = "; ".join(f"{n} ({why})" for n, why in
                           sorted(self._rule_misses.items()))
        logger.warning(
            "Partitioner rule %s left %d param(s) REPLICATED: %s",
            self.rule_id(), len(self._rule_misses), detail)

    def feed_spec(self, shape, stacked: bool = False) -> PartitionSpec:
        """Batch dim -> data axis when divisible, else replicated; a
        ``stacked`` feed is ``[K, batch, ...]``."""
        shape = tuple(shape)
        batch_dim = 1 if stacked else 0
        n = self.axis_size(self.data_axis)
        if len(shape) > batch_dim and shape[batch_dim] % n == 0:
            return PartitionSpec(*([None] * batch_dim + [self.data_axis]))
        return PartitionSpec()

    def activation_spec(self, logical_axes: Sequence[Optional[str]],
                        shape=None) -> Optional[PartitionSpec]:
        """A ``sharding_constraint``'s logical axes as a mesh spec, or
        None for "leave it alone" (no table, one rank, exact numerics, an
        axis this mesh lacks, or a shape the spec does not divide)."""
        if (self.logical_rules is None or not self.use_sharding
                or self.numerics == "exact"):
            return None
        parts = []
        for ax in logical_axes:
            mesh_ax = self.logical_rules.mesh_axis(
                None if ax in (None, "") else ax)
            parts.append(mesh_ax if mesh_ax in self.mesh.shape else None)
        if not any(p is not None for p in parts):
            return None
        spec = PartitionSpec(*parts)
        if shape is not None and not spec_fits(spec, tuple(shape),
                                               self.mesh):
            return None
        return spec

    # -- shards --------------------------------------------------------
    def is_sharded(self, spec: Optional[PartitionSpec]) -> bool:
        """True when ``spec`` splits some dim over an axis of size > 1."""
        return bool(spec) and any(self.axis_size(a) > 1
                                  for part in spec for a in _axes(part))

    def _index(self, axes: Tuple[str, ...]) -> Tuple[int, int]:
        """(this rank's slice index, slice count) over ``axes``,
        row-major in the listed order."""
        idx, n = 0, 1
        for a in axes:
            size = self.axis_size(a)
            idx = idx * size + self.mesh.coords.get(a, 0)
            n *= size
        return idx, n

    def shard(self, t, spec: PartitionSpec):
        """This rank's slice of a full tensor ``t`` under ``spec``."""
        for d, part in enumerate(tuple(spec)):
            axes = _axes(part)
            if not axes:
                continue
            idx, n = self._index(axes)
            if n > 1:
                t = coll.local_slice(t, d, idx, n)
        return t

    def full_shape(self, shape, spec: PartitionSpec) -> Tuple[int, ...]:
        """The whole value's shape from a shard's ``shape``."""
        parts = tuple(spec)
        return tuple(int(d) * (self._index(_axes(parts[i]))[1]
                               if i < len(parts) else 1)
                     for i, d in enumerate(shape))

    def shard_index(self, spec: PartitionSpec, shape) -> List[List[int]]:
        """This rank's shard as ``[[start, stop], ...]`` per dim of the
        full ``shape`` (the checkpoint manifest's index)."""
        out = []
        for d, dim in enumerate(shape):
            part = tuple(spec)[d] if d < len(tuple(spec)) else None
            idx, n = self._index(_axes(part))
            size = dim // n
            out.append([idx * size, (idx + 1) * size])
        return out

    def writes_shard(self, spec: PartitionSpec) -> bool:
        """True on the one rank that writes this shard to a checkpoint:
        the lowest rank among those holding it (coordinate 0 on every
        axis the spec does not split)."""
        used = {a for part in tuple(spec) for a in _axes(part)}
        return all(c == 0 for a, c in self.mesh.coords.items()
                   if a not in used)

    def gather(self, t, spec: PartitionSpec):
        """The full tensor from this rank's shard ``t`` (bit-exact)."""
        for d, part in reversed(list(enumerate(tuple(spec)))):
            for a in reversed(_axes(part)):
                t = coll.all_gather(t, self.mesh.group(a), a, d)
        return t

    # -- identity ------------------------------------------------------
    def describe(self) -> Dict[str, Any]:
        out = {"mesh": self.mesh_shape(),
               "data_axis": self.data_axis,
               "devices": self.num_devices,
               "platform": "gpu" if self.mesh.device_type == "cuda"
               else "cpu",
               "numerics": self.numerics,
               "rule": self.rule_id()}
        if self.table_specs:
            out["sharded_tables"] = sorted(self.table_specs)
        return out

    def rule_id(self) -> Optional[str]:
        if self.logical_rules is not None:
            return self.logical_rules.name
        if self.rule is None:
            return None
        return getattr(self.rule, "__qualname__", repr(self.rule))

    def rule_token(self):
        return self.logical_rules if self.logical_rules is not None \
            else self.rule

    def fingerprint(self) -> Tuple:
        """Mesh topology, ranks, data axis, rule, numerics: two
        deployments that place state differently never share one."""
        rule_fp = (self.logical_rules.fingerprint()
                   if self.logical_rules is not None else self.rule_id())
        return (tuple(sorted((ax, int(n))
                             for ax, n in self.mesh.shape.items())),
                tuple(int(r) for r in self.mesh.devices.flat),
                self.data_axis, rule_fp, self.numerics,
                tuple(sorted((n, str(s))
                             for n, s in self.table_specs.items())),
                self.lookup_exchange, self.a2a_capacity)

    # -- the fast-mode step --------------------------------------------
    def step(self, program, specs: Dict[str, PartitionSpec]
             ) -> "StepSharding":
        """The partitioned view of one step of ``program`` over state
        placed by ``specs`` (name -> spec of each sharded state var)."""
        block = program.global_block()
        key = (id(program), len(block.ops),
               tuple(sorted((n, tuple(s)) for n, s in specs.items())))
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = TPPlan(self, program, specs)
        return StepSharding(self, plan, specs)


class TPPlan:
    """Which products of a block run Megatron-local (module docstring):
    ``col`` maps a column product's op to its tp axis, ``keep`` holds
    those whose output stays sharded, ``row`` maps a row product's op to
    its axis; ``local`` names the sharded params read as shards (every
    other sharded var the forward reads is gathered at entry)."""

    def __init__(self, part: Partitioner, program, specs):
        block = program.global_block()
        self.col: Dict[int, str] = {}
        self.row: Dict[int, str] = {}
        self.keep: set = set()
        self.kept_adds: set = set()
        self.local: set = set()
        ops = block.ops
        bwd = [i for i, op in enumerate(ops) if op.type == "backward"]
        end = bwd[0] if bwd else len(ops)
        fwd = ops[:end]
        readers: Dict[str, List[int]] = {}
        for i, op in enumerate(fwd):
            for n in op.desc.input_names():
                readers.setdefault(n, []).append(i)
        #: what the forward and the sub-blocks read (gathered at entry
        #: unless read as a shard)
        self.read = set(readers)
        for b in program.blocks[1:]:
            for op in b.ops:
                self.read.update(op.desc.input_names())

        def model_axis(spec, dim):
            parts = tuple(spec) + (None,) * 2
            ax = _axes(parts[dim])
            if len(ax) != 1 or len([p for p in tuple(spec) if p]) != 1:
                return None
            ax = ax[0]
            if ax == part.data_axis or part.axis_size(ax) == 1:
                return None
            return ax

        def weight_of(op):
            if op.type != "mul" or op.desc.attrs.get("y_num_col_dims", 1) != 1:
                return None, None
            w = op.desc.inputs.get("Y", [None])[0]
            spec = specs.get(w)
            if spec is None or len(tuple(spec)) != 2:
                return None, None
            return w, spec

        wanted: Dict[str, bool] = {}   # sharded param -> read as shard
        for i, op in enumerate(fwd):
            w, spec = weight_of(op)
            if w is None:
                continue
            ax = model_axis(spec, 1)
            if ax is None:
                continue
            self.col[id(op)] = ax
            chain = self._chain(part, fwd, readers, specs, i, ax)
            if chain is None:
                continue
            biases, adds, rows = chain
            self.kept_adds.update(adds)
            self.keep.add(id(op))
            for j in rows:
                self.row[id(fwd[j])] = ax
                wanted.setdefault(fwd[j].desc.inputs["Y"][0], True)
            for b in biases:
                wanted.setdefault(b, True)
        for i, op in enumerate(fwd):
            if id(op) in self.col:
                wanted.setdefault(op.desc.inputs["Y"][0], True)
        # a param read as a shard only where every forward reader takes
        # the shard
        for name in wanted:
            ok = True
            for j in readers.get(name, ()):
                op = fwd[j]
                if (id(op) in self.col or id(op) in self.row) \
                        and op.desc.inputs.get("Y", [None])[0] == name:
                    continue
                if id(op) in self.kept_adds and \
                        op.desc.inputs.get("Y", [None])[0] == name:
                    continue
                ok = False
            if ok:
                self.local.add(name)
        # a product whose weight ended up gathered runs plain
        for table in (self.col, self.row):
            for i, op in enumerate(fwd):
                if id(op) in table and \
                        op.desc.inputs["Y"][0] not in self.local:
                    table.pop(id(op))
                    self.keep.discard(id(op))

    def _chain(self, part, fwd, readers, specs, i, ax):
        """Follow a column product's output to a keep-sharded constraint
        feeding only row products: -> (bias names, bias-add op ids, row
        indices), or None."""
        cur = fwd[i].desc.outputs["Out"][0]
        biases, adds = [], []
        while True:
            nxt = readers.get(cur, [])
            if len(nxt) != 1:
                return None
            j = nxt[0]
            op = fwd[j]
            t = op.type
            if t == "elementwise_add" and op.desc.inputs["X"][0] == cur:
                b = op.desc.inputs["Y"][0]
                bspec = specs.get(b)
                if bspec is None or tuple(bspec) != (ax,) or \
                        op.desc.attrs.get("axis", -1) not in (-1, 2, 1):
                    return None
                biases.append(b)
                adds.append(id(op))
            elif t in _LOCAL_UNARY:
                pass
            elif t == "sharding_constraint":
                axes = tuple(None if a in ("", None) else a
                             for a in (op.desc.attrs.get("logical_axes")
                                       or ()))
                spec = part.activation_spec(axes)
                if spec is None or tuple(spec)[-1] != ax:
                    return None
                out = op.desc.outputs["Out"][0]
                rows = readers.get(out, [])
                if not rows:
                    return None
                for r in rows:
                    rop = fwd[r]
                    if rop.type != "mul" or rop.desc.inputs["X"][0] != out \
                            or rop.desc.attrs.get("y_num_col_dims", 1) != 1:
                        return None
                    rspec = specs.get(rop.desc.inputs["Y"][0])
                    if rspec is None or tuple(rspec) != (ax, None):
                        return None
                return biases, adds, rows
            else:
                return None
            cur = op.desc.outputs["Out"][0]


class StepSharding:
    """One fast-mode step's partitioned view, handed to the interpreter
    and read by the op rules (``ctx.interpreter.partitioner``)."""

    def __init__(self, part: Partitioner, plan: TPPlan,
                 specs: Dict[str, PartitionSpec]):
        self.part = part
        self.plan = plan
        self.specs = specs
        #: sharded param -> its resident shard, for those gathered at entry
        self.gathered: Dict[str, Any] = {}
        self.data_group = part.mesh.group(part.data_axis)
        self.n_data = part.axis_size(part.data_axis)
        #: the feeds sliced on the data axis
        self.sliced: set = set()
        #: (vars that read a sliced feed, forward op writing each var)
        self._deps: Optional[Tuple[set, Dict[str, Any]]] = None

    # -- entry ---------------------------------------------------------
    def prepare(self, env: Dict[str, Any]):
        """Gather every sharded var the forward reads that is not read
        as a shard (before the interpreter marks the autograd leaves)."""
        for name, spec in self.specs.items():
            if name in env and name in self.plan.read \
                    and name not in self.plan.local:
                self.gathered[name] = env[name]
                env[name] = self.part.gather(env[name], spec)

    def slice_feed(self, feed: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's data-axis slice of each feed (a feed the axis does
        not divide stays whole)."""
        out = {}
        for name, v in feed.items():
            spec = self.part.feed_spec(tuple(v.shape))
            if tuple(spec) and self.n_data > 1:
                out[name] = self.part.shard(v, spec)
                self.sliced.add(name)
            else:
                out[name] = v
        return out

    # -- the product rules (ops.math_ops) ------------------------------
    def product_input(self, op, x):
        """A column product's replicated input passes Megatron's f."""
        ax = self.plan.col.get(id(op))
        if ax is None:
            return x
        return coll.copy_to(x, self.part.mesh.group(ax), ax)

    def product_output(self, op, out):
        """A kept column product stays sharded; any other column
        product gathers its last axis; a row product all-reduces its
        partial sums (Megatron's g)."""
        ax = self.plan.col.get(id(op))
        if ax is not None:
            if id(op) in self.plan.keep:
                return out
            return coll.gather(out, self.part.mesh.group(ax), ax,
                               out.dim() - 1)
        ax = self.plan.row.get(id(op))
        if ax is not None:
            return coll.reduce_from(out, self.part.mesh.group(ax), ax)
        return out

    # -- what a value is across the data axis ----------------------------
    def placement(self, block, name: str) -> Optional[str]:
        """How the local value of ``name`` relates to its global one when
        the feed is sliced on the data axis: ``"replicated"`` (it reads
        no sliced feed), ``"rows"`` (its batch rows are the rank's
        slice), ``"mean"`` or ``"sum"`` (a mean or a sum over the batch,
        or a linear function of one), or None (none of these)."""
        if self._deps is None:
            self._deps = _batch_deps(block, self.sliced)
        return _placement(block, name, *self._deps)

    def _unreduced(self, block, name: str, what: str):
        op = self._deps[1].get(name)
        return ValueError(
            f"fast numerics on the data axis {self.part.data_axis!r} "
            f"({self.n_data} ranks): {what} {name!r} (written by "
            f"{op.type if op is not None else 'a feed'!r}) is neither a "
            "mean nor a sum over the batch, so its global value cannot "
            "be reduced from the ranks' slices; use numerics='exact'")

    # -- gradients (core.backward) -------------------------------------
    def reduce_gradients(self, block, loss: str, env: Dict[str, Any],
                         names: Sequence[str], grads: Dict[str, Any]):
        """Reduce the gradients over the data axis as the loss's
        placement asks (a gathered param's whole gradient too, which is
        what sums a data-axis shard's contributions from every rank),
        cut a gathered param's back to its shard, and put the shard back
        in ``env`` for the optimizer ops."""
        part = self.part
        how = "replicated"
        if self.n_data > 1 and self.sliced:
            how = self.placement(block, loss)
            if how is None:
                raise self._unreduced(block, loss, "the loss")
        for name in names:
            g = grads.get(name)
            if g is not None and how != "replicated":
                g = coll.all_reduce(g, self.data_group, part.data_axis)
                if how == "mean":
                    g = g / self.n_data
            if name in self.gathered:
                if g is not None:
                    g = part.shard(g, self.specs[name]).contiguous()
                env[name] = self.gathered[name]
            if g is not None:
                grads[name] = g

    # -- the loss scaler (ops.amp_ops) ---------------------------------
    def any_rank(self, flag):
        """A boolean flag, max-reduced over every rank of the mesh."""
        import torch
        v = flag.reshape(1).to(torch.int32)
        v = coll.all_reduce(v, self.part.mesh.world_group(), "world",
                            op="max")
        return v.reshape(()).bool()

    # -- fetches -------------------------------------------------------
    def fetch(self, block, name: str, val):
        """The global value of a fetch (module docstring)."""
        import torch
        if not isinstance(val, torch.Tensor):
            return val
        base = name[:-len("@GRAD")] if name.endswith("@GRAD") else name
        spec = self.specs.get(base)
        if spec is not None:
            full = None
            var = block._find_var_recursive(base)
            if var is not None and var.shape is not None:
                full = tuple(var.shape)
            if full is None or tuple(val.shape) != full:
                return self.part.gather(val, spec)
            return val
        if not self.sliced or self.n_data == 1:
            return val
        how = self.placement(block, name)
        if how == "rows" and val.dim() > 0:
            return coll.all_gather(val, self.data_group,
                                   self.part.data_axis, 0)
        if how in ("mean", "sum"):
            val = coll.all_reduce(val, self.data_group, self.part.data_axis)
            return val / self.n_data if how == "mean" else val
        if how == "replicated":
            return val
        raise self._unreduced(block, name, "the fetch")


def _reads(program, op) -> List[str]:
    """The names ``op`` reads, its sub-blocks' reads included."""
    from ..core.lowering import SUB_BLOCK_ATTRS
    names = op.desc.input_names()
    for k in SUB_BLOCK_ATTRS:
        if k in op.desc.attrs:
            for sub in program.blocks[op.desc.attrs[k]].ops:
                names = names + _reads(program, sub)
    return names


def _batch_deps(block, sliced) -> Tuple[set, Dict[str, Any]]:
    """(the vars the block computes from a sliced feed, the op writing
    each var); a ``backward`` op's gradients are reduced, so they read
    none."""
    deps, producer = set(sliced), {}
    for op in block.ops:
        if op.type == "backward":
            continue
        outs = op.desc.output_names()
        if any(n in deps for n in _reads(block.program, op)):
            deps.update(outs)
        for n in outs:
            producer[n] = op
    return deps, producer


def _placement(block, name, deps, producer) -> Optional[str]:
    """`StepSharding.placement` over the forward's dependencies: a mean
    or sum keeps its placement through linear ops (another reduction,
    a reshape, a scale, a sum with its kind or with a constant for a
    mean, a product with a constant)."""
    if name not in deps:
        return "replicated"
    op = producer.get(name)
    if op is None:
        return "rows"
    var = block._find_var_recursive(name)
    rows = (var is not None and bool(var.shape)
            and var.shape[0] in (None, -1))
    t, ins, attrs = op.type, op.desc.inputs, op.desc.attrs

    def of(n):
        return _placement(block, n, deps, producer)

    if t in ("mean", "reduce_mean", "reduce_sum"):
        x = of(ins["X"][0])
        if x != "rows":
            return x
        if t != "mean" and not attrs.get("reduce_all", False):
            xv = block._find_var_recursive(ins["X"][0])
            dim = attrs.get("dim", [0])
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            if any(d < 0 for d in dims):
                if xv is None or xv.shape is None:
                    return None
                dims = [d % len(xv.shape) for d in dims]
            if 0 not in dims:
                return "rows"
        return "sum" if t == "reduce_sum" else "mean"
    if t in _RESHAPES:
        return of(ins["X"][0])
    if t == "scale":
        x = of(ins["X"][0])
        return None if x == "sum" and attrs.get("bias", 0.0) else x
    if t == "accuracy":
        return "mean" if name in op.desc.outputs.get("Accuracy", ()) \
            else "sum"
    if t in ("elementwise_add", "elementwise_sub", "sum", "sums"):
        names = op.desc.input_names()
        kinds = {of(n) for n in names if n in deps}
        if len(kinds) != 1:
            return None
        kind = kinds.pop()
        if kind == "sum" and any(n not in deps for n in names):
            return None
        return kind
    if t in ("elementwise_mul", "elementwise_div"):
        x, y = ins["X"][0], ins["Y"][0]
        if x in deps and y in deps:
            return "rows" if of(x) == of(y) == "rows" else None
        if y in deps and t == "elementwise_div":
            return "rows" if of(y) == "rows" else None
        return of(x if x in deps else y)
    return "rows" if rows else None
