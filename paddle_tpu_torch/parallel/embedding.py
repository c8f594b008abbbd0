"""Row-sharded embedding tables over a mesh axis (counterpart of
``paddle_tpu/parallel/embedding.py``).

A table read by ``lookup_table(is_distributed=True)``, or one a
``param_spec`` rule row-shards, lives as ``[V/n, D]`` row shards over a
mesh axis (``"ep"`` by convention), and so do its row-shaped optimizer
accumulators.  No rank holds the whole table in either numerics: only
the lookup and the sparse update touch it.

The JAX package runs each body under ``shard_map``.  The port is SPMD
(`parallel.mesh`): every function here runs on every rank of the axis's
group, with the rank's own shard as ``table`` and its index on the axis
taken from the mesh.

- **The psum lookup** (`sharded_lookup_local`,
  `sharded_embedding_lookup`).  Each rank gathers the rows it owns for
  the ids (the same ids on every rank of the group) and writes zeros for
  the rest; one all-reduce over the axis combines them.  The sum runs
  over the rows' bytes read as int32 words (`collectives.all_reduce_words`):
  an integer sum of zeros and one value keeps every bit pattern, where a
  float sum would turn a ``-0.0`` entry into ``+0.0``.  So the rows are
  bitwise the dense ``index_select``'s, and the payload is the ``[N, D]``
  output at any axis size.  Ids in ``[-V, 0)`` wrap; other ids outside
  ``[0, V)`` give a zero row (no shard owns them).  An int8 table's rows
  dequantize before the sum (bf16, two values a word; D is even).
- **The shard-local updates** (`sharded_row_update`, `sharded_row_add`).
  The merged ``(rows, values)`` pair is the same on every rank; each
  applies the per-row math to the rows it owns, and the optimizer's
  commit writes them into its shard.  No gradient crosses ranks and no
  ``[V, D]`` gradient exists.
- **The exchange** (`_bucket_by_owner`, `a2a_lookup_local`,
  `a2a_embedding_lookup`, `sharded_row_update_a2a`,
  `sharded_row_add_a2a`).  Each rank takes its position block of the ids
  and routes them to their owners over one all-to-all, in buckets of a
  static ``capacity`` per (source, owner) pair; the hit rows ride back
  over a second.  The gradient pairs take the same exchange in reverse
  and each owner merges its own with `ops.optimizer_ops.merge_selected_rows`.
  The owner sort is stable, so an owner receives each duplicate group in
  global position order and sums it in the order of the global merge:
  bitwise.  Ids past a full bucket drop to a zero row (lookup) or a
  dropped update; plan the capacity from data (`plan_a2a_capacity`).
  Payload: ``nsh * capacity * (4 + D * itemsize)`` bytes each way.
- **Placement** (`distributed_tables`, `derive_table_specs`,
  `bind_program_tables`, `table_row_axis`, `shard_table`): the one rule
  by which training (`core.executor`) and serving (`serving.sharded`)
  place tables.

`RowTables` is one step's view of the row-sharded state; the
``lookup_table`` rule, the sparse optimizer branches and the
``backward`` rule read it (``Interpreter.tables``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import collectives as coll
from .logical_axes import PartitionSpec

#: the conventional mesh axis tables row-shard over: a Partitioner whose
#: mesh has it places distributed tables by itself (derive_table_specs)
EMBED_AXIS = "ep"


def _wrap(ids: torch.Tensor, total: int) -> torch.Tensor:
    """int64 ids, those in ``[-total, 0)`` wrapped (numpy indexing)."""
    ids = ids.long()
    return torch.where((ids < 0) & (ids >= -total), ids + total, ids)


def _owned(ids: torch.Tensor, rows: int, index: int):
    """(each id's row in shard ``index``, clamped into it; True where
    the shard owns the id)."""
    local = ids - index * rows
    own = (local >= 0) & (local < rows)
    return torch.where(own, local, torch.zeros_like(local)), own


def _rows_of(table_shard: torch.Tensor, local: torch.Tensor,
             own: torch.Tensor, scale=None) -> torch.Tensor:
    """The shard's rows at ``local`` (an int8 table's dequantized with
    ``scale``), zero where the shard does not own the id."""
    d = table_shard.shape[-1]
    got = table_shard.index_select(0, local.reshape(-1))
    if scale is not None:
        from ..core.lowering import dequantize_int8
        got = dequantize_int8(got, scale)
    got = got.masked_fill(~own.reshape(-1, 1), 0)
    return got.reshape(tuple(local.shape) + (d,))


def sharded_lookup_local(table_shard: torch.Tensor, ids: torch.Tensor,
                         mesh, axis: str = EMBED_AXIS, scale=None
                         ) -> torch.Tensor:
    """One rank's part of the psum lookup: its rows for ``ids`` (zeros
    for ids it does not own), summed over the axis as int32 words ->
    ``[*ids, D]`` rows, the same on every rank of the group."""
    group, n, index = coll.on_axis(mesh, axis)
    rows = table_shard.shape[0]
    local, own = _owned(_wrap(ids, rows * n), rows, index)
    return coll.all_reduce_words(_rows_of(table_shard, local, own, scale),
                                 group, axis)


class _ShardedRows(torch.autograd.Function):
    """Rows of a row-sharded table that requires grad (not ``is_sparse``).
    The backward scatter-adds, into this rank's shard, the gradient rows
    of the ids it owns.  ``ids_blocked``: the ids given are this rank's
    position block (gathered over the axis for the backward);
    ``grad_blocked``: so is the output (its gradient is gathered)."""

    @staticmethod
    def forward(ctx, table, ids, lookup, mesh, axis, ids_blocked,
                grad_blocked):
        ctx.save_for_backward(ids)
        ctx.meta = (mesh, axis, ids_blocked, grad_blocked,
                    tuple(table.shape), table.dtype)
        return lookup(table.detach())

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        mesh, axis, ids_blocked, grad_blocked, shape, dtype = ctx.meta
        group, n, index = coll.on_axis(mesh, axis)
        rows, d = shape
        ids = ids.reshape(-1)
        g = g.reshape(-1, d)
        if ids_blocked:
            ids = coll.all_gather(ids.contiguous(), group, axis, 0)
        if grad_blocked:
            g = coll.all_gather(g.contiguous(), group, axis, 0)
        g = g[:ids.numel()]
        local, own = _owned(_wrap(ids, rows * n), rows, index)
        dump = torch.where(own, local, torch.full_like(local, rows))
        grad = torch.zeros((rows + 1, d), dtype=dtype, device=g.device)
        grad.index_add_(0, dump, g.to(dtype))
        return grad[:rows], None, None, None, None, None, None


def _maybe_grad(table, ids, lookup, mesh, axis, ids_blocked=False,
                grad_blocked=False):
    if table.requires_grad and torch.is_grad_enabled():
        return _ShardedRows.apply(table, ids, lookup, mesh, axis,
                                  ids_blocked, grad_blocked)
    return lookup(table)


def sharded_embedding_lookup(table: torch.Tensor, ids: torch.Tensor, mesh,
                             axis: str = EMBED_AXIS, scale=None
                             ) -> torch.Tensor:
    """``table`` is this rank's ``[V/n, D]`` row shard, ``ids`` the same
    on every rank of the axis's group -> ``[*ids, D]``, bitwise the dense
    ``index_select`` of the whole table (each row comes from one shard).
    Differentiable in a table that requires grad: the backward writes
    only the rows the rank owns.  ``scale`` dequantizes an int8 table's
    rows before the sum."""
    return _maybe_grad(table, ids, lambda t: sharded_lookup_local(
        t, ids, mesh, axis, scale), mesh, axis)


def sharded_row_update(mesh, axis: str, row_fn: Callable, tables, uniq,
                       merged, *extras):
    """A per-row optimizer update of row-sharded ``tables`` (the
    parameter's shard and its same-shape accumulators' shards), on the
    rows this rank owns.

    ``uniq`` is the merged rows, sorted and distinct (`merge_selected_
    rows`), ``merged`` their values, both the same on every rank;
    ``row_fn(rows_tuple, merged, *extras)`` is the single-device sparse
    branch's per-row math.  -> (the owned rows' indices in the shard, the
    new rows of each table), which the optimizer's commit writes into
    the shards (`core.lowering.RowUpdate`)."""
    _, _, index = coll.on_axis(mesh, axis)
    rows = tables[0].shape[0]
    if any(t.shape[0] != rows for t in tables):
        raise ValueError("sharded_row_update: the parameter and its "
                         "accumulators must be row-sharded alike, got "
                         f"{[tuple(t.shape) for t in tables]}")
    bounds = torch.tensor([index * rows, (index + 1) * rows],
                          dtype=uniq.dtype, device=uniq.device)
    lo, hi = torch.searchsorted(uniq, bounds).tolist()
    local = uniq[lo:hi] - index * rows
    cur = tuple(t.index_select(0, local) for t in tables)
    return local, tuple(row_fn(cur, merged[lo:hi], *extras))


def _add_rows(cur, addend):
    return (cur[0] + addend,)


def sharded_row_add(mesh, axis: str, table, uniq, addend):
    """The sgd form: ``addend`` (``-lr * merged``, already rounded to the
    table's dtype, as the single-device rule rounds it once) added to the
    owned rows -> (the rows' indices in the shard, their new values)."""
    local, (new,) = sharded_row_update(mesh, axis, _add_rows, (table,),
                                       uniq, addend)
    return local, new


# ---------------------------------------------------------------------------
# the all-to-all id exchange
# ---------------------------------------------------------------------------

def _bucket_by_owner(ids: torch.Tensor, rows: int, nsh: int,
                     capacity: int):
    """Pack this rank's ``[C0]`` id block into ``[nsh * capacity]`` owner
    buckets -> ``(send_ids, slot_pos, dest, order)``.

    ``send_ids[j * capacity + r]`` is the r-th id this rank sends owner j
    (``rows * nsh`` fills empty slots: no shard owns it); ``slot_pos``
    maps each slot back to the id's position in the block (distinct
    values from C0 up for unused slots); ``order`` is the stable owner
    sort and ``dest`` each sorted id's slot (past ``nsh * capacity`` for
    an id that is dropped).  Stable: the ids of one bucket keep their
    block order, so an owner receives each duplicate group in global
    position order.  Ids outside ``[0, rows * nsh)`` and ids past a full
    bucket are dropped."""
    total = rows * nsh
    c0 = ids.shape[0]
    m = nsh * capacity
    dev = ids.device
    ids = ids.long()
    valid = (ids >= 0) & (ids < total)
    owner = torch.where(valid, torch.div(ids, rows, rounding_mode="floor"),
                        torch.full_like(ids, nsh))   # invalid sorts last
    sorted_owner, order = torch.sort(owner, stable=True)
    sorted_ids = ids.index_select(0, order)
    starts = torch.searchsorted(sorted_owner,
                                torch.arange(nsh + 1, device=dev))
    pos = torch.arange(c0, device=dev)
    rank = pos - starts.index_select(0, sorted_owner)
    ok = (sorted_owner < nsh) & (rank < capacity)
    dest = torch.where(ok, sorted_owner * capacity + rank, m + pos)
    # slots past m take the dropped ids, so every scatter index is
    # distinct and in range
    send = torch.full((m + c0,), total, dtype=torch.long, device=dev)
    send[dest] = sorted_ids
    slot = c0 + torch.arange(m + c0, device=dev)
    slot[dest] = order
    return send[:m], slot[:m], dest, order


def a2a_lookup_local(table_shard: torch.Tensor, ids_blk: torch.Tensor,
                     mesh, axis: str, nsh: int, capacity: int, scale=None
                     ) -> torch.Tensor:
    """One rank's exchange: ``ids_blk [C0]`` is its position block of the
    ids.  The ids go to their owners over one all-to-all (int32), each
    owner gathers its rows, and the rows come back over a second ->
    ``[C0, D]``, each delivered row the exact table row; undelivered
    positions (ids no shard owns, bucket overflow) are zero rows."""
    group, _, index = coll.on_axis(mesh, axis)
    rows = table_shard.shape[0]
    total = rows * nsh
    ids_blk = _wrap(ids_blk, total)
    send_ids, slot_pos, _, _ = _bucket_by_owner(ids_blk, rows, nsh,
                                                capacity)
    recv = coll.all_to_all(send_ids.to(torch.int32), group, axis).long()
    local, own = _owned(recv, rows, index)
    back = coll.all_to_all(_rows_of(table_shard, local, own, scale),
                           group, axis)
    c0 = ids_blk.shape[0]
    out = back.new_zeros((c0 + nsh * capacity, back.shape[-1]))
    out[slot_pos] = back
    return out[:c0]


def _pad_block(flat: torch.Tensor, nsh: int, fill):
    """Pad ``flat`` on dim 0 to a multiple of ``nsh`` -> (padded, n,
    block size)."""
    n = int(flat.shape[0])
    c0 = -(-n // nsh)
    if c0 * nsh != n:
        flat = torch.cat([flat, flat.new_full(
            (c0 * nsh - n,) + tuple(flat.shape[1:]), fill)])
    return flat, n, c0


def resolve_a2a_capacity(capacity, n_ids: int, nsh: int) -> int:
    """A policy capacity clamped to the full-safe ``ceil(N / nsh)`` (no
    bucket can need more); None -> full-safe (never drops, but never
    beats the psum's bytes either)."""
    c0 = -(-int(n_ids) // nsh)
    cap = c0 if capacity is None else int(capacity)
    return max(1, min(cap, c0))


def a2a_embedding_lookup(table: torch.Tensor, ids: torch.Tensor, mesh,
                         axis: str = EMBED_AXIS,
                         capacity: Optional[int] = None, scale=None,
                         gather_out: bool = False) -> torch.Tensor:
    """The exchange form of `sharded_embedding_lookup` (``table`` this
    rank's shard, ``ids`` the same on every rank of the group): each rank
    looks up its position block of the flattened ids -> that block's rows
    ``[ceil(N / nsh), D]``, or, with ``gather_out``, every rank's blocks
    gathered back to ``[*ids, D]``, bitwise the psum lookup's."""
    group, nsh, index = coll.on_axis(mesh, axis)
    orig = tuple(ids.shape)
    d = table.shape[-1]
    flat, n, _ = _pad_block(ids.reshape(-1).long(), nsh,
                            table.shape[0] * nsh)      # pad ids are dropped
    cap = resolve_a2a_capacity(capacity, n, nsh)
    blk = coll.local_slice(flat, 0, index, nsh)

    def lookup(t):
        out = a2a_lookup_local(t, blk, mesh, axis, nsh, cap, scale)
        if gather_out:
            out = coll.all_gather(out, group, axis, 0)[:n].reshape(
                orig + (d,))
        return out
    return _maybe_grad(table, ids, lookup, mesh, axis,
                       grad_blocked=not gather_out)


def plan_a2a_capacity(ids_batches, n_shards: int, slack: float = 1.25,
                      vocab: Optional[int] = None) -> int:
    """A static bucket capacity from sample batches (host numpy): the
    most ids any (source block, owner) pair holds in the samples, times
    ``slack``, clamped to the full-safe ``ceil(N / nsh)``.  A capacity
    under a later batch's occupancy drops the overflow (zero rows,
    dropped updates), so plan from representative traffic."""
    all_ids = [np.asarray(b).reshape(-1) for b in ids_batches]
    if not all_ids or all(a.size == 0 for a in all_ids):
        return 1
    vmax = vocab or (max(int(a.max()) for a in all_ids if a.size) + 1)
    v = -(-vmax // n_shards) * n_shards
    rows = v // n_shards
    worst = 1
    c0_min = None
    for flat in all_ids:
        n = flat.size
        if n == 0:
            continue
        c0 = -(-n // n_shards)
        c0_min = c0 if c0_min is None else min(c0_min, c0)
        blocks = np.full(c0 * n_shards, -1, np.int64)
        blocks[:n] = flat
        for blk in blocks.reshape(n_shards, c0):
            ids = blk[blk >= 0]
            if ids.size == 0:
                continue
            occ = np.bincount(ids // rows, minlength=n_shards)
            worst = max(worst, int(occ.max()))
    cap = int(np.ceil(worst * float(slack)))
    return max(1, min(cap, c0_min if c0_min else cap))


def sharded_row_update_a2a(mesh, axis: str, row_fn: Callable, tables,
                           rows_ids, values, capacity: Optional[int],
                           *extras, blocked: bool = False):
    """The update over the reverse exchange: raw (pre-merge) SelectedRows
    pairs route to their owners over the lookup's owner-bucketed
    all-to-all; each owner merges its pairs with `merge_selected_rows` and
    applies ``row_fn`` (`sharded_row_update`).  The pairs are the same on
    every rank (each takes its position block), or, with ``blocked``,
    already this rank's block (fast numerics on the data axis).  -> (the
    owned rows' indices in the shard, the new rows of each table)."""
    from ..ops.optimizer_ops import merge_selected_rows
    group, nsh, index = coll.on_axis(mesh, axis)
    total = tables[0].shape[0] * nsh
    ids = _wrap(rows_ids.reshape(-1), total)
    vals = values.reshape(ids.shape[0], -1)
    if blocked:
        c0 = ids.shape[0]
        cap = resolve_a2a_capacity(capacity, c0 * nsh, nsh)
    else:
        ids, n, c0 = _pad_block(ids, nsh, total)         # pads drop
        vals, _, _ = _pad_block(vals, nsh, 0)
        cap = resolve_a2a_capacity(capacity, n, nsh)
        ids = coll.local_slice(ids, 0, index, nsh)
        vals = coll.local_slice(vals, 0, index, nsh)
    m = nsh * cap
    send_ids, _, dest, order = _bucket_by_owner(ids, tables[0].shape[0],
                                                nsh, cap)
    send_vals = vals.new_zeros((m + c0, vals.shape[-1]))
    send_vals[dest] = vals.index_select(0, order)
    recv_ids = coll.all_to_all(send_ids.to(torch.int32), group, axis)
    recv_vals = coll.all_to_all(send_vals[:m], group, axis)
    # slots no id filled carry the id ``total`` and zero values: the
    # merge drops them
    uniq, merged = merge_selected_rows(recv_ids, recv_vals, total)
    return sharded_row_update(mesh, axis, row_fn, tables, uniq, merged,
                              *extras)


def sharded_row_add_a2a(mesh, axis: str, table, rows_ids, values,
                        capacity: Optional[int], lr, blocked: bool = False):
    """The sgd form over the reverse exchange: the owner merges its pairs,
    multiplies ``-lr`` once, rounds to the table's dtype and adds, as
    the single-device rule does -> (owned rows' indices, new rows)."""
    def row_fn(cur, g):
        return (cur[0] + (-lr * g).to(cur[0].dtype),)
    local, (new,) = sharded_row_update_a2a(mesh, axis, row_fn, (table,),
                                           rows_ids, values, capacity,
                                           blocked=blocked)
    return local, new


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def shard_table(table: torch.Tensor, mesh, axis: str = EMBED_AXIS
                ) -> torch.Tensor:
    """This rank's row shard of a whole table (the startup-time
    counterpart of the transpiler's ``split_dense_variable``)."""
    _, n, index = coll.on_axis(mesh, axis)
    return coll.local_slice(table, 0, index, n).clone()


def distributed_tables(program) -> Dict[str, tuple]:
    """``{table: shape}`` of every parameter read as the ``W`` of a
    ``lookup_table(is_distributed=True)`` in the main block."""
    out: Dict[str, tuple] = {}
    block = program.global_block()
    for op in block.ops:
        if op.type != "lookup_table" or \
                not op.desc.attrs.get("is_distributed"):
            continue
        for name in op.desc.inputs.get("W", []):
            var = block.vars.get(name)
            if var is not None and var.shape is not None:
                out[name] = tuple(var.shape)
    return out


def derive_table_specs(program, mesh, axis: Optional[str] = None
                       ) -> Dict[str, PartitionSpec]:
    """Row-shard specs for the program's distributed tables and their
    row-shaped accumulators (``<table>.moment1_0`` and the like: the same
    leading dim, so the sparse update stays in the shard).  ``axis``
    defaults to `EMBED_AXIS` when the mesh has it; a mesh without an
    embedding axis derives nothing, and a table whose rows the axis does
    not divide is skipped (the executor then raises)."""
    axis = axis or (EMBED_AXIS if EMBED_AXIS in mesh.shape else None)
    specs: Dict[str, PartitionSpec] = {}
    if axis is None or int(mesh.shape[axis]) <= 1:
        return specs
    n = int(mesh.shape[axis])
    tables = distributed_tables(program)
    for name, shape in tables.items():
        if len(shape) == 2 and shape[0] % n == 0:
            specs[name] = PartitionSpec(axis, None)
    for vname, var in program.global_block().vars.items():
        if not var.persistable or var.shape is None:
            continue
        for tname in tables:
            if (vname.startswith(tname + ".") and tname in specs
                    and len(var.shape) == 2
                    and var.shape[0] == tables[tname][0]):
                specs[vname] = PartitionSpec(axis, None)
    return specs


def bind_program_tables(partitioner, program) -> bool:
    """Attach the program's table placements to the partitioner's
    ``table_specs`` (idempotent) -> True when any is bound."""
    if partitioner is None:
        return False
    specs = derive_table_specs(program, partitioner.mesh)
    if specs:
        partitioner.bind_table_specs(specs)
    return bool(specs)


def _row_axis(part, spec) -> Optional[str]:
    """The one mesh axis (of size > 1) a pure row ``spec`` shards dim 0
    over, else None."""
    parts = tuple(spec or ())
    if not parts or parts[0] is None:
        return None
    first = parts[0]
    if isinstance(first, (tuple, list)):
        if len(first) != 1:
            return None
        first = first[0]
    if any(p is not None for p in parts[1:]):
        return None                 # only pure row sharding routes here
    if part.axis_size(first) <= 1:
        return None
    return str(first)


def table_row_axis(partitioner, name: str, shape) -> Optional[str]:
    """The mesh axis ``name``'s rows shard over under the partitioner
    (the trigger for the sharded lookup and update), or None for the
    dense path (no partitioner, one rank, a replicated table, or another
    sharding)."""
    if partitioner is None or not getattr(partitioner, "use_sharding",
                                          False):
        return None
    if shape is None or len(tuple(shape)) != 2:
        return None
    return _row_axis(partitioner, partitioner.param_spec(name,
                                                         tuple(shape)))


def row_sharded_state(program, part, specs) -> Dict[str, str]:
    """``{name: axis}`` of the state a step keeps in row shards: each
    table read only as a ``lookup_table`` ``W`` (by the forward; the
    backward and optimizer ops read it as a shard too) whose spec is pure
    row sharding, and its accumulators (``<table>.*``) sharded alike.  A
    table any other op reads is gathered at step entry as before."""
    lookups, other = set(), set()
    for block in program.blocks:
        for op in block.ops:
            for slot, names in op.desc.inputs.items():
                for n in names:
                    if n not in specs:
                        continue
                    if (op.type == "lookup_table" and slot == "W"
                            and block is program.global_block()):
                        lookups.add(n)
                    elif op.desc.attrs.get("op_role") != "optimize":
                        other.add(n)
    out = {}
    for name in lookups - other:
        axis = _row_axis(part, specs[name])
        if axis is not None:
            out[name] = axis
    for name, spec in specs.items():
        for table, axis in list(out.items()):
            if name.startswith(table + ".") and _row_axis(part,
                                                          spec) == axis:
                out[name] = axis
    return out


class RowTables:
    """One step's row-sharded state (module docstring).  ``axes`` maps
    each row-sharded table and accumulator to its axis; ``step`` is the
    fast-numerics `partitioner.StepSharding` (None under exact numerics,
    whose feeds are whole on every rank)."""

    def __init__(self, part, axes: Dict[str, str], step=None):
        self.part = part
        self.axes = dict(axes)
        self.step = step
        #: tables whose lookup took this rank's position block of the ids
        #: (fast a2a on the data axis): their gradient pairs stay blocks
        #: for the reverse exchange
        self.blocked: set = set()
        #: dense tables whose lookup backward gathered the gradient over
        #: the data axis (`StepSharding.reduce_gradients` skips their sum)
        self.complete: set = set()

    def axis_of(self, name: str) -> Optional[str]:
        return self.axes.get(name)

    def _on_data_axis(self, axis: str, block, ids_name: str) -> bool:
        """True when the ids are this rank's slice of the batch and the
        table shards over the data axis they were sliced on."""
        st = self.step
        return (st is not None and ids_name is not None
                and axis == st.part.data_axis and st.n_data > 1
                and st.placement(block, ids_name) == "rows")

    def lookup(self, block, name: str, table: torch.Tensor,
               ids: torch.Tensor, ids_name: Optional[str], scale=None
               ) -> torch.Tensor:
        """The ``lookup_table`` rule's rows of a row-sharded table: the
        psum lookup, or the exchange under ``lookup_exchange="a2a"``.  Ids
        sliced on the table's axis (fast numerics) are gathered for the
        psum lookup, whose rows are then cut back to the rank's slice, and
        are the rank's block for the exchange."""
        axis = self.axes[name]
        mesh = self.part.mesh
        group, nsh, index = coll.on_axis(mesh, axis)
        blocked = self._on_data_axis(axis, block, ids_name)
        d = table.shape[-1]
        if blocked and table.requires_grad and torch.is_grad_enabled():
            self.complete.add(name)
        if self.part.lookup_exchange == "a2a":
            if not blocked:
                return a2a_embedding_lookup(table, ids, mesh, axis,
                                            self.part.a2a_capacity, scale,
                                            gather_out=True)
            self.blocked.add(name)
            cap = resolve_a2a_capacity(self.part.a2a_capacity,
                                       ids.numel() * nsh, nsh)

            def lookup(t):
                return a2a_lookup_local(t, ids.reshape(-1), mesh, axis,
                                        nsh, cap, scale).reshape(
                    tuple(ids.shape) + (d,))
            return _maybe_grad(table, ids, lookup, mesh, axis, True, True)
        if not blocked:
            return sharded_embedding_lookup(table, ids, mesh, axis, scale)

        def lookup(t):
            whole = coll.all_gather(ids.contiguous(), group, axis, 0)
            rows = sharded_lookup_local(t, whole, mesh, axis, scale)
            return coll.local_slice(rows, 0, index, nsh)
        return _maybe_grad(table, ids, lookup, mesh, axis, True, True)

    def update(self, name: str, row_fn: Callable, tables, rows, values):
        """A sparse optimizer branch over row-sharded ``tables`` (the
        parameter ``name`` and its accumulators) from the raw SelectedRows
        pairs -> (owned rows' indices in the shard, new rows of each)."""
        from ..ops.optimizer_ops import merge_selected_rows
        axis = self.axes[name]
        mesh = self.part.mesh
        if self.part.lookup_exchange == "a2a":
            return sharded_row_update_a2a(
                mesh, axis, row_fn, tables, rows, values,
                self.part.a2a_capacity, blocked=name in self.blocked)
        total = tables[0].shape[0] * self.part.axis_size(axis)
        uniq, merged = merge_selected_rows(rows, values, total)
        return sharded_row_update(mesh, axis, row_fn, tables, uniq, merged)
