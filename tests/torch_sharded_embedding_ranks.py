"""Rank-side functions of tests/test_torch_sharded_embedding.py (run by
`_torch_mesh_pool.RankPool` on every rank of a gloo world; they import
the port only).  Every rank builds the same programs from the same seed,
so every rank holds the same global feeds; the functions return plain
numpy values for the test to compare with the JAX package."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, optimizer, serving
from paddle_tpu_torch.observability import introspect
from paddle_tpu_torch.parallel import collectives, create_mesh
from paddle_tpu_torch.parallel import embedding as emb
from paddle_tpu_torch.parallel.logical_axes import PartitionSpec as P
from paddle_tpu_torch.parallel.partitioner import Partitioner

# the JAX test's sizes
V, D = 64, 8
TABLE = "embedding_0.w_0"


def rank():
    return dist.get_rank()


def build(is_distributed, opt="adam", mp=False, v=V, d=D, bs=8, t=4,
          n_feeds=8, seed=0, dup_step=True, state_dir=None, ids_mod=None,
          neg=False, is_sparse=True):
    """The JAX test's model (embedding -> sum pool -> fc 2 softmax ->
    cross entropy) and feeds -> (exe, loss, feeds); ``state_dir`` loads
    the JAX package's initial state."""
    fluid.core.program.reset_default_programs()
    fluid.global_scope().clear()
    words = layers.data(name="words", shape=[1], dtype="int64", lod_level=1)
    e = layers.embedding(input=words, size=[v, d], is_sparse=is_sparse,
                         is_distributed=is_distributed)
    pooled = layers.sequence_pool(e, pool_type="sum")
    pred = layers.fc(input=pooled, size=2, act="softmax")
    label = layers.data(name="label", shape=[1], dtype="int64")
    loss = layers.mean(layers.cross_entropy(input=pred, label=label))
    o = {"adam": lambda: fluid.optimizer.Adam(learning_rate=1e-2),
         "sgd": lambda: fluid.optimizer.SGD(learning_rate=0.1),
         "momentum": lambda: fluid.optimizer.Momentum(
             learning_rate=0.1, momentum=0.9)}[opt]()
    if mp:
        o = optimizer.MixedPrecision(o)
    o.minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    if state_dir:
        fluid.io.load_persistables(exe, state_dir,
                                   fluid.default_main_program())
    return exe, loss, make_feeds(v, bs, t, n_feeds, seed, dup_step, ids_mod,
                                 neg)


def make_feeds(v=V, bs=8, t=4, n_feeds=8, seed=0, dup_step=True,
               ids_mod=None, neg=False):
    """The JAX test's seeded feeds (numpy, for both packages); with
    ``dup_step`` the first is all one id (the merge path), with ``neg``
    every other column's ids are written as their negative alias
    (``id - v``, which wraps)."""
    rng = np.random.RandomState(seed)
    feeds = [{"words": rng.randint(0, v, (bs, t)).astype(np.int32),
              "words@SEQ_LEN": np.full((bs,), t, np.int32),
              "label": rng.randint(0, 2, (bs, 1)).astype(np.int32)}
             for _ in range(n_feeds)]
    if dup_step:
        feeds[0]["words"][:] = 3
    if ids_mod:
        for f in feeds:
            f["words"] %= ids_mod
    if neg:
        for f in feeds:
            f["words"][:, ::2] -= v
    return feeds


def snapshot():
    """Every scope var, whole (a collective: every rank calls it)."""
    scope = fluid.global_scope()
    out = {}
    for n in sorted(scope.local_var_names()):
        v = scope.get(n)
        if v is None or n.startswith("@"):
            continue
        if isinstance(v, torch.Tensor):
            v = v.detach()
            v = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        out[n] = np.array(np.asarray(v))
    return out


def losses_of(handles):
    return [np.asarray(h.get()[0]) for h in handles]


def bitwise(a_losses, a_params, b_losses, b_params):
    """None when equal bit for bit, else what differs."""
    if len(a_losses) != len(b_losses):
        return f"{len(a_losses)} losses against {len(b_losses)}"
    for i, (a, b) in enumerate(zip(a_losses, b_losses)):
        if a.tobytes() != b.tobytes():
            return f"loss {i}: {a} != {b}"
    if set(a_params) != set(b_params):
        return f"vars differ: {set(a_params) ^ set(b_params)}"
    for n in a_params:
        if a_params[n].tobytes() != b_params[n].tobytes():
            return f"var {n}"
    return None


def reference(opt="adam", mp=False, steps=8, state_dir=None, **kw):
    """The port's single-process run (the plain is_sparse table)."""
    exe, loss, feeds = build(False, opt=opt, mp=mp, state_dir=state_dir,
                             **kw)
    losses = losses_of(exe.train_loop(feed=feeds, fetch_list=[loss],
                                      steps=steps))
    return losses, snapshot()


def _rule(name, shape):
    if len(shape) == 2 and shape[0] == V:
        return P("ep", None)
    return None


def train(opt="adam", mp=False, steps=8, k=1, mesh=None, numerics="exact",
          is_distributed=True, rule=None, exchange=None, capacity=None,
          plan=False, state_dir=None, **kw):
    """The port's single-process run and its run of the same build on
    ``mesh`` -> losses, params, their bitwise difference, launches, the
    report, the collectives ledger and the resident shapes."""
    ref_l, ref_p = reference(opt, mp, steps, state_dir, **kw)
    exe, loss, feeds = build(is_distributed, opt=opt, mp=mp,
                             state_dir=state_dir, **kw)
    if plan:
        capacity = emb.plan_a2a_capacity(
            [f["words"].reshape(-1) for f in feeds],
            int(mesh.get("ep", 1)), vocab=kw.get("v", V))
    since = introspect.count()
    collectives.reset_counts()
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=steps,
                             steps_per_launch=k, mesh=mesh,
                             numerics=numerics,
                             param_spec=_rule if rule else None,
                             lookup_exchange=exchange,
                             a2a_capacity=capacity)
    ledger = collectives.ledger()
    scope = fluid.global_scope()
    losses = losses_of(handles)
    reps = [r for r in introspect.reports(layer="executor", since_seq=since)
            if r["mesh_shape"]]
    params = snapshot()
    return {"ref_losses": ref_l, "losses": losses,
            "bitwise": bitwise(ref_l, ref_p, losses, params),
            "params": params if rank() == 0 else None,
            "launches": exe.launches, "capacity": capacity,
            "report": ({k2: reps[-1][k2] for k2 in (
                "mesh_shape", "num_devices", "argument_bytes",
                "temp_bytes", "collectives")} if reps else None),
            "ledger": ledger,
            "local_bytes": {n: scope.get_local(n).numpy().tobytes()
                            for n in (TABLE, "fc_0.w_0")},
            "resident": {n: tuple(scope.get_local(n).shape)
                         for n in scope.local_var_names()
                         if isinstance(scope.get_local(n), torch.Tensor)},
            "specs": {n: tuple(scope.sharding(n)[1])
                      for n in scope.local_var_names()
                      if scope.sharding(n)},
            "partitioner": (None if exe._partitioner is None else
                            exe._partitioner.describe())}


# ---------------------------------------------------------------------------
# the lookup and the exchange alone
# ---------------------------------------------------------------------------

def _mesh_ep(ep):
    """A mesh of the 4-rank world whose "ep" axis has ``ep`` ranks."""
    return create_mesh({"ep": 4} if ep == 4 else {"dp": 4 // ep, "ep": ep})


def lookup_bytes(seed=0):
    """The psum lookup of the JAX test's [32, 8] table at ep 2 and 4 ->
    the rows and the all-reduce bytes of each."""
    rng = np.random.RandomState(seed)
    table = torch.from_numpy(rng.randn(32, 8).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 32, (5, 7)).astype(np.int32))
    out = {}
    for ep in (2, 4):
        mesh = _mesh_ep(ep)
        shard = emb.shard_table(table, mesh, "ep")
        collectives.reset_counts()
        got = emb.sharded_embedding_lookup(shard, ids, mesh, "ep")
        led = collectives.ledger()
        out[ep] = {"rows": got.numpy(), "kinds": led["kinds"],
                   "shard": tuple(shard.shape)}
    return out


def out_of_range(seed=5):
    """ids [0, -1, -32, 31] and [32] through the ep=4 psum lookup and the
    exchange."""
    rng = np.random.RandomState(seed)
    table = torch.from_numpy(rng.randn(32, 4).astype(np.float32))
    mesh = _mesh_ep(4)
    shard = emb.shard_table(table, mesh, "ep")
    ids = torch.tensor([0, -1, -32, 31], dtype=torch.int64)
    over = torch.tensor([32, -33], dtype=torch.int64)
    return {"psum": emb.sharded_embedding_lookup(shard, ids, mesh).numpy(),
            "a2a": emb.a2a_embedding_lookup(shard, ids, mesh,
                                            gather_out=True).numpy(),
            "over_psum": emb.sharded_embedding_lookup(shard, over,
                                                      mesh).numpy(),
            "over_a2a": emb.a2a_embedding_lookup(shard, over, mesh,
                                                 gather_out=True).numpy()}


def minus_zero():
    """A table of ones with -0.0 entries (f32, and bf16 rows of an int8
    table's dequantization) through the ep=4 psum lookup and exchange."""
    table = np.ones((32, 8), np.float32)
    table[5, 2] = table[20, 0] = -0.0
    mesh = _mesh_ep(4)
    shard = emb.shard_table(torch.from_numpy(table), mesh)
    ids = torch.tensor([5, 20, 1], dtype=torch.int64)
    q = torch.ones((32, 8), dtype=torch.int8)
    q[5, 2] = 0
    scale = torch.full((8,), -1.0)             # 0 * -1 = -0.0
    qshard = emb.shard_table(q, mesh)
    return {"table": table,
            "psum": emb.sharded_embedding_lookup(shard, ids, mesh).numpy(),
            "a2a": emb.a2a_embedding_lookup(shard, ids, mesh,
                                            gather_out=True).numpy(),
            "int8": emb.sharded_embedding_lookup(qshard, ids, mesh,
                                                 scale=scale)
            .view(torch.int16).numpy()}


def parallel_lookup():
    """tests/test_parallel.py:58 at ep=4: V 64, D 16, seed 3."""
    mesh = _mesh_ep(4)
    rng = np.random.RandomState(3)
    table = rng.randn(64, 16).astype(np.float32)
    ids = rng.randint(0, 64, size=(5, 7))
    shard = emb.shard_table(torch.from_numpy(table), mesh, "ep")
    got = emb.sharded_embedding_lookup(shard, torch.from_numpy(ids), mesh,
                                       "ep")
    return {"got": got.numpy(), "want": table[ids]}


def grads_flow():
    """tests/test_parallel.py:70 at ep=4: d sum(rows**2) / d table of a
    [32, 8] table of ones for ids [1, 9, 30], each rank's shard
    gradient gathered."""
    mesh = _mesh_ep(4)
    shard = emb.shard_table(torch.ones((32, 8)), mesh, "ep")
    shard.requires_grad_(True)
    ids = torch.tensor([1, 9, 30])
    out = emb.sharded_embedding_lookup(shard, ids, mesh, "ep")
    (g,) = torch.autograd.grad((out ** 2).sum(), [shard])
    whole = collectives.all_gather(g, mesh.group("ep"), "ep", 0)
    return {"grad": whole.numpy(), "shard": tuple(g.shape)}


def all_to_all_bits():
    """The tiled all-to-all over the world: -0.0 and NaN payloads, the
    counted bytes."""
    mesh = _mesh_ep(4)
    r = rank()
    x = torch.tensor([[-0.0, float("nan")], [1.5 + r, -r], [r, 2.0],
                      [-0.0, 3.0 * r]], dtype=torch.float32)
    collectives.reset_counts()
    got = collectives.all_to_all(x, mesh.group("ep"), "ep")
    return {"sent": x.view(torch.int32).numpy(),
            "got": got.view(torch.int32).numpy(),
            "ledger": collectives.ledger()}


def placement():
    """derive_table_specs and table_row_axis on ep=4, the exchange knobs
    on the Partitioner and the refused policy."""
    exe, loss, feeds = build(True)
    prog = fluid.default_main_program()
    mesh = create_mesh({"ep": 4})
    specs = emb.derive_table_specs(prog, mesh)
    part = Partitioner(mesh={"ep": 4}, data_axis="ep", table_specs=specs)
    a2a = Partitioner(mesh={"ep": 4}, data_axis="ep", lookup_exchange="a2a",
                      a2a_capacity=3)
    try:
        Partitioner(mesh={"ep": 4}, data_axis="ep", lookup_exchange="gossip")
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"specs": {n: tuple(s) for n, s in specs.items()},
            "table_axis": emb.table_row_axis(part, TABLE, (V, D)),
            "fc_axis": emb.table_row_axis(part, "fc_0.w_0", (D, 2)),
            "a2a": (a2a.lookup_exchange, a2a.a2a_capacity,
                    a2a.describe().get("lookup_exchange")),
            "fp_differs": a2a.fingerprint() != Partitioner(
                mesh={"ep": 4}, data_axis="ep").fingerprint(),
            "refused": refused}


def refused_without_row_axis():
    exe, loss, feeds = build(True)
    try:
        exe.train_loop(feed=feeds, fetch_list=[loss], steps=2,
                       mesh={"dp": 4})
    except ValueError as e:
        return str(e)
    return None


def capacity(v=4096, d=64):
    """The JAX capacity test's table (4096 x 64) on ep=4, fast numerics:
    the report's per-rank bytes, the resident shapes and the largest
    collective of the steps."""
    exe, loss, feeds = build(True, v=v, d=d, bs=4, t=4, n_feeds=2)
    since = introspect.count()
    collectives.reset_counts()
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=2,
                             mesh={"ep": 4})
    led = collectives.ledger()
    reps = [r for r in introspect.reports(layer="executor", since_seq=since)
            if r["mesh_shape"] == {"ep": 4}]
    rep = max(reps, key=lambda r: r["flops"])
    scope = fluid.global_scope()
    grad_type = str(fluid.default_main_program().global_block()
                    .vars[TABLE + "@GRAD"].desc.type)
    return {"loss": losses_of(handles)[-1],
            "argument_bytes": rep["argument_bytes"],
            "temp_bytes": rep["temp_bytes"],
            "resident": {n: tuple(scope.get_local(n).shape)
                         for n in scope.local_var_names()
                         if n.startswith(TABLE)},
            "resident_bytes": sum(
                scope.get_local(n).numel() * 4
                for n in scope.local_var_names() if n.startswith(TABLE)
                and scope.get_local(n).dim() == 2),
            "kinds": led["kinds"], "grad_type": grad_type}


def checkpoint_restore(tmp, state_dir=None):
    """ep=4 exact training to step 4 with a shard-wise checkpoint, then a
    resume to step 8 on ep=1 and on a mesh whose ep axis has 2 ranks
    ({"dp": 2, "ep": 2}) -> the checkpoint's files and each resume's
    bitwise difference from the uninterrupted single-process run."""
    ref_l, ref_p = reference(state_dir=state_dir)
    out = {}
    for tag, mesh in (("ep1", {"ep": 1}), ("ep2", {"dp": 2, "ep": 2})):
        d = os.path.join(tmp, f"ckpt-{tag}")
        exe, loss, feeds = build(True, state_dir=state_dir)
        exe.train_loop(feed=feeds, fetch_list=[loss], steps=4,
                       mesh={"ep": 4}, numerics="exact", checkpoint_dir=d,
                       checkpoint_every=4)
        files = sorted(os.listdir(os.path.join(d, "ckpt-000004")))
        exe, loss, feeds = build(True, state_dir=state_dir)
        tail = losses_of(exe.train_loop(
            feed=feeds, fetch_list=[loss], steps=8, mesh=mesh,
            numerics="exact", resume_from=d))
        out[tag] = {"files": files,
                    "bitwise": bitwise(ref_l[4:], ref_p, tail, snapshot())}
    return out


def attribution(state_dir=None):
    """One psum step and one exchange step on {"dp": 2, "ep": 2}: the
    reports' psum share and roofline, the exchange's planned capacity."""
    from paddle_tpu_torch.observability import attribution as attr
    out = {}
    for exchange in ("psum", "a2a"):
        exe, loss, feeds = build(True, state_dir=state_dir)
        since = introspect.count()
        exe.train_loop(feed=feeds[:1], fetch_list=[loss], steps=1,
                       mesh={"dp": 2, "ep": 2}, numerics="exact",
                       lookup_exchange=exchange)
        rep = [r for r in introspect.reports(layer="executor",
                                             since_seq=since)][-1]
        # the card's roofs (the CPU has none): the classifier's
        # arithmetic over this report's counts
        out[exchange] = {"psum_share": attr.psum_share(rep),
                         "roofline": attr.roofline(
                             rep, device_name="NVIDIA H100 80GB HBM3"),
                         "collectives": rep["collectives"],
                         "bytes_accessed": rep["bytes_accessed"],
                         "ids": int(feeds[0]["words"].size)}
    return out


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def predict(model_dir, feed, meshes, cache_rows=0, numerics="fast"):
    """`Predictor` and `ShardedPredictor` replies for one feed on each of
    ``meshes`` -> the replies, the sharding info and the report."""
    want = serving.Predictor.from_model_dir(model_dir,
                                            device="cpu").run(dict(feed))[0]
    out = {"want": want}
    for i, mesh in enumerate(meshes):
        since = introspect.count()
        pred = serving.ShardedPredictor.from_model_dir(
            model_dir, device="cpu", mesh=mesh, numerics=numerics,
            embedding_cache_rows=cache_rows)
        got = pred.run(dict(feed))[0]
        reps = introspect.reports(layer="predictor", since_seq=since)
        rep = max(reps, key=lambda r: r["flops"]) if reps else {}
        out[i] = {"got": got, "info": pred.sharding_info(),
                  "cached": sorted(pred._row_caches),
                  "num_devices": rep.get("num_devices"),
                  "argument_bytes": rep.get("argument_bytes")}
    return out


def row_add():
    """sharded_row_add and sharded_row_add_a2a (the sgd forms) on ep=4
    against the whole table's scatter-add, pairs with duplicates and a
    negative id."""
    from paddle_tpu_torch.ops.optimizer_ops import merge_selected_rows
    mesh = _mesh_ep(4)
    rng = np.random.RandomState(11)
    table = torch.from_numpy(rng.randn(32, 4).astype(np.float32))
    rows = torch.tensor([3, 30, 3, -1, 17, 8, 30, 3], dtype=torch.int32)
    values = torch.from_numpy(rng.randn(8, 4).astype(np.float32))
    lr = torch.tensor(0.5)
    uniq, merged = merge_selected_rows(rows, values, 32)
    want = table.clone()
    want[uniq] += (-lr * merged).to(table.dtype)
    out = {"want": want.numpy()}
    for how in ("psum", "a2a"):
        shard = emb.shard_table(table, mesh)
        if how == "psum":
            local, new = emb.sharded_row_add(
                mesh, "ep", shard, uniq, (-lr * merged).to(shard.dtype))
        else:
            local, new = emb.sharded_row_add_a2a(mesh, "ep", shard, rows,
                                                 values, None, lr)
        shard.index_copy_(0, local, new)
        out[how] = collectives.all_gather(shard, mesh.group("ep"), "ep",
                                          0).numpy()
    return out


def dense_table(numerics, exchange=None, steps=6):
    """The model with a dense (not is_sparse) distributed table on ep=4
    and its single-process dense run -> losses, params, the table's
    resident shape."""
    exe, loss, feeds = build(False, is_sparse=False)
    ref_l = losses_of(exe.train_loop(feed=feeds, fetch_list=[loss],
                                     steps=steps))
    ref_p = snapshot()
    exe, loss, feeds = build(True, is_sparse=False)
    losses = losses_of(exe.train_loop(
        feed=feeds, fetch_list=[loss], steps=steps, mesh={"ep": 4},
        numerics=numerics, lookup_exchange=exchange))
    return {"ref_losses": ref_l, "losses": losses,
            "ref_params": ref_p if rank() == 0 else None,
            "params": snapshot(),
            "resident": tuple(fluid.global_scope().get_local(TABLE).shape)}
