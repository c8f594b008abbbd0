"""Rank-side functions of the port's mesh tests (run by
`_torch_mesh_pool.RankPool` on every rank of a gloo world; they import
the port only).  Each builds its programs from the same seed on every
rank, so every rank holds the same global feeds, and returns plain
numpy values for the test to compare with the JAX package."""
from __future__ import annotations

import json
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, optimizer
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.models import transformer
from paddle_tpu_torch.observability import introspect
from paddle_tpu_torch.parallel import (LogicalAxisRules, PartitionSpec as P,
                                       collectives, create_mesh, set_mesh,
                                       transformer_tp_rules)
from paddle_tpu_torch.parallel.partitioner import Partitioner

# the JAX test's transformer: d, 3d and d_ff pairwise distinct
V, T, B, D, F, H, L = 64, 16, 8, 32, 128, 4, 2


def _fresh():
    fluid.core.program.reset_default_programs()
    fluid.global_scope().clear()


def rank():
    return dist.get_rank()


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _load_state(exe, state_dir):
    """The JAX package's initial state (``save_persistables``), when
    given, so both packages start from the same parameters."""
    if state_dir:
        fluid.io.load_persistables(exe, state_dir,
                                   fluid.default_main_program())


def build_mlp(seed=0, mp=False, batch=8, steps=8, state_dir=None):
    """The partitioner tests' MLP + Adam (optionally MixedPrecision) ->
    (exe, loss, feeds)."""
    _fresh()
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(input=x, size=8, act="relu")
    pred = layers.fc(input=h, size=1)
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    opt = fluid.optimizer.Adam(learning_rate=0.01)
    if mp:
        opt = optimizer.MixedPrecision(opt)
    opt.minimize(loss)
    rng = np.random.RandomState(seed)
    feeds = [{"x": rng.rand(batch, 4).astype(np.float32),
              "y": rng.rand(batch, 1).astype(np.float32)}
             for _ in range(steps)]
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    _load_state(exe, state_dir)
    return exe, loss, feeds


def build_lm(steps=8, seed=0, batch=B, state_dir=None, **kw):
    """The model-parallel tests' transformer LM + Adam -> (exe, loss,
    feeds)."""
    _fresh()
    prog = fluid.default_main_program()
    prog.random_seed = seed
    shape = dict(vocab=V, max_len=T, n_layers=L, d_model=D, n_heads=H,
                 d_ff=F)
    shape.update(kw)
    _, _, loss = transformer.transformer_lm_train_program(**shape)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    _load_state(exe, state_dir)
    rng = np.random.RandomState(0)
    vocab, max_len = shape["vocab"], shape["max_len"]
    seqs = rng.randint(2, vocab, (steps * batch, max_len)).astype(np.int64)
    feeds = [{"tokens": seqs[i * batch:(i + 1) * batch],
              "labels": np.roll(seqs[i * batch:(i + 1) * batch], -1, 1)}
             for i in range(steps)]
    return exe, loss, feeds


def snapshot():
    """Every scope var, gathered (a collective: all ranks call it)."""
    scope = fluid.global_scope()
    out = {}
    for n in sorted(scope.local_var_names()):
        v = scope.get(n)
        if v is None or n.startswith("@"):
            continue
        if isinstance(v, torch.Tensor):
            v = v.detach().float() if v.dtype == torch.bfloat16 else \
                v.detach()
            v = v.cpu().numpy()
        out[n] = np.array(np.asarray(v))
    return out


def losses_of(handles):
    return [np.asarray(h.get()[0]) for h in handles]


def bitwise_equal(a_losses, a_params, b_losses, b_params):
    """None when equal bit for bit, else what differs."""
    for i, (a, b) in enumerate(zip(a_losses, b_losses)):
        if a.tobytes() != b.tobytes():
            return f"loss {i}: {a} != {b}"
    if set(a_params) != set(b_params):
        return f"vars differ: {set(a_params) ^ set(b_params)}"
    for n in a_params:
        if a_params[n].tobytes() != b_params[n].tobytes():
            return f"var {n}"
    return None


def reference(build, steps, **kw):
    """The port's single-process run of ``build`` (no mesh)."""
    exe, loss, feeds = build(steps=steps, **kw)
    losses = losses_of(exe.train_loop(feed=feeds, fetch_list=[loss],
                                      steps=steps))
    return losses, snapshot()


def resident_equal_across(name_filter=None):
    """True when every rank holds the same bytes in its resident state
    (data-parallel replicas after an averaged update)."""
    scope = fluid.global_scope()
    for n in sorted(scope.local_var_names()):
        v = scope.get_local(n)
        if not isinstance(v, torch.Tensor) or n.startswith("@"):
            continue
        if name_filter is not None and not name_filter(n):
            continue
        mine = v.detach().contiguous().view(-1).view(torch.uint8)
        theirs = collectives.all_gather(mine.clone(), dist.group.WORLD,
                                        "world", 0)
        parts = theirs.view(dist.get_world_size(), -1)
        if not all(torch.equal(parts[0], p) for p in parts):
            return False
    return True


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

_BUILDS = {"mlp": build_mlp, "lm": build_lm}


def _rules(kind):
    if kind == "tp":
        return transformer_tp_rules(D, F, vocab=V)
    if kind == "dp_default":
        return LogicalAxisRules.dp_default()
    if kind == "col8":
        def rule(name, shape):
            if name == "fc_0.w_0" and shape[-1] == 8:
                return P(None, "dp")
            return None
        return rule
    if kind == "col8_all":
        def rule(name, shape):
            # the fc weight and its Adam moments (same shape) shard
            if len(shape) == 2 and shape[-1] == 8:
                return P(None, "dp")
            return None
        return rule
    return None


def _report(since):
    reps = [r for r in introspect.reports(layer="executor",
                                          since_seq=since)
            if r["mesh_shape"]]
    if not reps:
        return None
    rep = max(reps, key=lambda r: r["flops"])
    return {k: rep[k] for k in ("mesh_shape", "num_devices", "steps",
                                "sharding_summary", "argument_bytes",
                                "temp_bytes", "output_bytes", "peak_bytes",
                                "collectives")}


def mesh_run(model, steps=8, k=1, mesh=None, numerics=None, rule=None,
             data_axis="dp", mp=False, batch=None, state_dir=None,
             reference_too=True, fetch_grads=(), **kw):
    """The port's single-process run and its run on ``mesh`` of the same
    build -> losses, params, their bitwise difference (None when equal),
    the launch count, the report and whether the ranks' replicated state
    is byte-equal."""
    build = _BUILDS[model]
    bkw = dict(kw)
    if model == "mlp":
        bkw["mp"] = mp
    if batch is not None:
        bkw["batch"] = batch
    out = {}
    if reference_too:
        exe, loss, feeds = build(steps=steps, state_dir=state_dir, **bkw)
        out["ref_losses"] = losses_of(exe.train_loop(
            feed=feeds, fetch_list=[loss], steps=steps))
        out["ref_params"] = snapshot()
    exe, loss, feeds = build(steps=steps, state_dir=state_dir, **bkw)
    since = introspect.count()
    collectives.reset_counts()
    handles = exe.train_loop(feed=feeds,
                             fetch_list=[loss] + list(fetch_grads),
                             steps=steps, steps_per_launch=k, mesh=mesh,
                             numerics=numerics, param_spec=_rules(rule),
                             data_axis=data_axis)
    out["losses"] = losses_of(handles)
    out["grads"] = [np.asarray(g) for g in handles[0].get()[1:]]
    out["launches"] = exe.launches
    out["report"] = _report(since)
    out["replicas_equal"] = resident_equal_across(
        lambda n: not fluid.global_scope().sharding(n))
    out["resident"] = {n: tuple(fluid.global_scope().get_local(n).shape)
                       for n in fluid.global_scope().local_var_names()
                       if isinstance(fluid.global_scope().get_local(n),
                                     torch.Tensor)}
    out["specs"] = {n: tuple(fluid.global_scope().sharding(n)[1])
                    for n in fluid.global_scope().local_var_names()
                    if fluid.global_scope().sharding(n)}
    out["params"] = snapshot()
    if reference_too:
        out["bitwise"] = bitwise_equal(out["ref_losses"], out["ref_params"],
                                       out["losses"], out["params"])
    out["partitioner"] = (None if exe._partitioner is None
                          else exe._partitioner.mesh_shape())
    return out


def lm_memory(state_dir=None):
    """dp=2 x tp=2 fast training at d128 f512: resident shapes, the
    report's per-rank bytes and the whole state's bytes."""
    d, f, vocab, max_len, batch = 128, 512, 256, 8, 2
    exe, loss, feeds = build_lm(steps=8, batch=batch, d_model=d, d_ff=f,
                                vocab=vocab, max_len=max_len,
                                state_dir=state_dir)
    scope = fluid.global_scope()
    full_bytes = sum(int(v.numel()) * v.element_size()
                     for n in scope.local_var_names()
                     for v in (scope.get_local(n),)
                     if isinstance(v, torch.Tensor))
    full_shapes = {n: tuple(scope.get_local(n).shape)
                   for n in scope.local_var_names()
                   if isinstance(scope.get_local(n), torch.Tensor)}
    since = introspect.count()
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=8,
                             mesh={"dp": 2, "tp": 2},
                             param_spec=transformer_tp_rules(d, f,
                                                             vocab=vocab))
    resident_bytes = sum(int(v.numel()) * v.element_size()
                         for n in scope.local_var_names()
                         for v in (scope.get_local(n),)
                         if isinstance(v, torch.Tensor))
    return {"losses": losses_of(handles), "full_bytes": full_bytes,
            "resident_bytes": resident_bytes, "full_shapes": full_shapes,
            "resident": {n: tuple(scope.get_local(n).shape)
                         for n in full_shapes},
            "specs": {n: tuple(scope.sharding(n)[1])
                      for n in full_shapes if scope.sharding(n)},
            "report": _report(since)}


def checkpoint_shards(tmp):
    """A rule-sharded dp=4 run checkpointed shard-wise: its files,
    manifest, the live state and the restore placed on other meshes."""
    d = os.path.join(tmp, "ckpt")
    exe, loss, feeds = build_mlp()
    exe.train_loop(feed=feeds, fetch_list=[loss], steps=8,
                   steps_per_launch=4, mesh={"dp": 4},
                   param_spec=_rules("col8_all"), checkpoint_dir=d,
                   checkpoint_every=8)
    live = snapshot()
    ck = os.path.join(d, "ckpt-000008")
    with open(os.path.join(ck, "manifest.json")) as f:
        man = json.load(f)
    restored = CheckpointManager(d).restore()
    placed = {}
    for axes in ({"dp": 4}, {"dp": 2, "tp": 2}, {"tp": 4}, {"dp": 1}):
        key = ",".join(f"{a}={n}" for a, n in axes.items())
        mesh = create_mesh(axes)
        placed[key] = {
            "specs": {n: tuple(s) for n, s in
                      restored.specs_on(mesh).items()},
            "w": restored.place(mesh=mesh)["fc_0.w_0"]}
    return {"files": sorted(os.listdir(ck)), "manifest": man,
            "live": live,
            "restored": {n: restored.arrays[n] for n in live},
            "placed": placed}


def resume_run(tmp, tag, first, second, steps=12, upto=8, model="mlp",
               every=None):
    """Train ``upto`` steps under ``first`` (train_loop keyword args)
    with checkpoints, then resume to ``steps`` under ``second`` ->
    (the resumed losses, the final params)."""
    d = os.path.join(tmp, tag)
    build = _BUILDS[model]
    first, second = dict(first), dict(second)
    for kw in (first, second):
        if "rule" in kw:
            kw["param_spec"] = _rules(kw.pop("rule"))
    exe, loss, feeds = build(steps=steps)
    exe.train_loop(feed=feeds, fetch_list=[loss], steps=upto,
                   checkpoint_dir=d, checkpoint_every=every or upto,
                   **first)
    exe, loss, feeds = build(steps=steps)
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=steps,
                             resume_from=d, **second)
    return {"losses": losses_of(handles), "params": snapshot(),
            "files": sorted(os.listdir(os.path.join(
                d, f"ckpt-{upto:06d}")))}


def chain_run(tmp):
    """dp=4 -> dp=2 x tp=2 (one K=4 window) -> tp=4 -> dp=1, exact, each
    leg resuming the previous leg's checkpoint -> the legs' losses and
    the final params, beside the single-process run's."""
    steps = 16
    ref_l, ref_p = reference(build_lm, steps)
    d = os.path.join(tmp, "chain")
    legs = [
        (4, dict(mesh={"dp": 4}, numerics="exact")),
        (8, dict(mesh={"dp": 2, "tp": 2}, param_spec=_rules("tp"),
                 numerics="exact", steps_per_launch=4)),
        (12, dict(mesh={"tp": 4}, data_axis="tp", param_spec=_rules("tp"),
                  numerics="exact")),
        (16, dict(mesh={"dp": 1}, numerics="exact")),
    ]
    tails = []
    for upto, kw in legs:
        exe, loss, feeds = build_lm(steps=steps)
        handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=upto,
                                 resume_from=(d if upto > 4 else None),
                                 checkpoint_dir=d, checkpoint_every=4,
                                 **kw)
        tails.append(losses_of(handles)[-4:])
    return {"ref_losses": ref_l, "ref_params": ref_p, "tails": tails,
            "params": snapshot(), "dirs": sorted(os.listdir(d))}


def partial_coverage(tmp):
    d = os.path.join(tmp, "partial")
    exe, loss, feeds = build_mlp()
    exe.train_loop(feed=feeds, fetch_list=[loss], steps=4, mesh={"dp": 4},
                   param_spec=_rules("col8_all"), checkpoint_dir=d,
                   checkpoint_every=4)
    dist.barrier()
    ck = os.path.join(d, "ckpt-000004")
    man_path = os.path.join(ck, "manifest.json")
    if rank() == 0:
        with open(man_path) as f:
            man = json.load(f)
        shards = man["vars"]["fc_0.w_0"]["shards"]
        man["vars"]["fc_0.w_0"]["shards"] = shards[:-1]
        with open(man_path, "w") as f:
            json.dump(man, f)
    dist.barrier()
    try:
        CheckpointManager(d).restore()
    except ValueError as e:
        return str(e)
    return None


def torn_shard_save(tmp):
    """A dp=4 shard-wise checkpoint at step 4, then one at step 8 whose
    first write fails on rank 1 only -> each rank's error, the
    checkpoint dir's entries and the step a fresh manager restores."""
    from paddle_tpu_torch import fault
    d = os.path.join(tmp, "torn")
    kw = dict(fetch_list=None, mesh={"dp": 4},
              param_spec=_rules("col8_all"), checkpoint_dir=d,
              checkpoint_every=4)
    exe, loss, feeds = build_mlp()
    kw["fetch_list"] = [loss]
    exe.train_loop(feed=feeds, steps=4, **kw)
    exe, loss, feeds = build_mlp()
    kw["fetch_list"] = [loss]
    if rank() == 1:
        fault.arm("checkpoint.write:raise")
    error = None
    try:
        losses_of(exe.train_loop(feed=feeds, steps=8, resume_from=d, **kw))
    except Exception as e:  # noqa: BLE001 - reported to the test
        error = f"{type(e).__name__}: {e}"
    finally:
        fault.reset()
    dist.barrier()
    return {"error": error, "entries": sorted(os.listdir(d)),
            "restored": CheckpointManager(d).restore().step}


def switch_partitioners():
    """One executor under dp=4, dp=2 x tp=2, no partitioner, then dp=4
    again: each step finite, the state placed again each time."""
    exe, loss, feeds = build_mlp()
    scope = fluid.global_scope()
    out = []
    fps = []
    for axes in ({"dp": 4}, {"dp": 2, "tp": 2}, None, {"dp": 4}):
        part = None if axes is None else Partitioner(
            mesh=axes, param_spec=_rules("col8"))
        exe.set_partitioner(part)
        val = exe.run(feed=feeds[0], fetch_list=[loss])[0]
        out.append((np.isfinite(val).all(), scope.sharding("fc_0.w_0")
                    is not None,
                    tuple(scope.get_local("fc_0.w_0").shape)))
        fps.append(None if part is None else part.fingerprint())
    return {"steps": out, "fingerprints_distinct": len({
        f for f in fps[:3] if f is not None}) == 2}


def process_mesh():
    ref_l, ref_p = reference(build_mlp, 8)
    set_mesh(create_mesh({"dp": 4}))
    try:
        exe, loss, feeds = build_mlp()
        handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=8,
                                 numerics="exact")
        shape = exe._partitioner.mesh_shape()
        return {"shape": shape,
                "bitwise": bitwise_equal(ref_l, ref_p, losses_of(handles),
                                         snapshot())}
    finally:
        set_mesh(None)


def rule_contract():
    from paddle_tpu_torch.parallel import partitioner as pmod
    from paddle_tpu_torch.parallel.partitioner import (parse_mesh_axes,
                                                       spec_fits)
    from paddle_tpu_torch.serving import sharded as smod
    part = Partitioner(mesh={"dp": 4},
                       param_spec=lambda n, s: P("dp") if n == "w" else None)
    mesh = create_mesh({"dp": 4})
    out = {"shared": smod.ParamSpecRule is pmod.ParamSpecRule,
           "w8": tuple(part.param_spec("w", (8,))),
           "b8": tuple(part.param_spec("b", (8,))),
           "w7": tuple(part.param_spec("w", (7,))),
           "fits": spec_fits(P("dp"), (8, 3), mesh),
           "not_fits": spec_fits(P(None, "dp"), (8, 3), mesh),
           "parse": parse_mesh_axes("dp=2,tp=4"),
           "none": parse_mesh_axes("none")}
    try:
        parse_mesh_axes("dp=banana")
        out["bad"] = None
    except ValueError as e:
        out["bad"] = str(e)
    try:
        Partitioner(mesh={"dp": 2})
        out["size_error"] = None
    except ValueError as e:
        out["size_error"] = str(e)
    return out


def rule_miss_warnings():
    """The one-time REPLICATED warning under a typo'd table, and none
    under the real one."""
    records = []

    class _H(logging.Handler):
        def emit(self, r):
            records.append(r.getMessage())

    h = _H(level=logging.WARNING)
    lg = logging.getLogger("paddle_tpu_torch.parallel.partitioner")
    lg.addHandler(h)
    try:
        typo = LogicalAxisRules(
            axis_rules=(("embed", None), ("mlp", "tp")),
            param_rules=((r"totally_wrong_name:\d+x\d+",
                          ("embed", "mlp")),), name="typo")
        exe, loss, feeds = build_lm(steps=2)
        exe.train_loop(feed=feeds, fetch_list=[loss], steps=2,
                       mesh={"dp": 2, "tp": 2}, param_spec=typo)
        first = [m for m in records if "REPLICATED" in m]
        records.clear()
        exe, loss, feeds = build_lm(steps=2)
        exe.train_loop(feed=feeds, fetch_list=[loss], steps=2,
                       mesh={"dp": 2, "tp": 2}, param_spec=_rules("tp"))
        second = [m for m in records if "REPLICATED" in m]
    finally:
        lg.removeHandler(h)
    return {"first": first, "second": second}


def mesh_factories():
    from paddle_tpu_torch.parallel import create_training_mesh
    mesh = create_training_mesh({"dp": 2, "tp": 2})
    part = Partitioner(mesh="dp=2,tp=2")
    fp = part.fingerprint()
    return {"shape": dict(mesh.shape), "order": tuple(mesh.shape),
            "size": mesh.devices.size, "coords": mesh.coords,
            "part_shape": part.mesh_shape(), "data_axis": part.data_axis,
            "num_devices": part.num_devices,
            "fp_differs_dp4": fp != Partitioner(mesh="dp=4").fingerprint(),
            "fp_differs_rules": Partitioner(
                mesh="dp=2,tp=2", param_spec=_rules("tp")).fingerprint()
            != fp,
            "group_sizes": {a: dist.get_world_size(mesh.group(a))
                            for a in mesh.axis_names}}


def collectives_check():
    """The collectives against their definitions, bit-exact gathers
    (-0.0 and NaN payloads included) and the counts."""
    mesh = create_mesh({"dp": 2, "tp": 2})
    r = rank()
    collectives.reset_counts()
    x = torch.tensor([-0.0, float("nan"), 1.5 + r, -r], dtype=torch.float32)
    g = collectives.all_gather(x, mesh.group("tp"), "tp", 0)
    bf = torch.tensor([-0.0, 3.0 + r], dtype=torch.bfloat16)
    gb = collectives.all_gather(bf, mesh.group("dp"), "dp", 0)
    s = collectives.all_reduce(torch.tensor([float(r)]), mesh.group("dp"),
                               "dp")
    m = collectives.all_reduce(torch.tensor([r]), mesh.world_group(),
                               "world", op="max")
    # Megatron's f and g: forward and backward
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    y = collectives.copy_to(w * (r + 1), mesh.group("tp"), "tp")
    gw, = torch.autograd.grad(y.sum(), w)
    z = torch.tensor([1.0 + r], requires_grad=True)
    out = collectives.reduce_from(z * 2, mesh.group("tp"), "tp")
    gz, = torch.autograd.grad(out.sum(), z)
    led = collectives.ledger()
    return {"gather": g.view(torch.int32).tolist(),
            "gather_bf16": gb.view(torch.int16).tolist(),
            "sum": s.tolist(), "max": m.tolist(), "f_grad": gw.tolist(),
            "g_out": out.tolist(), "g_grad": gz.tolist(),
            "ledger": led, "coords": mesh.coords}


def dp_step_collectives(state_dir=None):
    """One fast dp=4 SGD step of the JAX test's MLP: the gradient
    all-reduces the step makes, by kind and axis."""
    _fresh()
    x = layers.data(name="x", shape=[64], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(input=x, size=256, act="relu")
    h = layers.fc(input=h, size=256, act="relu")
    p = layers.fc(input=h, size=1)
    d = layers.elementwise_sub(p, y)
    cost = layers.mean(layers.elementwise_mul(d, d))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    main = fluid.default_main_program()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    from paddle_tpu_torch.parallel import DistributeTranspiler
    DistributeTranspiler().transpile(main, create_mesh({"dp": 4}))
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(64, 64).astype(np.float32),
            "y": rng.rand(64, 1).astype(np.float32)}
    since = introspect.count()
    exe.train_loop(feed=[feed], fetch_list=[cost], steps=1,
                   mesh={"dp": 4})
    rep = _report(since)
    return rep["collectives"]


def transpiler_zero(state_dir=None, steps=4):
    """transpile(zero_stage=1) on dp=4 through ParallelExecutor: the
    Adam moments hold a quarter of their rows per rank, the parameters
    stay whole and equal on every rank -> losses and params."""
    from paddle_tpu_torch.parallel import (DistributeTranspiler,
                                           ParallelExecutor)
    exe, loss, feeds = build_mlp(steps=steps, state_dir=state_dir)
    main = fluid.default_main_program()
    specs = DistributeTranspiler().transpile(main, create_mesh({"dp": 4}),
                                             zero_stage=1)
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          mesh={"dp": 4})
    losses = [pe.run(fetch_list=[loss], feed=f)[0] for f in feeds]
    scope = fluid.global_scope()
    return {"losses": losses,
            "specs": {n: tuple(s) for n, s in specs.items()},
            "resident": {n: tuple(scope.get_local(n).shape)
                         for n in scope.local_var_names()
                         if isinstance(scope.get_local(n), torch.Tensor)},
            "replicas_equal": resident_equal_across(
                lambda n: not scope.sharding(n)),
            "params": snapshot(), "device_count": pe.device_count}


def parallel_executor_sgd(state_dir):
    """The JAX test's one SGD step through ParallelExecutor (dp over the
    world) -> w1 after the step."""
    from paddle_tpu_torch.parallel import ParallelExecutor
    _fresh()
    x = layers.data(name="x", shape=[16], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    h = layers.fc(input=x, size=32, act="relu",
                  param_attr=fluid.ParamAttr(name="w1"),
                  bias_attr=fluid.ParamAttr(name="b1"))
    p = layers.fc(input=h, size=1, param_attr=fluid.ParamAttr(name="w2"),
                  bias_attr=fluid.ParamAttr(name="b2"))
    d = layers.elementwise_sub(p, y)
    cost = layers.mean(layers.elementwise_mul(d, d))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    _load_state(exe, state_dir)
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(16, 16).astype(np.float32),
            "y": rng.randn(16, 1).astype(np.float32)}
    pe = ParallelExecutor(use_cuda=False, loss_name=cost.name)
    pe.run(fetch_list=[cost], feed=feed)
    return {"count": pe.device_count,
            "w1": fluid.global_scope().get("w1").numpy()}


def loss_kind_program(fl, kind):
    """The MLP + SGD under a loss of ``kind`` ("sum", "rows", "scaled_mean"
    or "max" over the squared errors), built by the front end of package
    ``fl`` (either package) -> the loss var."""
    x = fl.layers.data(name="x", shape=[4], dtype="float32")
    y = fl.layers.data(name="y", shape=[1], dtype="float32")
    h = fl.layers.fc(input=x, size=8, act="relu")
    pred = fl.layers.fc(input=h, size=1)
    err = fl.layers.square_error_cost(input=pred, label=y)
    loss = {"sum": lambda: fl.layers.reduce_sum(err),
            "rows": lambda: err,
            "scaled_mean": lambda: fl.layers.scale(fl.layers.mean(err),
                                                   scale=2.0, bias=1.0),
            "max": lambda: fl.layers.reduce_max(err)}[kind]()
    fl.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


def loss_kind_feeds(steps=4, batch=8):
    rng = np.random.RandomState(3)
    return [{"x": rng.rand(batch, 4).astype(np.float32),
             "y": rng.rand(batch, 1).astype(np.float32)}
            for _ in range(steps)]


def loss_kind_run(kind, state_dir, mesh, numerics=None, steps=4):
    """`loss_kind_program` trained on ``mesh`` from the JAX package's
    initial state -> losses and params, or the error it raised."""
    _fresh()
    loss = loss_kind_program(fluid, kind)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    _load_state(exe, state_dir)
    try:
        losses = losses_of(exe.train_loop(
            feed=loss_kind_feeds(steps), fetch_list=[loss], steps=steps,
            mesh=mesh, numerics=numerics))
    except ValueError as e:
        return {"error": str(e)}
    return {"losses": losses, "params": snapshot()}


def parallel_do_dp(state_dir=None):
    """A ParallelDo MLP trained fast on dp=4 and single-process -> both
    runs' losses."""
    def build(steps=4, state_dir=None):
        _fresh()
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        places = layers.get_places(device_count=1, device_type="CPU")
        pd = layers.ParallelDo(places)
        with pd.do():
            xi, yi = pd.read_input(x), pd.read_input(y)
            h = layers.fc(input=xi, size=8, act="relu")
            pred = layers.fc(input=h, size=1)
            pd.write_output(layers.square_error_cost(input=pred, label=yi))
        loss = layers.mean(pd())
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        rng = np.random.RandomState(1)
        feeds = [{"x": rng.rand(8, 4).astype(np.float32),
                  "y": rng.rand(8, 1).astype(np.float32)}
                 for _ in range(steps)]
        return exe, loss, feeds
    exe, loss, feeds = build()
    ref = losses_of(exe.train_loop(feed=feeds, fetch_list=[loss], steps=4))
    exe, loss, feeds = build()
    collectives.reset_counts()
    got = losses_of(exe.train_loop(feed=feeds, fetch_list=[loss], steps=4,
                                   mesh={"dp": 4}))
    return {"ref": ref, "got": got, "ledger": collectives.ledger()}


def amp_overflow_skip():
    """Fast dp=4 MixedPrecision with an inf in one rank's slice of step
    1: every rank skips the step, the loss scales stay equal."""
    exe, loss, feeds = build_mlp(mp=True, steps=3)
    feeds[1]["x"][5, 0] = np.inf      # rows 4-5 are rank 2's slice
    main = fluid.default_main_program()
    ls = main._loss_scaling
    before = None
    scales = []
    for i, f in enumerate(feeds):
        exe.train_loop(feed=[f], fetch_list=[loss], steps=1,
                       mesh={"dp": 4})
        scales.append(float(fluid.global_scope().get(ls["scale"])
                            .reshape(-1)[0]))
        if i == 0:
            before = fluid.global_scope().get("fc_0.w_0").clone()
        if i == 1:
            after = fluid.global_scope().get("fc_0.w_0").clone()
    return {"scales": scales, "unchanged": bool(torch.equal(before, after)),
            "replicas_equal": resident_equal_across()}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def sharded_predict(model_dir, feed, mesh, rule=None, numerics="fast",
                    lm=False):
    """`ShardedPredictor` and `Predictor` replies for one feed (SPMD:
    every rank runs it) -> both, the sharding info and stats."""
    from paddle_tpu_torch import serving
    want = serving.Predictor.from_model_dir(
        model_dir, device="cpu").run(feed)[0]
    if rule == "dp_col8":
        def param_rule(name, shape):
            if name.endswith("w_0") and shape[-1] == 8:
                return P(None, "dp")
            return None
    else:
        param_rule = _rules(rule)
    pred = serving.ShardedPredictor.from_model_dir(
        model_dir, device="cpu", mesh=mesh, param_spec=param_rule,
        numerics=numerics)
    got = pred.run(feed)[0]
    out = {"want": want, "got": got, "info": pred.sharding_info(),
           "stats_sharding": pred.stats()["sharding"],
           "fingerprint": pred.partitioner.fingerprint()}
    if isinstance(feed, dict) and "x" in feed:
        pred.run({"x": np.vstack([feed["x"], feed["x"][:1]])})
        out["shapes_seen"] = pred.stats()["shapes_seen"]
    return out


def sharded_lm_predict(model_dir, tokens):
    """The LM's logits through exact and fast dp=2 x tp=2 sharded
    predictors under the tp table, beside the `Predictor`'s."""
    from paddle_tpu_torch import serving
    feed = {"tokens": tokens}
    want = serving.Predictor.from_model_dir(
        model_dir, device="cpu").run(feed)[0]
    exact = serving.ShardedPredictor.from_model_dir(
        model_dir, device="cpu", mesh={"dp": 2, "tp": 2},
        param_spec=_rules("tp"), numerics="exact").run(feed)[0]
    fast = serving.ShardedPredictor.from_model_dir(
        model_dir, device="cpu", mesh={"dp": 2, "tp": 2},
        param_spec=_rules("tp"))
    got = fast.run(feed)[0]
    dp_only = serving.ShardedPredictor.from_model_dir(
        model_dir, device="cpu", mesh={"dp": 4})
    return {"want": want, "exact": exact, "fast": got,
            "info": fast.sharding_info(),
            "fp_distinct": fast.partitioner.fingerprint()
            != dp_only.partitioner.fingerprint()}


def serve_through_endpoint(model_dir, feed):
    """Rank 0 serves the model behind `InferenceServer` over a dp=4
    registry load; ranks 1-3 follow its batches -> rank 0's reply,
    listing and metrics."""
    from paddle_tpu_torch import serving
    if rank() != 0:
        pred = serving.ShardedPredictor.from_model_dir(
            model_dir, device="cpu", mesh={"dp": 4})
        pred.follow()
        return None
    reg = serving.ModelRegistry(device="cpu")
    reg.load("big", model_dir, mesh={"dp": 4},
             engine_opts={"max_queue_delay_ms": 5, "max_batch_size": 8})
    server = serving.InferenceServer(reg, port=0, port_file=None).start()
    try:
        ep = f"127.0.0.1:{server.port}"
        out = serving.infer_round_trip(ep, {"x": feed}, model="big")
        listing = serving.list_models(ep)
        metrics = serving.serving_metrics(ep)
    finally:
        server.stop()
        reg.close()
    return {"reply": next(iter(out.values())),
            "sharding": listing["models"]["big"]["sharding"],
            "dispatches": 'engine_dispatches_total{model="big"}' in metrics}


def data_axis_fallback():
    from paddle_tpu_torch import serving
    _fresh()
    x = layers.data(name="x", shape=[2], dtype="float32")
    y = layers.scale(x=x, scale=2.0)
    pred = serving.ShardedPredictor(fluid.default_main_program(), ["x"],
                                    [y], mesh={"tp": 4}, device="cpu")
    return pred.data_axis
