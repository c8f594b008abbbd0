"""Checkpoints, resume, fault points and flags of the port (twins of
tests/test_checkpoint_resume.py, tests/test_flags.py and the
fault-point tests of tests/test_fault_tolerance.py), the checkpoint
layout shared with the JAX package in both directions, and the
``train`` and ``checkpoints`` verbs.

In the port a resumed run's losses are bitwise those of the
uninterrupted run; across packages the resumed losses agree to 1e-4
(whole models, ROADMAP).
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from paddle_tpu_torch import fault
from paddle_tpu_torch.checkpoint import CheckpointManager
from paddle_tpu_torch.flags import FLAGS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port():
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    fault.reset()
    yield
    fault.reset()


def _build(fl=fluid):
    layers = fl.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    pred = layers.fc(input=x, size=1, param_attr=fl.ParamAttr(name="w"))
    loss = layers.mean(layers.square_error_cost(input=pred, label=y))
    fl.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return loss


def _feed_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    w_true = np.random.RandomState(99).rand(4, 1).astype(np.float32)
    out = []
    for _ in range(n):
        xs = rng.rand(16, 4).astype(np.float32)
        out.append({"x": xs, "y": (xs @ w_true).astype(np.float32)})
    return out


def _fresh_model():
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    loss = _build()
    exe = fluid.Executor(CPU)
    exe.run(fluid.default_startup_program())
    return exe, loss


def _losses(handles):
    return [float(h.get()[0]) for h in handles]


# -- twins of tests/test_checkpoint_resume.py -------------------------------

def test_resume_matches_uninterrupted_run(tmp_path):
    """save_persistables / load_persistables carry the Adam moments."""
    ckpt = str(tmp_path / "ckpt")
    feeds = _feed_batches(20)
    exe, loss = _fresh_model()
    losses_a = [float(exe.run(feed=f, fetch_list=[loss])[0]) for f in feeds]
    exe, loss = _fresh_model()
    for f in feeds[:10]:
        exe.run(feed=f, fetch_list=[loss])
    fluid.io.save_persistables(exe, ckpt)
    exe, loss = _fresh_model()
    fluid.io.load_persistables(exe, ckpt)
    losses_b = [float(exe.run(feed=f, fetch_list=[loss])[0])
                for f in feeds[10:]]
    assert losses_b == losses_a[10:]


def test_checkpoint_contains_optimizer_state(tmp_path):
    ckpt = str(tmp_path / "ckpt2")
    exe, loss = _fresh_model()
    for f in _feed_batches(3):
        exe.run(feed=f, fetch_list=[loss])
    fluid.io.save_persistables(exe, ckpt)
    files = os.listdir(ckpt)
    assert any("moment" in f for f in files), files
    assert any(f.startswith("w") for f in files), files


def test_manager_roundtrip_retention_and_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"), keep_last_n=2)
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "m": np.float32(3.5), "n": torch.tensor([7], dtype=torch.int64)}
    for step in (2, 4, 6):
        mgr.save(step, state, reader_position=step, block=True)
    mgr.close()
    assert mgr.steps() == [4, 6]
    r = mgr.restore()
    assert r.step == 6 and r.reader_position == 6
    np.testing.assert_array_equal(r.arrays["w"], state["w"].numpy())
    np.testing.assert_array_equal(r.arrays["m"], state["m"])
    assert r.arrays["n"].dtype == np.int64
    with open(os.path.join(r.path, "manifest.json")) as f:
        m = json.load(f)
    assert m["vars"]["w"] == {"shape": [2, 3], "dtype": "float32",
                              "spec": []}


def test_save_snapshots_before_in_place_updates(tmp_path):
    """save() clones: updating the live tensor right after it (as the
    next step does in place) leaves the checkpoint's values alone."""
    mgr = CheckpointManager(str(tmp_path / "c"))
    w = torch.ones(1000)
    mgr.save(1, {"w": w})
    w.mul_(7)
    mgr.wait()
    mgr.close()
    assert (mgr.restore().arrays["w"] == 1).all()


def test_train_loop_checkpoints_and_resume_matches_uninterrupted(tmp_path):
    feeds = _feed_batches(20)
    exe, loss = _fresh_model()
    ref = _losses(exe.train_loop(fluid.default_main_program(), feeds,
                                 [loss], steps=20))
    d = str(tmp_path / "ckpt")
    exe, loss = _fresh_model()
    exe.train_loop(fluid.default_main_program(), feeds, [loss], steps=12,
                   checkpoint_dir=d, checkpoint_every=5)
    committed = CheckpointManager(d).steps()
    assert committed[-1] == 10 and set(committed) <= {5, 10}
    exe, loss = _fresh_model()
    handles = exe.train_loop(fluid.default_main_program(), feeds, [loss],
                             steps=20, resume_from=d, checkpoint_every=5)
    assert [h.step for h in handles] == list(range(10, 20))
    assert _losses(handles) == ref[10:]
    assert CheckpointManager(d).latest_step() == 20


def test_fault_interrupt_at_step_6_then_resume_to_12_is_bitwise(tmp_path):
    """A run killed by the train.step fault point at step 6 (checkpoints
    every 3 steps) resumes to 12 with the uninterrupted losses, bit for
    bit; the flight recorder dumps beside the checkpoints."""
    feeds = _feed_batches(12, seed=1)
    exe, loss = _fresh_model()
    ref = _losses(exe.train_loop(feed=feeds, fetch_list=[loss], steps=12))
    d = str(tmp_path / "ck")
    exe, loss = _fresh_model()
    fault.arm("train.step@7:raise")
    with pytest.raises(fault.FaultInjected):
        exe.train_loop(feed=feeds, fetch_list=[loss], steps=12,
                       checkpoint_dir=d, checkpoint_every=3)
    fault.reset()
    assert CheckpointManager(d).latest_step() == 6
    with open(os.path.join(d, "flight_recorder.json")) as f:
        assert "FaultInjected" in json.load(f)["reason"]
    exe, loss = _fresh_model()
    handles = exe.train_loop(feed=feeds, fetch_list=[loss], steps=12,
                             resume_from=d)
    assert [h.step for h in handles] == list(range(6, 12))
    assert _losses(handles) == ref[6:]


def test_resume_restores_the_generator_state(tmp_path):
    """Dropout draws from the executor's generator, whose state rides the
    checkpoint: a resumed run draws the masks the uninterrupted one
    drew."""
    def build():
        fluid.core.program.reset_default_programs()
        fluid.core.scope._global_scope = fluid.core.scope.Scope()
        layers = fluid.layers
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        h = layers.dropout(layers.fc(input=x, size=16), dropout_prob=0.5)
        loss = layers.mean(layers.square_error_cost(
            input=layers.fc(input=h, size=1), label=y))
        fluid.optimizer.SGD(0.05).minimize(loss)
        exe = fluid.Executor(CPU)
        exe.run(fluid.default_startup_program())
        return exe, loss
    feeds = _feed_batches(8, seed=2)
    exe, loss = build()
    ref = _losses(exe.train_loop(feed=feeds, fetch_list=[loss], steps=8))
    d = str(tmp_path / "ck")
    exe, loss = build()
    exe.train_loop(feed=feeds, fetch_list=[loss], steps=4,
                   checkpoint_dir=d, checkpoint_every=4)
    exe, loss = build()
    assert _losses(exe.train_loop(feed=feeds, fetch_list=[loss], steps=8,
                                  resume_from=d)) == ref[4:]


def test_resume_from_empty_dir_is_cold_start(tmp_path):
    feeds = _feed_batches(6)
    exe, loss = _fresh_model()
    ref = _losses(exe.train_loop(fluid.default_main_program(), feeds,
                                 [loss], steps=6))
    exe, loss = _fresh_model()
    got = _losses(exe.train_loop(fluid.default_main_program(), feeds,
                                 [loss], steps=6,
                                 resume_from=str(tmp_path / "nothing")))
    assert got == ref
    assert not os.path.exists(str(tmp_path / "nothing"))


def test_async_save_runs_off_thread_and_adds_no_host_sync(tmp_path):
    from paddle_tpu_torch.observability import default_registry
    reg = default_registry()
    was = reg.enabled
    reg.enable()
    try:
        feeds = _feed_batches(8)
        hist = reg.histogram("executor_host_gap_seconds",
                             "host time between consecutive step dispatches")
        saves = reg.counter("checkpoint_saves_total",
                            "checkpoint commits by outcome",
                            labelnames=("outcome",))
        committed = saves.labels(outcome="committed")
        superseded = saves.labels(outcome="superseded")
        base = hist._series[()]
        exe, loss = _fresh_model()
        n0 = base.count
        exe.train_loop(fluid.default_main_program(), feeds, [loss], steps=8)
        plain_gaps = base.count - n0
        exe, loss = _fresh_model()
        commits0, drops0 = committed.value, superseded.value
        n0 = base.count
        d = str(tmp_path / "c")
        exe.train_loop(fluid.default_main_program(), feeds, [loss], steps=8,
                       checkpoint_dir=d, checkpoint_every=2)
        assert base.count - n0 == plain_gaps
        commits = committed.value - commits0
        drops = superseded.value - drops0
        assert commits + drops == 4 and commits >= 1
        assert CheckpointManager(d).latest_step() == 8
        m2 = CheckpointManager(str(tmp_path / "c2"))
        m2.save(1, {"w": torch.ones(3)})
        m2.wait()
        assert m2.writer_thread_ident not in (None, threading.get_ident())
        m2.close()
    finally:
        if not was:
            reg.disable()


def test_crash_before_commit_leaves_previous_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    state = {"w": np.arange(4, dtype=np.float32)}
    mgr.save(1, state, block=True)
    fault.arm("checkpoint.pre_commit:raise")
    with pytest.raises(fault.FaultInjected):
        mgr.save(2, {"w": state["w"] * 7}, block=True)
    mgr2 = CheckpointManager(str(tmp_path / "c"))
    assert mgr2.steps() == [1]
    np.testing.assert_array_equal(mgr2.restore().arrays["w"], state["w"])
    assert not [n for n in os.listdir(str(tmp_path / "c")) if ".tmp-" in n]


def test_crash_mid_write_leaves_previous_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "c"))
    state = {"a": np.zeros(2, np.float32), "b": np.ones(2, np.float32)}
    mgr.save(1, state, block=True)
    fault.arm("checkpoint.write@2:raise")
    with pytest.raises(fault.FaultInjected):
        mgr.save(2, state, block=True)
    assert CheckpointManager(str(tmp_path / "c")).latest_step() == 1


def test_kill9_mid_checkpoint_subprocess(tmp_path):
    """A real kill (os._exit by the env-armed fault point) between the
    manifest and the commit: the previous checkpoint stays loadable and
    the next manager sweeps the torn tmp dir."""
    d = str(tmp_path / "c")
    script = tmp_path / "killer.py"
    script.write_text(
        "import torch\n"
        "from paddle_tpu_torch.checkpoint import CheckpointManager\n"
        "m = CheckpointManager(%r)\n"
        "m.save(1, {'w': torch.arange(3, dtype=torch.float32)}, "
        "block=True)\n"
        "m.save(2, {'w': torch.full((3,), 9.0)}, block=True)\n" % d)
    env = dict(os.environ, FLAGS_fault_points="checkpoint.pre_commit@2:exit",
               PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 137, proc.stderr
    assert [n for n in os.listdir(d) if ".tmp-" in n]
    mgr = CheckpointManager(d)
    assert mgr.steps() == [1]
    np.testing.assert_array_equal(mgr.restore().arrays["w"],
                                  np.arange(3, dtype=np.float32))
    assert not [n for n in os.listdir(d) if ".tmp-" in n]


def test_restore_onto_a_mesh_is_refused(tmp_path):
    """``place(mesh=)`` takes a mesh (the parallel package's, an axes
    dict or a spec string) and refuses anything else; a one-rank mesh
    places the whole arrays."""
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, {"w": np.ones(2, np.float32)}, block=True)
    with pytest.raises(TypeError, match="mesh must be"):
        mgr.restore().place(mesh=object())
    placed = mgr.restore().place(mesh={"dp": 1})
    np.testing.assert_array_equal(placed["w"], np.ones(2, np.float32))


def test_resumable_reader_position_and_seek():
    src = fluid.reader.resumable(
        lambda: iter([{"x": np.full((1,), i, np.float32)} for i in range(6)]))
    assert [b["x"][0] for b in src()] == [0, 1, 2, 3, 4, 5]
    assert src.position == 6
    src.set_position(4)
    assert [b["x"][0] for b in src()] == [4, 5] and src.position == 6
    assert len(list(src())) == 6


def test_train_loop_resume_seeks_resumable_reader(tmp_path):
    feeds = _feed_batches(14)
    exe, loss = _fresh_model()
    ref = _losses(exe.train_loop(fluid.default_main_program(), feeds,
                                 [loss], steps=14))
    d = str(tmp_path / "c")
    exe, loss = _fresh_model()
    exe.train_loop(fluid.default_main_program(), feeds, [loss], steps=8,
                   checkpoint_dir=d, checkpoint_every=4)
    exe, loss = _fresh_model()
    reader = fluid.reader.resumable(lambda: iter(feeds))
    got = _losses(exe.train_loop(fluid.default_main_program(), reader,
                                 [loss], steps=14, resume_from=d))
    assert got == ref[8:]
    assert reader.position == 14


def test_atomic_save_vars_crash_leaves_old_files(tmp_path):
    ckpt = str(tmp_path / "ck")
    exe, loss = _fresh_model()
    for f in _feed_batches(2):
        exe.run(feed=f, fetch_list=[loss])
    fluid.io.save_persistables(exe, ckpt)
    before = {n: np.load(os.path.join(ckpt, n))
              for n in os.listdir(ckpt) if n.endswith(".npy")}
    for f in _feed_batches(2, seed=5):
        exe.run(feed=f, fetch_list=[loss])
    fault.arm("io.save_vars@2:raise")
    with pytest.raises(fault.FaultInjected):
        fluid.io.save_persistables(exe, ckpt)
    assert not [n for n in os.listdir(ckpt) if ".tmp-" in n]
    for n, old in before.items():
        assert np.load(os.path.join(ckpt, n)).shape == old.shape
    exe2, _ = _fresh_model()
    fluid.io.load_persistables(exe2, ckpt)


# -- across packages --------------------------------------------------------

def _twin():
    """The Adam fc program in both packages from the JAX startup state."""
    for fl in (jfluid, fluid):
        fl.core.program.reset_default_programs()
        fl.core.scope._global_scope = fl.core.scope.Scope()
    jloss, loss = _build(jfluid), _build(fluid)
    jmain, main = jfluid.default_main_program(), fluid.default_main_program()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    exe = fluid.Executor(CPU)
    for v in main.list_vars():
        val = jfluid.global_scope().get(v.name)
        if v.persistable and val is not None:
            fluid.global_scope().set(v.name, np.array(val))
    return jexe, exe, jmain, main, jloss.name, loss.name


def test_program_fingerprints_agree():
    jexe, exe, jmain, main, _, _ = _twin()
    assert (fluid.checkpoint.program_fingerprint(main)
            == jfluid.checkpoint.program_fingerprint(jmain))
    assert (fluid.checkpoint.program_fingerprint(main.clone(for_test=True))
            == jfluid.checkpoint.program_fingerprint(
                jmain.clone(for_test=True)))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    feeds = _feed_batches(10, seed=3)
    d = str(tmp_path / "j")
    jexe, exe, jmain, main, jloss, loss = _twin()
    jref = _losses(jexe.train_loop(jmain, feeds, [jloss], steps=10))
    jexe, exe, jmain, main, jloss, loss = _twin()
    jexe.train_loop(jmain, feeds, [jloss], steps=6, checkpoint_dir=d,
                    checkpoint_every=6)
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    loss = _build().name
    exe = fluid.Executor(CPU)
    exe.run(fluid.default_startup_program())
    handles = exe.train_loop(fluid.default_main_program(), feeds, [loss],
                             steps=10, resume_from=d)
    assert [h.step for h in handles] == [6, 7, 8, 9]
    np.testing.assert_allclose(_losses(handles), jref[6:], rtol=1e-4)


def test_port_checkpoint_restores_through_the_jax_manager(tmp_path):
    feeds = _feed_batches(10, seed=4)
    d = str(tmp_path / "p")
    jexe, exe, jmain, main, jloss, loss = _twin()
    ref = _losses(exe.train_loop(main, feeds, [loss], steps=10))
    jexe, exe, jmain, main, jloss, loss = _twin()
    exe.train_loop(main, feeds, [loss], steps=6, checkpoint_dir=d,
                   checkpoint_every=6)
    restored = jfluid.checkpoint.CheckpointManager(d).restore()
    assert restored.step == 6 and restored.reader_position == 6
    assert (restored.manifest["program_fingerprint"]
            == jfluid.checkpoint.program_fingerprint(jmain))
    for name, arr in restored.arrays.items():
        val = fluid.global_scope().get(name)
        if val is not None:
            np.testing.assert_array_equal(arr, val.numpy(), err_msg=name)
    # and the JAX train_loop resumes from it
    jfluid.core.program.reset_default_programs()
    jfluid.core.scope._global_scope = jfluid.core.scope.Scope()
    jloss = _build(jfluid).name
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    handles = jexe.train_loop(jfluid.default_main_program(), feeds, [jloss],
                              steps=10, resume_from=d)
    np.testing.assert_allclose(_losses(handles), ref[6:], rtol=1e-4)


def test_resume_refuses_another_program(tmp_path):
    d = str(tmp_path / "c")
    exe, loss = _fresh_model()
    exe.train_loop(feed=_feed_batches(2), fetch_list=[loss], steps=2,
                   checkpoint_dir=d, checkpoint_every=2)
    fluid.core.program.reset_default_programs()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    loss = fluid.layers.mean(fluid.layers.square_error_cost(
        input=fluid.layers.fc(input=x, size=2), label=y))
    fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(CPU)
    exe.run(fluid.default_startup_program())
    with pytest.raises(ValueError, match="different program"):
        exe.train_loop(feed=_feed_batches(4), fetch_list=[loss], steps=4,
                       resume_from=d)


# -- fault points (tests/test_fault_tolerance.py) ---------------------------

def test_fault_point_spec_parsing_and_exactness():
    fault.arm("x.y@3:raise")
    assert not fault.maybe_fault("x.y")
    assert not fault.maybe_fault("x.y")
    with pytest.raises(fault.FaultInjected):
        fault.maybe_fault("x.y")
    assert not fault.maybe_fault("x.y")       # fires exactly once
    with pytest.raises(ValueError):
        fault.arm("x.y:detonate")


def test_fault_point_sticky_and_drop():
    fault.arm("a.b@2+:drop")
    assert [fault.maybe_fault("a.b") for _ in range(4)] == [
        False, True, True, True]
    assert fault.hits("a.b") == 4 and "a.b" in fault.armed()
    fault.reset()
    assert not fault.armed() and fault.hits("a.b") == 0


def test_fault_point_stop_pauses_the_process_until_continued(tmp_path):
    """``stop`` (a port action: pacing for the chaos tests) stops the
    process at the site's hit and returns False once it is continued."""
    import signal
    import time
    env = dict(os.environ, FLAGS_fault_points="p.q@2:stop",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    code = ("from paddle_tpu_torch import fault; "
            "print(fault.maybe_fault('p.q'), flush=True); "
            "print(fault.maybe_fault('p.q'), fault.hits('p.q'), flush=True)")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "False"
        deadline = time.monotonic() + 60
        state = ""
        while time.monotonic() < deadline:
            with open(f"/proc/{proc.pid}/stat") as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
            if state == "T":
                break
            time.sleep(0.01)
        assert state == "T"
        os.kill(proc.pid, signal.SIGCONT)
        out, _ = proc.communicate(timeout=60)
        assert out.strip() == "False 2" and proc.returncode == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_backoff_deterministic_bounded_and_jittered():
    from paddle_tpu_torch.distributed.backoff import Backoff
    a = Backoff(base=0.1, factor=2.0, cap=1.0, jitter=0.5, seed=7)
    b = Backoff(base=0.1, factor=2.0, cap=1.0, jitter=0.5, seed=7)
    da = [a.next_delay() for _ in range(8)]
    assert da == [b.next_delay() for _ in range(8)]
    assert all(0 < d <= 1.0 for d in da)
    assert len(set(da)) > 1


# -- twins of tests/test_flags.py -------------------------------------------

def test_env_whitelist_reads_flags_vars():
    env = dict(os.environ)
    env.update({"FLAGS_check_nan_inf": "1", "FLAGS_benchmark": "true",
                "FLAGS_amp": "1", "FLAGS_use_pinned_memory": "1",
                "FLAGS_fraction_of_gpu_memory_to_use": "0.5"})
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import paddle_tpu_torch as fluid; f = fluid.FLAGS; "
            "print(f.check_nan_inf, f.benchmark, f.amp, f.use_pinned_memory, "
            "f.fraction_of_tpu_memory_to_use, "
            "fluid.default_main_program().amp, "
            "fluid.Executor(fluid.CPUPlace()).check_nan_inf)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"] * 4 + ["0.5", "True", "True"]


def test_flag_table_matches_jax():
    assert FLAGS.names() == jfluid.FLAGS.names()
    for name in FLAGS.names():
        assert FLAGS._defs[name][1] == jfluid.FLAGS._defs[name][1], name
    with pytest.raises(AttributeError):
        FLAGS.no_such_flag = 1


def test_check_nan_inf_flag_gates_executor():
    old = FLAGS.check_nan_inf
    FLAGS.check_nan_inf = True
    try:
        exe = fluid.Executor(CPU)
        assert exe.check_nan_inf is True
        x = fluid.layers.data(name="x", shape=[2], dtype="float32")
        y = fluid.layers.log(x)
        exe.run(fluid.default_startup_program())
        with pytest.raises(RuntimeError, match="NaN/Inf"):
            exe.run(feed={"x": np.array([[-1.0, 1.0]], np.float32)},
                    fetch_list=[y])
    finally:
        FLAGS.check_nan_inf = old


def test_amp_flag_defaults_new_programs():
    old = FLAGS.amp
    FLAGS.amp = True
    try:
        assert fluid.Program().amp is True
    finally:
        FLAGS.amp = old


# -- the CLI ----------------------------------------------------------------

def test_checkpoints_verb_prints_what_the_jax_verb_prints(tmp_path,
                                                          capsys):
    from paddle_tpu.__main__ import main as jmain
    from paddle_tpu_torch.__main__ import main as pmain
    d = str(tmp_path / "c")
    exe, loss = _fresh_model()
    for steps in (2, 4):       # each call flushes its checkpoint
        exe.train_loop(feed=_feed_batches(4), fetch_list=[loss],
                       steps=steps, checkpoint_dir=d, checkpoint_every=2,
                       resume_from=d)
    outs = []
    for main in (pmain, jmain):
        for args in ([d], [d, "--json"]):
            assert main(["checkpoints"] + args) == 0
            outs.append(capsys.readouterr().out)
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert [c["step"] for c in json.loads(outs[1])] == [2, 4]
    assert pmain(["checkpoints", str(tmp_path / "none")]) == 1


def test_train_verb_runs_a_script(tmp_path):
    script = tmp_path / "train.py"
    ck = str(tmp_path / "ck")
    script.write_text(
        "import sys\n"
        "import numpy as np\n"
        "import paddle_tpu_torch as fluid\n"
        "x = fluid.layers.data(name='x', shape=[4], dtype='float32')\n"
        "y = fluid.layers.data(name='y', shape=[1], dtype='float32')\n"
        "loss = fluid.layers.mean(fluid.layers.square_error_cost(\n"
        "    input=fluid.layers.fc(input=x, size=1), label=y))\n"
        "fluid.optimizer.SGD(0.1).minimize(loss)\n"
        "exe = fluid.Executor(fluid.CPUPlace())\n"
        "exe.run(fluid.default_startup_program())\n"
        "rng = np.random.RandomState(0)\n"
        "feeds = [{'x': rng.rand(8, 4).astype('float32'),\n"
        "          'y': rng.rand(8, 1).astype('float32')} for _ in range(4)]\n"
        "hs = exe.train_loop(feed=feeds, fetch_list=[loss], steps=4,\n"
        "                    checkpoint_dir=sys.argv[1], checkpoint_every=4)\n"
        "print('losses', [round(float(h.get()[0]), 6) for h in hs])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-m", "paddle_tpu_torch", "train",
                          str(script), ck], env=env, cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("losses [")
    assert CheckpointManager(ck).steps() == [4]
