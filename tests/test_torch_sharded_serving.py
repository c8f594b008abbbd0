"""Twins of tests/test_sharded_serving.py: the port's `ShardedPredictor`
on a 4-rank gloo world against the single-device `Predictor` of both
packages, through the unchanged engine and endpoint path (rank 0 serves,
the other ranks follow its batches), and the ``serve --mesh`` verb.
"""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import layers as jlayers, serving as jserving

from _torch_mesh_pool import RankPool

RANKS = "torch_mesh_ranks"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _save_mlp(tmp_path, hidden=8):
    """The JAX package's MLP, saved for both packages to serve."""
    jfluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    x = jlayers.data(name="x", shape=[4], dtype="float32")
    h = jlayers.fc(input=x, size=hidden, act="relu")
    y = jlayers.fc(input=h, size=3, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    d = str(tmp_path / "mlp")
    jfluid.io.save_inference_model(d, ["x"], [y], exe)
    return d


def test_sharded_predictor_matches_single_device(pool, tmp_path):
    d = _save_mlp(tmp_path)
    feed = np.random.RandomState(0).rand(8, 4).astype(np.float32)
    jwant = jserving.Predictor.from_model_dir(d).run({"x": feed})[0]
    outs = pool.run(f"{RANKS}:sharded_predict", d, {"x": feed}, {"dp": 4})
    for r in outs:
        np.testing.assert_allclose(r["got"], r["want"], rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(r["got"], np.asarray(jwant), rtol=1e-6,
                                   atol=1e-7)
    r = outs[0]
    assert r["info"]["mesh"] == {"dp": 4} and r["info"]["devices"] == 4
    assert r["stats_sharding"]["data_axis"] == "dp"


def test_sharded_predictor_indivisible_batch_replicates(pool, tmp_path):
    """dp=4 cannot split 3 rows: the batch stays whole on every rank;
    the divisible shape still splits, and both signatures are seen."""
    d = _save_mlp(tmp_path)
    feed = np.random.RandomState(1).rand(3, 4).astype(np.float32)
    outs = pool.run(f"{RANKS}:sharded_predict", d, {"x": feed}, {"dp": 4})
    for r in outs:
        np.testing.assert_allclose(r["got"], r["want"], rtol=1e-6,
                                   atol=1e-7)
        assert r["shapes_seen"] == 2


def test_param_spec_rule_shards_weights(pool, tmp_path):
    """A rule column-shards the hidden fc weight over the mesh; the
    replies do not move."""
    d = _save_mlp(tmp_path, hidden=8)
    feed = np.random.RandomState(2).rand(4, 4).astype(np.float32)
    outs = pool.run(f"{RANKS}:sharded_predict", d, {"x": feed}, {"dp": 4},
                    "dp_col8")
    for r in outs:
        np.testing.assert_allclose(r["got"], r["want"], rtol=1e-6,
                                   atol=1e-7)
        assert r["info"]["sharded_params"], "rule never matched"


def test_sharded_serving_through_engine_and_endpoint(pool, tmp_path):
    """The same wire path (engine batcher and TCP endpoint) on rank 0
    serves the sharded model, numerically equal to the JAX package's
    single-device predictor, with the mesh in the models listing."""
    d = _save_mlp(tmp_path)
    feed = np.random.RandomState(3).rand(4, 4).astype(np.float32)
    want = jserving.Predictor.from_model_dir(d).run({"x": feed})[0]
    outs = pool.run(f"{RANKS}:serve_through_endpoint", d, feed)
    r = outs[0]
    np.testing.assert_allclose(r["reply"], np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert r["sharding"]["mesh"] == {"dp": 4}
    assert r["dispatches"]
    assert outs[1:] == [None, None, None]


def test_sharded_predictor_needs_a_mesh(pool):
    """No mesh and no process mesh raises; a mesh without the default
    data axis takes its first axis."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers, serving
    fluid.core.program.reset_default_programs()
    x = layers.data(name="x", shape=[2], dtype="float32")
    y = layers.scale(x=x, scale=2.0)
    with pytest.raises(ValueError, match="mesh"):
        serving.ShardedPredictor(fluid.default_main_program(), ["x"], [y],
                                 device="cpu")
    assert pool.run(f"{RANKS}:data_axis_fallback") == ["tp"] * 4


def test_serve_verb_with_a_mesh(tmp_path, wait_port_file):
    """``serve --mesh dp=2 --device cpu`` spawns its follower rank and
    answers the JAX client with the JAX predictor's reply; SIGTERM stops
    both ranks."""
    d = _save_mlp(tmp_path)
    feed = np.random.RandomState(4).rand(4, 4).astype(np.float32)
    want = jserving.Predictor.from_model_dir(d).run({"x": feed})[0]
    port_file = str(tmp_path / "port")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "serve", d, "--device",
         "cpu", "--mesh", "dp=2", "--port-file", port_file, "--warmup",
         "4"], env=env, cwd=REPO, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        port = wait_port_file(port_file, timeout=120)
        ep = f"127.0.0.1:{port}"
        out = jserving.infer_round_trip(ep, {"x": feed})
        np.testing.assert_allclose(next(iter(out.values())),
                                   np.asarray(want), rtol=1e-6, atol=1e-7)
        listing = jserving.list_models(ep)
        assert listing["models"]["default"]["sharding"]["mesh"] == {"dp": 2}
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, text
        assert "mesh={'dp': 2}" in text
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait(10)


@pytest.mark.parametrize("fails_in", ["init_distributed", "load"])
def test_serve_mesh_reaps_its_followers_when_rank_0_fails(
        monkeypatch, tmp_path, fails_in):
    """An in-process ``main(["serve", ..., "--mesh", "dp=2"])`` spawns its
    follower from the argv it was given (not the caller's sys.argv);
    when rank 0 then fails, joining the world or loading the model, the
    error reaches the caller, the follower is killed and reaped, and the
    store dir is removed (the follower's process and the world faked)."""
    import tempfile
    import paddle_tpu_torch.parallel as tparallel
    from paddle_tpu_torch.__main__ import main
    d = _save_mlp(tmp_path)
    spawned = []

    class Follower:
        def __init__(self, cmd, **kw):
            self.cmd, self.calls = cmd, []
            spawned.append(self)

        def poll(self):
            self.calls.append("poll")
            return None

        def kill(self):
            self.calls.append("kill")

        def wait(self, timeout=None):
            self.calls.append("wait")
            return -9

    def init(*a, **kw):
        if fails_in == "init_distributed":
            raise RuntimeError("the store is unreachable")
        return 0, 2

    stores = tmp_path / "tmp"
    stores.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(stores))
    monkeypatch.setattr(subprocess, "Popen", Follower)
    monkeypatch.setattr(tparallel, "init_distributed", init)
    argv = ["serve", d, "--device", "cpu", "--mesh", "dp=2", "--port", "0"]
    with pytest.raises((RuntimeError, ValueError)) as err:
        main(argv)
    if fails_in == "init_distributed":
        assert "unreachable" in str(err.value)
    else:
        assert "process group" in str(err.value)
    [f] = spawned
    assert f.cmd[:3] == [sys.executable, "-m", "paddle_tpu_torch"]
    assert f.cmd[3:3 + len(argv)] == argv
    assert f.cmd[3 + len(argv):5 + len(argv)] == ["--mesh-rank", "1"]
    assert f.cmd[5 + len(argv)] == "--mesh-init"
    assert f.calls == ["poll", "kill", "wait"]
    assert list(stores.iterdir()) == []
