"""Twins of tests/test_model_parallel.py: logical-axis rules,
Megatron-style tensor parallelism of the transformer LM, dp x tp meshes
and the cross-mesh checkpoint chain, on a 4-rank gloo world.

The JAX package trains the same LM single-device in this process from
the initial state the ranks load.  Two of the JAX tests
(``test_dp_tp_exact_bitwise_vs_single_device[4]`` and
``test_cross_mesh_checkpoint_chain_through_tp``) fail in the JAX package
itself, so their twins are held to the JAX single-device run (1e-4) and
to the port's own single-process run (bitwise), not to the JAX mesh
runs.  Fast tensor parallelism is held to the JAX single-device losses
at 1e-4.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu.parallel import (LogicalAxisRules as JRules,
                                 create_mesh as jcreate_mesh,
                                 transformer_tp_rules as jtp_rules)
from paddle_tpu.parallel.partitioner import spec_fits as jspec_fits

from paddle_tpu_torch.parallel import (LogicalAxisRules,
                                       transformer_tp_rules)
from paddle_tpu_torch.parallel.partitioner import spec_fits

from _torch_mesh_pool import RankPool

RANKS = "torch_mesh_ranks"
V, T, B, D, F, H, L = 64, 16, 8, 32, 128, 4, 2


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(4, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _jax_lm(tmp_path, steps=8, batch=B, fetch=(), **kw):
    """The JAX LM's single-device run from the state it saves for the
    ranks -> (state dir, losses, fetched grads of step 0)."""
    jfluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    jfluid.default_main_program().random_seed = 0
    shape = dict(vocab=V, max_len=T, n_layers=L, d_model=D, n_heads=H,
                 d_ff=F)
    shape.update(kw)
    _, _, loss = jtransformer.transformer_lm_train_program(**shape)
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    d = str(tmp_path / f"jax_lm_{shape['d_model']}")
    jfluid.io.save_persistables(exe, d, jfluid.default_main_program())
    rng = np.random.RandomState(0)
    vocab, max_len = shape["vocab"], shape["max_len"]
    seqs = rng.randint(2, vocab, (steps * batch, max_len)).astype(np.int32)
    feeds = [{"tokens": seqs[i * batch:(i + 1) * batch],
              "labels": np.roll(seqs[i * batch:(i + 1) * batch], -1, 1)}
             for i in range(steps)]
    handles = exe.train_loop(feed=feeds, fetch_list=[loss] + list(fetch),
                             steps=steps)
    return (d, [np.asarray(h.get()[0]) for h in handles],
            [np.asarray(g) for g in handles[0].get()[1:]])


def _close(a, b, rtol=1e-4, atol=1e-6):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x, np.float64),
                                   np.asarray(y, np.float64),
                                   rtol=rtol, atol=atol)


def test_transformer_tp_rules_map_the_megatron_layout():
    """The port's table gives the JAX table's spec for every shape of
    the JAX test, and the same misses and refusals."""
    r, jr = transformer_tp_rules(D, F, vocab=V), jtp_rules(D, F, vocab=V)
    jmesh = jcreate_mesh({"dp": 2, "tp": 2})
    cases = [("fc_0.w_0", (D, 3 * D)), ("fc_0.b_0", (3 * D,)),
             ("fc_2.w_0", (D, F)), ("fc_2.b_0", (F,)), ("fc_3.w_0", (F, D)),
             ("layer_norm_0.w_0", (D,)), ("embedding_0.w_0", (V, D)),
             ("fc_9.w_0", (D, V)), ("moment1_whatever", (D, 3 * D)),
             ("oddball", (7, 9)), ("fc_1.w_0", (D, D)),
             ("pos_encoding_0.w_0", (T, D))]
    for name, shape in cases:
        mine, theirs = r(name, shape), jr(name, shape)
        assert (mine is None) == (theirs is None), name
        if mine is not None:
            assert tuple(mine) == tuple(theirs), name
            assert spec_fits(mine, shape, jmesh) == \
                jspec_fits(theirs, shape, jmesh)
    assert r.mesh_axis("batch") == "dp" and r.mesh_axis("mlp") == "tp"
    assert r.fingerprint()[2:] == jr.fingerprint()[2:]
    assert r.describe() == jr.describe()
    with pytest.raises(ValueError):
        transformer_tp_rules(64, 64)
    dp = LogicalAxisRules.dp_default()
    assert not dp.has_param_rules and dp("fc_0.w_0", (D, 3 * D)) is None
    assert dp.describe() == JRules.dp_default().describe()
    assert repr(r("fc_0.w_0", (D, 3 * D))) == \
        repr(jr("fc_0.w_0", (D, 3 * D)))


def test_dp_default_table_reproduces_plain_dp_bitwise(pool, tmp_path):
    d, jl, _ = _jax_lm(tmp_path, steps=4)
    outs = pool.run(f"{RANKS}:mesh_run", "lm", 4, 1, {"dp": 4}, "exact",
                    "dp_default", "dp", False, None, d)
    for r in outs:
        assert r["bitwise"] is None, r["bitwise"]
    _close(jl, outs[0]["losses"])


def test_transformer_trains_sharded_on_dp_tp_mesh(pool, tmp_path):
    """fast dp=2 x tp=2 at d128 f512: every Megatron-ruled param and
    both Adam moments hold half of the ruled dim, each rank's argument
    bytes (its shards and feed slice) stay under 0.75x the whole train
    state, its argument + temp bytes under the whole state, the step
    ran tp collectives, and the losses are within 1e-4 of JAX's single
    device."""
    d, jl, _ = _jax_lm(tmp_path, batch=2, d_model=128, d_ff=512,
                       vocab=256, max_len=8)
    outs = pool.run(f"{RANKS}:lm_memory", d)
    r = outs[0]
    _close(jl, r["losses"])
    dm, f, vocab = 128, 512, 256
    ruled = {(dm, 3 * dm): 1, (3 * dm,): 0, (dm, f): 1, (f,): 0,
             (f, dm): 0, (dm, vocab): 1}
    hit = 0
    for n, shape in r["full_shapes"].items():
        dim = ruled.get(shape)
        if dim is None:
            continue
        hit += 1
        assert "tp" in r["specs"][n], (n, shape)
        want = list(shape)
        want[dim] //= 2
        assert r["resident"][n] == tuple(want), n
    assert hit >= 3 * 4 * L, hit
    rep = r["report"]
    assert rep["mesh_shape"] == {"dp": 2, "tp": 2}
    assert rep["num_devices"] == 4
    assert rep["argument_bytes"] < 0.75 * r["full_bytes"]
    assert rep["argument_bytes"] + rep["temp_bytes"] < r["full_bytes"]
    assert r["resident_bytes"] < 0.75 * r["full_bytes"]
    assert any("'tp'" in key for key in rep["sharding_summary"])
    assert rep["collectives"]["axes"]["tp"]["count"] > 0
    assert rep["collectives"]["axes"]["dp"]["count"] > 0


@pytest.mark.parametrize("k", [1, 4])
def test_dp_tp_exact_bitwise_vs_single_device(pool, tmp_path, k):
    """exact dp=2 x tp=2 under the table: bitwise the port's single
    process (losses, params, accumulators), within 1e-4 of JAX's single
    device, one launch a window."""
    d, jl, _ = _jax_lm(tmp_path)
    outs = pool.run(f"{RANKS}:mesh_run", "lm", 8, k, {"dp": 2, "tp": 2},
                    "exact", "tp", "dp", False, None, d)
    for r in outs:
        assert r["bitwise"] is None, r["bitwise"]
    assert outs[0]["launches"] <= -(-8 // k)
    _close(jl, outs[0]["losses"])


def test_fast_tp_gradients_and_losses_match_jax(pool, tmp_path):
    """fast dp=2 x tp=2: the step-0 gradients of a column-sharded qkv,
    the row-sharded FFN-out and the vocab-sharded head (gathered for the
    fetch) and every loss are within the whole-model tolerance of JAX's
    single device."""
    names = ("fc_0.w_0@GRAD", "fc_2.w_0@GRAD", "fc_6.w_0@GRAD")
    d, jl, jg = _jax_lm(tmp_path, fetch=names)
    r = pool.run(f"{RANKS}:mesh_run", "lm", 8, 1, {"dp": 2, "tp": 2}, None,
                 "tp", "dp", False, None, d, False, names)[0]
    _close(jl, r["losses"])
    for a, b in zip(jg, r["grads"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-6)
    assert r["specs"]["fc_2.w_0"] == ("tp", None)
    assert r["resident"]["fc_2.w_0"] == (F // 2, D)


def test_cross_mesh_checkpoint_chain_through_tp(pool, tmp_path):
    """dp=4 -> dp=2 x tp=2 (one K=4 window) -> tp=4 -> dp=1 under exact
    numerics, each leg resuming the previous leg's checkpoint: every
    leg's losses and the final params and accumulators are bitwise the
    uninterrupted single-process run."""
    outs = pool.run(f"{RANKS}:chain_run", str(tmp_path))
    r = outs[0]
    ref = r["ref_losses"]
    for i, tail in enumerate(r["tails"]):
        for a, b in zip(ref[4 * i:4 * i + 4], tail):
            assert a.tobytes() == b.tobytes(), i
    for n in r["ref_params"]:
        assert r["ref_params"][n].tobytes() == r["params"][n].tobytes(), n
    assert any("moment" in n for n in r["ref_params"])
    assert any("beta1_pow" in n for n in r["ref_params"])
    assert "ckpt-000016" in r["dirs"]


def test_rule_table_serves_through_sharded_predictor(pool, tmp_path):
    """The table a model trains under serves it: exact replies are
    bitwise the `Predictor`'s, fast ones within 1e-5 with the tp params
    sharded, and the topology and table are part of the identity."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import layers
    from paddle_tpu_torch.models import transformer
    fluid.core.program.reset_default_programs()
    fluid.global_scope().clear()
    fluid.default_main_program().random_seed = 7
    tokens = layers.data(name="tokens", shape=[T], dtype="int64")
    logits = transformer.transformer_lm_logits(
        tokens, vocab=V, max_len=T, n_layers=L, d_model=D, n_heads=H,
        d_ff=F)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    d = str(tmp_path / "lm")
    fluid.io.save_inference_model(d, ["tokens"], [logits], exe)
    feed = np.random.RandomState(3).randint(2, V, (B, T)).astype(np.int64)
    outs = pool.run(f"{RANKS}:sharded_lm_predict", d, feed)
    for r in outs:
        assert np.asarray(r["exact"]).tobytes() == \
            np.asarray(r["want"]).tobytes()
        np.testing.assert_allclose(r["fast"], r["want"], rtol=1e-5,
                                   atol=1e-6)
        assert r["info"]["sharded_params"]
        assert r["info"]["mesh"] == {"dp": 2, "tp": 2}
        assert r["fp_distinct"]


def test_rule_miss_warning_is_one_time_and_names_params(pool):
    r = pool.run(f"{RANKS}:rule_miss_warnings")[0]
    assert len(r["first"]) == 1, r["first"]
    msg = r["first"][0]
    assert "fc_0.w_0" in msg and "typo" in msg
    assert "learning_rate" not in msg and "@" not in msg.split(":")[0]
    assert not r["second"]


def test_training_mesh_factory_and_string_spec(pool):
    r = pool.run(f"{RANKS}:mesh_factories")
    assert [o["coords"] for o in r] == [{"dp": 0, "tp": 0},
                                        {"dp": 0, "tp": 1},
                                        {"dp": 1, "tp": 0},
                                        {"dp": 1, "tp": 1}]
    r = r[0]
    assert r["shape"] == {"dp": 2, "tp": 2} and r["order"] == ("dp", "tp")
    assert r["size"] == 4 and r["group_sizes"] == {"dp": 2, "tp": 2}
    assert r["part_shape"] == {"dp": 2, "tp": 2}
    assert r["data_axis"] == "dp" and r["num_devices"] == 4
    assert r["fp_differs_dp4"] and r["fp_differs_rules"]


def test_roofline_labels_tp_collective_traffic():
    """A tp report's collectives become `tp_collective_bytes_per_step`
    in the port's roofline and in its rendering; a dp-only report stays
    unlabelled."""
    from paddle_tpu_torch.observability import attribution, introspect
    rep = {"flops": 2.0e9, "bytes_accessed": 1.0e8, "peak_bytes": 5_000,
           "argument_bytes": 3_000, "output_bytes": 1_000,
           "temp_bytes": 1_000, "compile_seconds": 0.1, "steps": 1,
           "dtype": "bf16", "num_devices": 4,
           "device_name": "NVIDIA H100 80GB HBM3",
           "mesh_shape": {"dp": 2, "tp": 2},
           "collectives": {"total_bytes": 123_456, "count": 8,
                           "kinds": {"all-reduce": {"count": 8,
                                                    "bytes": 123_456}}}}
    rl = attribution.roofline(rep)
    assert rl["tp_collective_bytes_per_step"] == 123_456
    text = introspect.format_report(rep, roofline=True)
    assert "tp collectives  123,456 B/step" in text
    dp_rep = dict(rep, mesh_shape={"dp": 4})
    assert "tp_collective_bytes_per_step" not in attribution.roofline(
        dp_rep)
    assert "tp collectives" not in introspect.format_report(
        dp_rep, roofline=True)


@pytest.mark.parametrize("k", [1, 4])
def test_dp_tp_exact_bitwise_under_mixed_precision(pool, tmp_path, k):
    """The amp LM (bf16 compute, f32 master weights, the loss scaler)
    under exact dp=2 x tp=2: bitwise the port's single process, within
    the bf16 tolerance of JAX's single device."""
    d, jl, _ = _jax_lm(tmp_path, amp=True)
    outs = pool.run(f"{RANKS}:mesh_run", "lm", 8, k, {"dp": 2, "tp": 2},
                    "exact", "tp", "dp", False, None, d, True, (),
                    amp=True)
    for r in outs:
        assert r["bitwise"] is None, r["bitwise"]
    _close(jl, outs[0]["losses"], rtol=2e-2, atol=1e-3)
