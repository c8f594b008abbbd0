"""Twins of tests/test_parallel.py :18, :32, :45 (ring and Ulysses
attention), :236, :249, :276 (each strategy's defining collective, here
as the collectives' ledger) and of every case of tests/test_pipeline.py:
the port's sequence-parallel attention (`parallel.ring_attention`) and
GPipe pipeline (`parallel.pipeline`), and `collectives.ppermute`.

The port runs on one 4-rank gloo pool (`_torch_mesh_pool`): every rank
gets the same global arrays and runs on its shard; the JAX functions run
in this process on their own CPU meshes, under ``jax.jit`` (eager
``shard_map`` gradients take half a minute each).  The JAX test's sp=8
ring case is held by the port at sp=4: the same global function.  The
JAX Ulysses function has no gradient (``jax.grad`` through its untiled
``all_to_all`` raises a cotangent shape error), so the port's Ulysses
gradients are held against ``jax.grad`` of the JAX
``reference_attention``, the function both compute.  Tolerances:
``F32_TOL`` for f32 kernel paths (both sides compute attention in f32
with another summation order), ``BF16_TOL`` for bf16 inputs (each ring
block's output is rounded to bf16 before the f32 merge).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.parallel import (create_mesh, sequence_parallel_attention,
                                 reference_attention, pipeline_apply,
                                 pipeline_reference,
                                 bubble_fraction as jbubble)

from paddle_tpu_torch.parallel import bubble_fraction

from _torch_mesh_pool import RankPool

RANKS = "torch_sequence_parallel_ranks"
F32_TOL = 2e-5
BF16_TOL = 2e-2
WORLD = 4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(WORLD, tmp_path_factory.mktemp("gloo"))
    yield p
    p.close()


def _qkv(seed, shape, n=3):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _cat(res, key="out"):
    return np.concatenate([r[key] for r in res], axis=1)


def _jax_sp(q, k, v, n, strategy, causal=False):
    mesh = create_mesh({"sp": n})
    return jax.jit(lambda a, b, c: sequence_parallel_attention(
        a, b, c, mesh, axis="sp", strategy=strategy, causal=causal))(
            *(jnp.asarray(x) for x in (q, k, v)))


def _attention_grads(strategy, causal, q, k, v, w):
    """The JAX function's out and dq/dk/dv of sum(out * w) on a 4-device
    sp mesh (Ulysses: of `reference_attention`, module docstring)."""
    mesh = create_mesh({"sp": 4})

    def loss(q_, k_, v_):
        if strategy == "ring":
            out = sequence_parallel_attention(q_, k_, v_, mesh, axis="sp",
                                              strategy="ring",
                                              causal=causal)
        else:
            out = reference_attention(q_, k_, v_, causal)
        return jnp.sum(out * w), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(a) for a in (q, k, v)))
    return out, grads


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol)


# ---------------------------------------------------------------------------
# tests/test_parallel.py :18, :32, :45
# ---------------------------------------------------------------------------

def test_ring_attention_matches_reference(pool):
    q, k, v = _qkv(0, (2, 64, 4, 16))
    want = _jax_sp(q, k, v, 8, "ring")
    _close(_cat(pool.run(f"{RANKS}:attention", "ring", False, q, k, v)),
           want)
    _close(want, reference_attention(*(jnp.asarray(a) for a in (q, k, v))))


def test_ring_attention_causal(pool):
    q, k, v = _qkv(1, (1, 32, 2, 8))
    want = _jax_sp(q, k, v, 4, "ring", True)
    _close(_cat(pool.run(f"{RANKS}:attention", "ring", True, q, k, v)),
           want)


def test_ulysses_attention_matches_reference(pool):
    q, k, v = _qkv(2, (2, 32, 8, 16))
    want = _jax_sp(q, k, v, 4, "ulysses")
    _close(_cat(pool.run(f"{RANKS}:attention", "ulysses", False, q, k, v)),
           want)


# ---------------------------------------------------------------------------
# gradients against jax.grad, causal and full; bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_jax_grad(pool, strategy, causal):
    """out and dq/dk/dv of sum(out * w) against jax.grad of the JAX
    function (module docstring)."""
    q, k, v, w = _qkv(3, (2, 32, 8, 16), 4)
    out, grads = _attention_grads(strategy, causal, q, k, v, w)
    res = pool.run(f"{RANKS}:attention", strategy, causal, q, k, v, w)
    _close(_cat(res), out)
    for i, g in enumerate(grads):
        _close(np.concatenate([r["grads"][i] for r in res], axis=1), g)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_bf16_inputs_within_the_bf16_rule(pool, strategy):
    """bf16 q, k, v: the output and gradients against the JAX f32 run of
    the same (bf16-representable) inputs, at BF16_TOL."""
    q, k, v, w = (a.astype(jnp.bfloat16).astype(np.float32)
                  for a in _qkv(4, (1, 32, 4, 16), 4))
    out, grads = _attention_grads(strategy, True, q, k, v, w)
    res = pool.run(f"{RANKS}:attention", strategy, True, q, k, v, w,
                   dtype="bfloat16")
    _close(_cat(res), out, BF16_TOL)
    for i, g in enumerate(grads):
        _close(np.concatenate([r["grads"][i] for r in res], axis=1), g,
               BF16_TOL)


# ---------------------------------------------------------------------------
# tests/test_parallel.py :236, :249, :276 as ledger counts
# ---------------------------------------------------------------------------

def test_ring_attention_makes_n_minus_1_hops_of_k_and_v(pool):
    """The ring's K/V rotation is its collective: n - 1 hops of K and of
    V forward (the JAX scan makes n and discards the last), each the
    rank's [B, T/n, H, D] block; backward n - 1 of K and V and n of dK
    and dV (f32)."""
    b, t, h, d = 1, 64, 4, 16
    q, k, v, w = _qkv(11, (b, t, h, d), 4)
    block = b * (t // WORLD) * h * d * 4
    for r in pool.run(f"{RANKS}:attention", "ring", False, q, k, v, w):
        fwd = r["fwd"]["kinds"]
        assert set(fwd) == {"collective-permute"}
        assert fwd["collective-permute"] == {
            "count": 2 * (WORLD - 1), "bytes": 2 * (WORLD - 1) * block}
        assert r["all"]["kinds"]["collective-permute"]["count"] == \
            2 * (WORLD - 1) + 2 * (WORLD - 1) + 2 * WORLD


def test_ulysses_attention_makes_four_all_to_alls(pool):
    """Ulysses' sequence/head swap: four all-to-alls forward (q, k, v,
    out), each the rank's whole [B, T/n, H, D] shard, and four
    backward."""
    b, t, h, d = 1, 32, 8, 16
    q, k, v, w = _qkv(12, (b, t, h, d), 4)
    shard = b * (t // WORLD) * h * d * 4
    for r in pool.run(f"{RANKS}:attention", "ulysses", False, q, k, v, w):
        assert r["fwd"]["kinds"] == {"all-to-all": {"count": 4,
                                                    "bytes": 4 * shard}}
        assert r["all"]["kinds"] == {"all-to-all": {"count": 8,
                                                    "bytes": 8 * shard}}


def test_pipeline_makes_a_hop_a_tick(pool):
    """The GPipe stage hop: n_micro + n - 1 hops of a microbatch
    forward, as many backward, and one all-reduce of the output."""
    rng = np.random.RandomState(14)
    params = {"w": (rng.randn(WORLD, 16, 16) * 0.1).astype(np.float32),
              "b": np.zeros((WORLD, 16), np.float32)}
    x = rng.randn(8, 16).astype(np.float32)
    ticks = 4 + WORLD - 1
    for r in pool.run(f"{RANKS}:pipeline", params, x, 4, True):
        kinds = r["ledger"]["kinds"]
        assert kinds["collective-permute"] == {
            "count": 2 * ticks, "bytes": 2 * ticks * 2 * 16 * 4}
        assert kinds["all-reduce"] == {"count": 1, "bytes": 8 * 16 * 4}


# ---------------------------------------------------------------------------
# collectives.ppermute and the refusal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift", [1, -1])
def test_ppermute_round_trip_and_backward(pool, shift):
    """Rank r's tensor reaches rank r + shift; the backward is the
    reverse hop (rank r's gradient is the weight of the rank it went
    to); one collective-permute each way."""
    res = pool.run(f"{RANKS}:ppermute_round_trip", shift)
    for r, got in enumerate(res):
        src = (r - shift) % WORLD
        np.testing.assert_array_equal(
            got["got"], (np.arange(6) + 10 * src).reshape(2, 3))
        np.testing.assert_array_equal(
            got["grad"], np.full((2, 3), (r + shift) % WORLD + 1.0))
        assert got["ledger"]["kinds"] == {
            "collective-permute": {"count": 2, "bytes": 48}}


def test_ulysses_refuses_heads_that_do_not_split(pool):
    for msg in pool.run(f"{RANKS}:refuse_heads"):
        assert msg is not None and "6 heads do not split" in msg


# ---------------------------------------------------------------------------
# tests/test_pipeline.py
# ---------------------------------------------------------------------------

def _jmesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), ("pp",))


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _params(n_stages, d, rng):
    return {"w": rng.normal(0, 0.3, (n_stages, d, d)).astype(np.float32),
            "b": rng.normal(0, 0.1, (n_stages, d)).astype(np.float32)}


def _jparams(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("n_micro", [2, 4, 8])
def test_pipeline_forward_matches_serial(pool, n_micro):
    rng = np.random.RandomState(0)
    params = _params(4, 16, rng)
    x = rng.rand(8, 16).astype(np.float32)
    mesh = _jmesh(4)
    want = jax.jit(lambda p, xx: pipeline_apply(
        _jstage, p, xx, mesh, n_microbatches=n_micro))(_jparams(params),
                                                        jnp.asarray(x))
    res = pool.run(f"{RANKS}:pipeline", params, x, n_micro)
    for r in res:
        _close(r["out"], want)
        np.testing.assert_array_equal(r["out"], res[0]["out"])
    _close(res[0]["reference"],
           pipeline_reference(_jstage, _jparams(params), jnp.asarray(x)))


def test_pipeline_gradients_match_serial(pool):
    """Each rank's stage gradients of sum(out ** 2) against jax.grad of
    the JAX serial oracle (which the JAX test holds the JAX pipeline's
    to); the other stages' rows of its gradient are zero (the backward
    of the closing all-reduce is the identity)."""
    rng = np.random.RandomState(1)
    params = _params(4, 8, rng)
    x = rng.rand(4, 8).astype(np.float32)
    gr = jax.jit(jax.grad(lambda p: jnp.sum(pipeline_reference(
        _jstage, p, jnp.asarray(x)) ** 2)))(_jparams(params))
    for r, res in enumerate(pool.run(f"{RANKS}:pipeline", params, x, 2,
                                     True)):
        assert res["other_rows_zero"]
        for key in gr:
            _close(res["grads"][key], gr[key][r])


def test_pipeline_two_stages(pool):
    """pp=2 (the 4-rank world as dp=2 x pp=2: each dp row runs the
    same two-stage pipeline)."""
    rng = np.random.RandomState(2)
    params = _params(2, 8, rng)
    x = rng.rand(6, 8).astype(np.float32)
    mesh = _jmesh(2)
    want = jax.jit(lambda p, xx: pipeline_apply(
        _jstage, p, xx, mesh, n_microbatches=3))(_jparams(params),
                                                  jnp.asarray(x))
    for r in pool.run(f"{RANKS}:pipeline", params, x, 3,
                      axes={"dp": 2, "pp": 2}):
        _close(r["out"], want)
        assert r["ledger"]["kinds"]["collective-permute"]["count"] == 4


def test_bubble_fraction_is_the_gpipe_formula():
    for n, m in ((1, 4), (4, 4), (4, 12), (4, 32), (2, 4)):
        assert bubble_fraction(n, m) == jbubble(n, m)
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(4, 32) < bubble_fraction(4, 4)
    with pytest.raises(ValueError):
        bubble_fraction(0, 4)
    with pytest.raises(ValueError):
        bubble_fraction(4, 0)


def test_pipeline_window_runs_k_windows_and_reports_stages(pool):
    """K windows, each the JAX serial oracle's output; the schedule has
    the JAX test's keys and values; each rank registers the whole run's report
    (steps=K, every rank of the axis) and its own stage's, so the ranks
    together report every stage once; the stage's flops are its
    product's."""
    rng = np.random.RandomState(3)
    params = _params(4, 8, rng)
    k = 3
    xw = rng.rand(k, 8, 8).astype(np.float32)
    oracle = jax.jit(lambda p, xx: pipeline_reference(_jstage, p, xx))
    jout = [oracle(_jparams(params), jnp.asarray(xw[i])) for i in range(k)]
    jsched = {"n_stages": 4, "n_microbatches": 4, "windows": k,
              "ticks_per_window": 4 + 4 - 1,
              "bubble_fraction": jbubble(4, 4)}
    res = pool.run(f"{RANKS}:window", params, xw, 4)
    stages = set()
    for r in res:
        assert r["out"].shape == (k, 8, 8)
        _close(r["out"], np.stack(jout))
        sched = r["schedule"]
        assert {key: sched[key] for key in jsched} == jsched
        whole = [p for p in r["reports"] if p["layer"] == "pipeline"]
        mine = [p for p in r["reports"] if p["layer"] == "pipeline_stage"]
        assert len(whole) == 1 and whole[0]["steps"] == k \
            and whole[0]["num_devices"] == 4 \
            and whole[0]["mesh_shape"] == {"pp": 4}
        # the stage's one product: a [2, 8] microbatch times w [8, 8]
        assert len(mine) == 1 and mine[0]["flops"] == 2 * 2 * 8 * 8
        assert whole[0]["flops"] == mine[0]["flops"] * 4 * k
        stages.add(mine[0]["fingerprint"])
        assert set(sched["report_seqs"]) == {whole[0]["seq"],
                                             mine[0]["seq"]}
    assert stages == {f"pipeline[pp]:stage{i}" for i in range(4)}
