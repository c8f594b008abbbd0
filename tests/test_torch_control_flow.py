"""Control flow, tensor arrays and the LoD machinery in the port against
the JAX package, on the CPU.

Twins of tests/test_control_flow.py, test_control_flow_grad.py and
test_lod_machinery.py: each program is built by the same code with each
package's front end (the programs' JSON must be equal), both run on the
same numpy feed, and every fetch of the port must equal the JAX
package's (integers exactly, floats to 1e-5 relative).  Programs with
parameters load the JAX startup's state.  The gradients come from each
package's ``calc_gradient``: the port's must equal the JAX package's
(1e-5) and the central differences of the port's own loss, at the JAX
tests' tolerances.  A JAX-built While program also runs in the port from
its JSON.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu import layers as jlayers
from paddle_tpu.core.backward import calc_gradient as jcalc
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.backward import calc_gradient as pcalc
from paddle_tpu_torch.core.program import Program

JAX = (jfluid, jlayers, jcalc)
PORT = (fluid, players, pcalc)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh():
    jfluid.core.program.reset_default_programs()
    fluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _close(got, want, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6,
                                   err_msg=name)


def _build_both(build, tmp_path=None):
    """``build(fluid, layers, calc_gradient)`` -> fetch vars, in each
    package's fresh default programs; the programs must be the same.
    Returns [(executor, main, fetch)] for JAX then the port, the port's
    scope holding the JAX startup's persistables."""
    runs = []
    for pkg in (JAX, PORT):
        pkg[0].core.program.reset_default_programs()
        fetch = build(*pkg)
        runs.append((pkg[0], pkg[0].default_main_program(), fetch))
    assert runs[0][1].to_dict() == runs[1][1].to_dict()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    exe = fluid.Executor(fluid.CPUPlace())
    if tmp_path is not None:
        jio.save_persistables(jexe, str(tmp_path), runs[0][1])
        pio.load_persistables(exe, str(tmp_path), runs[1][1])
    else:
        exe.run(fluid.default_startup_program())
    return [(jexe,) + runs[0][1:], (exe,) + runs[1][1:]]


def _run_both(build, feed, tmp_path=None):
    """Both packages on ``feed``; the fetches must agree -> port's."""
    (jexe, jmain, jf), (exe, main, pf) = _build_both(build, tmp_path)
    want = jexe.run(jmain, feed=feed, fetch_list=jf)
    got = exe.run(main, feed=feed, fetch_list=pf)
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"fetch {k}")
    return got


# ---------------------------------------------------------------------------
# test_control_flow.py twins
# ---------------------------------------------------------------------------

def _while_sum(f, L, cg, limit=10):
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    lim = L.fill_constant(shape=[1], dtype="int64", value=limit)
    total = L.fill_constant(shape=[1], dtype="int64", value=0)
    cond = L.less_than(x=i, y=lim)
    w = L.While(cond=cond)
    with w.block():
        L.assign(L.elementwise_add(x=total, y=i), output=total)
        L.increment(i, value=1, in_place=True)
        L.less_than(x=i, y=lim, cond=cond)
    return [total, i]


def _while_data_dependent(f, L, cg):
    n = L.data(name="n", shape=[1], dtype="int64", append_batch_size=False)
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    acc = L.fill_constant(shape=[1], dtype="float32", value=1.0)
    cond = L.less_than(x=i, y=n)
    w = L.While(cond=cond)
    with w.block():
        L.assign(L.scale(acc, scale=2.0), output=acc)
        L.increment(i, value=1, in_place=True)
        L.less_than(x=i, y=n, cond=cond)
    return [acc, i]


def _if_else(f, L, cg):
    x = L.data(name="x", shape=[1], dtype="float32")
    zero = L.fill_constant_batch_size_like(x, shape=[-1, 1],
                                           dtype="float32", value=0.0)
    ie = L.IfElse(L.less_than(x=x, y=zero))
    with ie.true_block():
        ie.output(L.scale(ie.input(x), scale=-1.0))
    with ie.false_block():
        ie.output(L.scale(ie.input(x), scale=2.0))
    return [ie()]


def _conditional(f, L, cg):
    flag = L.data(name="flag", shape=[1], dtype="float32",
                  append_batch_size=False)
    out = L.fill_constant(shape=[1], dtype="float32", value=-1.0)
    one = L.fill_constant(shape=[1], dtype="float32", value=0.5)
    cb = L.ConditionalBlock([L.less_than(x=one, y=flag)])
    with cb.block():
        L.assign(L.fill_constant(shape=[1], dtype="float32", value=7.0),
                 output=out)
    return [out]


def _nested_conditional_in_while(f, L, cg):
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    lim = L.fill_constant(shape=[1], dtype="int64", value=5)
    total = L.fill_constant(shape=[1], dtype="int64", value=0)
    always = L.fill_constant(shape=[1], dtype="int64", value=-1)
    cond = L.less_than(x=i, y=lim)
    w = L.While(cond=cond)
    with w.block():
        cb = L.ConditionalBlock([L.less_than(x=always, y=i)])
        with cb.block():
            L.assign(L.elementwise_add(x=total, y=i), output=total)
        L.increment(i, value=1, in_place=True)
        L.less_than(x=i, y=lim, cond=cond)
    return [total]


CASES = {
    "while_accumulates_until_limit": (_while_sum, {}, [[45], [10]]),
    "while_with_data_dependent_trip_count": (
        _while_data_dependent, {"n": np.array([5], np.int64)},
        [[32.0], [5]]),
    "if_else_row_routing": (
        _if_else, {"x": np.array([[-1.0], [2.0], [-3.0], [4.0]],
                                 np.float32)},
        [[[1.0], [4.0], [3.0], [8.0]]]),
    "conditional_block_taken": (
        _conditional, {"flag": np.array([1.0], np.float32)}, [[7.0]]),
    "conditional_block_skipped": (
        _conditional, {"flag": np.array([0.0], np.float32)}, [[-1.0]]),
    "nested_conditional_in_while_writes_global_var": (
        _nested_conditional_in_while, {}, [[10]]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_control_flow_twins(case):
    build, feed, expect = CASES[case]
    got = _run_both(build, feed)
    for g, e in zip(got, expect):
        np.testing.assert_allclose(np.asarray(g).astype(np.float64), e)


def test_parallel_do_matches_serial(tmp_path):
    def build(f, L, cg):
        x = L.data(name="x", shape=[4], dtype="float32")
        pd = L.ParallelDo(L.get_places())
        with pd.do():
            h = L.fc(input=pd.read_input(x), size=3, act="tanh",
                     param_attr=f.ParamAttr(name="w_shared"))
            pd.write_output(h)
        out = pd()
        ref = L.fc(input=x, size=3, act="tanh",
                   param_attr=f.ParamAttr(name="w_shared"))
        return [out, ref]
    xs = np.random.RandomState(0).rand(6, 4).astype(np.float32)
    got, ref = _run_both(build, {"x": xs}, tmp_path)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_while_inside_grad_free_region_trains_outside(tmp_path):
    """A While after the optimizer (never differentiated) beside a
    trained fc: 40 SGD steps, losses step for step and the loop's sum."""
    def build(f, L, cg):
        x = L.data(name="x", shape=[4], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        loss = L.mean(L.square_error_cost(input=L.fc(input=x, size=1),
                                          label=y))
        f.optimizer.SGD(learning_rate=0.05).minimize(loss)
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        lim = L.fill_constant(shape=[1], dtype="int64", value=3)
        acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.less_than(x=i, y=lim)
        w = L.While(cond=cond)
        with w.block():
            L.assign(L.elementwise_add(x=acc, y=L.cast(i, "float32")),
                     output=acc)
            L.increment(i, value=1, in_place=True)
            L.less_than(x=i, y=lim, cond=cond)
        return [loss, acc]
    runs = _build_both(build, tmp_path)
    rng = np.random.RandomState(0)
    wtrue = rng.rand(4, 1).astype(np.float32)
    losses = ([], [])
    for _ in range(40):
        xs = rng.rand(16, 4).astype(np.float32)
        feed = {"x": xs, "y": xs @ wtrue}
        for k, (exe, main, fetch) in enumerate(runs):
            loss, acc = exe.run(main, feed=feed, fetch_list=fetch)
            losses[k].append(float(np.asarray(loss).reshape(-1)[0]))
            assert float(np.asarray(acc).reshape(-1)[0]) == 3.0
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    assert losses[1][-1] < losses[1][0] * 0.3


def test_jax_built_while_runs_from_json():
    """The JAX front end's While program (carry_vars, sub_block) parsed
    from JSON runs in the port."""
    total, i = _while_sum(*JAX[:2], None, limit=7)
    main = jfluid.default_main_program()
    prog = Program.parse_from_string(main.serialize_to_string())
    got = fluid.Executor(fluid.CPUPlace()).run(
        prog, feed={}, fetch_list=[total.name, i.name],
        scope=fluid.core.scope.Scope())
    assert int(got[0][0]) == 21 and int(got[1][0]) == 7


def test_bounded_while_warns_when_truncated():
    """Under FLAGS.check_nan_inf a bounded loop whose condition still
    holds at max_trip_count warns (and keeps the truncated result)."""
    def build(f, L, cg):
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        lim = L.fill_constant(shape=[1], dtype="int64", value=9)
        cond = L.less_than(x=i, y=lim)
        w = L.While(cond=cond, max_trip_count=4)
        with w.block():
            L.increment(i, value=1, in_place=True)
            L.less_than(x=i, y=lim, cond=cond)
        return [i]
    fluid.FLAGS.check_nan_inf = True
    try:
        with pytest.warns(UserWarning, match="max_trip_count=4"):
            (got,) = _build_both(build)[1][0].run(
                fluid.default_main_program(), feed={},
                fetch_list=[fluid.default_main_program().global_block()
                            .ops[-1].desc.outputs["Out"][0]])
    finally:
        fluid.FLAGS.check_nan_inf = False
    assert int(got[0]) == 4


def test_switch_and_print_build_the_jax_programs(capsys):
    """Switch's case scopes and Print build the JAX package's programs;
    Print prints its message and passes its input through."""
    def build(f, L, cg):
        x = L.data(name="x", shape=[2], dtype="float32")
        sw = L.Switch()
        with sw.case(L.less_than(x=x, y=x)):
            pass
        with sw.default():
            pass
        return [L.Print(L.scale(x, scale=3.0), message="tripled")]
    xs = np.array([[1.0, 2.0]], np.float32)
    (got,) = _run_both(build, {"x": xs})
    np.testing.assert_allclose(got, 3 * xs)
    assert "tripled [[3. 6.]]" in capsys.readouterr().out


def test_array_write_read_length():
    def build(f, L, cg):
        x = L.data(name="x", shape=[3], dtype="float32")
        i0 = L.fill_constant(shape=[1], dtype="int64", value=0)
        i1 = L.fill_constant(shape=[1], dtype="int64", value=1)
        arr = L.array_write(x, i0)
        L.array_write(L.scale(x, scale=2.0), i1, array=arr)
        return [L.array_read(arr, i1), L.array_length(arr)]
    xs = np.arange(6, dtype=np.float32).reshape(2, 3)
    got, n = _run_both(build, {"x": xs})
    np.testing.assert_allclose(got, 2 * xs)
    assert int(n) == 2


# ---------------------------------------------------------------------------
# test_lod_machinery.py twins
# ---------------------------------------------------------------------------

def test_rank_table_and_reorder():
    def build(f, L, cg):
        x = L.data(name="x", shape=[4, 2], dtype="float32", lod_level=1)
        table = L.lod_rank_table(x)
        return [table, L.reorder_lod_tensor_by_rank(x, table),
                L.max_sequence_len(table)]
    xs = np.random.RandomState(0).rand(3, 4, 2).astype(np.float32)
    got_t, got_r, got_m = _run_both(
        build, {"x": xs, "x@SEQ_LEN": np.array([2, 4, 3], np.int32)})
    np.testing.assert_array_equal(got_t, [1, 2, 0])
    np.testing.assert_allclose(got_r, xs[[1, 2, 0]])
    assert int(got_m[0]) == 4


def test_lod_tensor_array_roundtrip():
    def build(f, L, cg):
        x = L.data(name="x", shape=[3, 2], dtype="float32")
        arr = L.lod_tensor_to_array(x)
        return [L.array_to_lod_tensor(arr),
                L.array_read(arr, L.fill_constant([1], "int64", 1))]
    xs = np.random.RandomState(0).rand(4, 3, 2).astype(np.float32)
    back, step1 = _run_both(build, {"x": xs})
    np.testing.assert_allclose(back, xs)
    np.testing.assert_allclose(step1, xs[:, 1])


def test_shrink_rnn_memory_masks_finished_rows():
    def build(f, L, cg):
        x = L.data(name="x", shape=[4, 3], dtype="float32", lod_level=1)
        mem = L.data(name="mem", shape=[5], dtype="float32")
        table = L.lod_rank_table(x)
        return [L.shrink_memory(mem, L.fill_constant([1], "int64", 2),
                                table)]
    ms = np.random.RandomState(1).rand(3, 5).astype(np.float32)
    (got,) = _run_both(build, {
        "x": np.random.RandomState(0).rand(3, 4, 3).astype(np.float32),
        "x@SEQ_LEN": np.array([2, 4, 3], np.int32), "mem": ms})
    want = ms.copy()
    want[0] = 0.0
    np.testing.assert_allclose(got, want)


def test_split_merge_roundtrip():
    def build(f, L, cg):
        x = L.data(name="x", shape=[2], dtype="float32")
        half = L.fill_constant_batch_size_like(x, shape=[-1, 1],
                                               dtype="float32", value=0.5)
        mask = L.less_than(x=half, y=L.slice(x, axes=[1], starts=[0],
                                            ends=[1]))
        t, fl = L.split_lod_tensor(x, mask)
        return [t, fl, L.merge_lod_tensor(t, fl, x, mask)]
    xs = np.array([[0.9, 1.0], [0.1, 2.0], [0.8, 3.0]], np.float32)
    t, fl, merged = _run_both(build, {"x": xs})
    np.testing.assert_allclose(merged, xs)
    np.testing.assert_allclose(t + fl, xs)
    assert (t[1] == 0).all() and (fl[0] == 0).all()


# ---------------------------------------------------------------------------
# test_control_flow_grad.py twins: calc_gradient against JAX and central
# differences
# ---------------------------------------------------------------------------

def _grad_both(build, wrt, feed, delta=1e-3, rtol=3e-2, atol=1e-3):
    """``build`` -> (loss, wrt var); the port's calc_gradient equals the
    JAX package's and the port's own central differences -> the port's
    gradient."""
    grads, exes = [], []
    for f, L, cg in (JAX, PORT):
        f.core.program.reset_default_programs()
        loss, x = build(f, L, cg)
        (g,) = cg(loss, [x])
        exe = f.Executor(f.CPUPlace())
        exe.run(f.default_startup_program())
        grads.append(np.asarray(exe.run(f.default_main_program(), feed=feed,
                                        fetch_list=[g])[0]))
        exes.append((exe, loss))
    np.testing.assert_allclose(grads[1], grads[0], rtol=RTOL, atol=1e-6)
    exe, loss = exes[1]
    main = fluid.default_main_program()
    base = feed[wrt].astype(np.float64)
    fd = np.zeros_like(base)
    for idx in np.ndindex(base.shape):
        for sign in (1, -1):
            pert = base.copy()
            pert[idx] += sign * delta
            val = exe.run(main, feed=dict(feed, **{wrt: pert.astype(
                np.float32)}), fetch_list=[loss])[0]
            fd[idx] += sign * float(np.asarray(val))
        fd[idx] /= 2 * delta
    np.testing.assert_allclose(grads[1].reshape(fd.shape), fd, rtol=rtol,
                               atol=atol)
    return grads[1]


def _while_acc(L, bounded=True, limit=5):
    x = L.data(name="x", shape=[3], dtype="float32", append_batch_size=False)
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    lim = L.fill_constant(shape=[1], dtype="int64", value=limit)
    acc = L.fill_constant(shape=[3], dtype="float32", value=0.0)
    acc.stop_gradient = False
    cond = L.less_than(x=i, y=lim)
    w = L.While(cond=cond, max_trip_count=8 if bounded else None)
    with w.block():
        L.assign(L.elementwise_add(L.scale(acc, scale=1.1), x), output=acc)
        L.increment(i, value=1, in_place=True)
        L.less_than(x=i, y=lim, cond=cond)
    return L.reduce_sum(acc), x


def test_while_grad_fd():
    g = _grad_both(lambda f, L, cg: _while_acc(L), "x",
                   {"x": np.array([0.3, -0.7, 1.2], np.float32)})
    np.testing.assert_allclose(g, np.full((3,), sum(1.1 ** k
                                                    for k in range(5))),
                               rtol=1e-5)


def _rnn(L, static):
    x = L.data(name="x", shape=[-1, 2], dtype="float32", lod_level=1)
    rnn = L.StaticRNN() if static else L.DynamicRNN()
    with (rnn.step() if static else rnn.block()):
        x_t = rnn.step_input(x)
        h = rnn.memory(shape=[2], value=0.0)
        new_h = (L.scale(L.elementwise_add(h, x_t), scale=0.7) if static
                 else L.elementwise_add(L.scale(h, scale=0.5), x_t))
        rnn.update_memory(h, new_h)
        rnn.output(new_h)
    return L.reduce_sum(rnn()), x


@pytest.mark.parametrize("static,feed", [
    (False, {"x": np.array([[[0.2, -0.4], [0.6, 0.1], [0.05, 0.3]],
                            [[-0.3, 0.8], [0.9, -0.2], [0.0, 0.0]]],
                           np.float32),
             "x@SEQ_LEN": np.array([3, 2], np.int32)}),
    (True, {"x": np.array([[[0.2, -0.4], [0.6, 0.1]],
                           [[-0.3, 0.8], [0.9, -0.2]]], np.float32),
            "x@SEQ_LEN": np.array([2, 2], np.int32)})],
    ids=["dynamic_rnn", "static_rnn"])
def test_rnn_grad_fd(static, feed):
    _grad_both(lambda f, L, cg: _rnn(L, static), "x", feed)


def _cond_grad(L):
    x = L.data(name="x", shape=[3], dtype="float32", append_batch_size=False)
    flag = L.data(name="flag", shape=[1], dtype="float32",
                  append_batch_size=False)
    one = L.fill_constant(shape=[1], dtype="float32", value=0.5)
    out = L.fill_constant(shape=[3], dtype="float32", value=1.0)
    out.stop_gradient = False
    cb = L.ConditionalBlock([L.less_than(x=one, y=flag)])
    with cb.block():
        L.assign(L.scale(x, scale=3.0), output=out)
    return L.reduce_sum(out), x


@pytest.mark.parametrize("flag", [1.0, 0.0], ids=["taken", "skipped"])
def test_conditional_block_grad_fd(flag):
    g = _grad_both(lambda f, L, cg: _cond_grad(L), "x",
                   {"x": np.array([0.1, -0.2, 0.4], np.float32),
                    "flag": np.array([flag], np.float32)})
    np.testing.assert_allclose(g, np.full(3, 3.0 * flag), atol=1e-6)


def test_while_unbounded_stays_forward_only():
    """Without max_trip_count the forward result equals the bounded
    loop's, and a gradient through it is refused with the JAX package's
    kind of error (ValueError)."""
    def build(bounded):
        def b(f, L, cg):
            i = L.fill_constant(shape=[1], dtype="int64", value=0)
            lim = L.fill_constant(shape=[1], dtype="int64", value=7)
            acc = L.fill_constant(shape=[1], dtype="float32", value=1.0)
            cond = L.less_than(x=i, y=lim)
            w = L.While(cond=cond, max_trip_count=10 if bounded else None)
            with w.block():
                L.assign(L.scale(acc, scale=2.0), output=acc)
                L.increment(i, value=1, in_place=True)
                L.less_than(x=i, y=lim, cond=cond)
            return [acc]
        return b
    assert (float(_run_both(build(True), {})[0][0])
            == float(_run_both(build(False), {})[0][0]) == 2.0 ** 7)
    feed = {"x": np.array([0.3, -0.7, 1.2], np.float32)}
    for f, L, cg in (JAX, PORT):
        f.core.program.reset_default_programs()
        loss, x = _while_acc(L, bounded=False)
        (g,) = cg(loss, [x])
        exe = f.Executor(f.CPUPlace())
        with pytest.raises(ValueError, match="while"):
            exe.run(f.default_main_program(), feed=feed, fetch_list=[g])
    # the port skips the unfetched backward op, so the forward alone runs
    # (the JAX executor traces the backward op whatever is fetched)
    (val,) = exe.run(fluid.default_main_program(), feed=feed,
                     fetch_list=[loss])
    np.testing.assert_allclose(
        val, feed["x"].sum() * sum(1.1 ** k for k in range(5)), rtol=1e-5)


def test_write_read_array_grad():
    """write_to_array then read_from_array passes the gradient through
    (test_op_grad.py's case, built as a raw program in both packages)."""
    xs = np.random.RandomState(0).uniform(-1, 1, (2, 3)).astype(np.float32)
    out = []
    for f, L, cg in (JAX, PORT):
        f.core.program.reset_default_programs()
        block = f.default_main_program().global_block()
        x = block.create_var(name="x", shape=(2, 3), dtype="float32",
                             stop_gradient=False, is_data=True)
        i = block.create_var(name="i", shape=(1,), dtype="int64",
                             stop_gradient=True)
        block.append_op("fill_constant", outputs={"Out": [i]},
                        attrs={"shape": [1], "value": 0, "dtype": "int64"})
        arr = block.create_var(name="arr", shape=(1,), dtype="float32")
        block.append_op("write_to_array", inputs={"X": [x], "I": [i]},
                        outputs={"Out": [arr]})
        y = block.create_var(name="y", shape=(2, 3), dtype="float32")
        block.append_op("read_from_array", inputs={"X": [arr], "I": [i]},
                        outputs={"Out": [y]})
        loss = block.create_var(name="loss", shape=(1,), dtype="float32")
        block.append_op("reduce_sum", inputs={"X": [y]},
                        outputs={"Out": [loss]}, attrs={"reduce_all": True})
        (gx,) = cg(loss, [x])
        out.append(f.Executor(f.CPUPlace()).run(
            f.default_main_program(), feed={"x": xs}, fetch_list=[loss, gx]))
    for g, w in zip(out[1], out[0]):
        _close(g, w)
    np.testing.assert_allclose(out[1][1], np.ones((2, 3)))
