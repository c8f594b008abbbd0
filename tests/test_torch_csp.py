"""CSP in the port against the JAX package, on the CPU.

Twins of tests/test_csp_channels.py and the CSP tests of
test_aux_subsystems.py: each in-program CSP program is built by the same
code with each package's front end (the JSON must be equal); the
JAX-built program runs in the JAX package and, from its JSON, in the
port, and the fetches must be equal (and equal the reference's
constants).  The host API (`Channel`, `Go`, `Select`) is held to the
same protocol.  Every run is bounded: a program runs on a thread joined
with a timeout that fails the test, so a deadlock cannot stall the
suite.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import concurrency as jconc
from paddle_tpu import layers as jlayers
import paddle_tpu_torch as fluid
from paddle_tpu_torch import concurrency as conc
from paddle_tpu_torch import layers
from paddle_tpu_torch.core.program import Program
from paddle_tpu_torch.core.registry import OpRegistry

JAX = (jfluid, jlayers, jconc)
PORT = (fluid, layers, conc)
#: the bound of one program run, seconds
RUN_TIMEOUT = 60.0


@pytest.fixture(autouse=True)
def _fresh():
    jfluid.core.program.reset_default_programs()
    fluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _bounded(fn, timeout=RUN_TIMEOUT):
    """``fn()`` on a daemon thread; fails the test if it has not
    returned after ``timeout`` seconds, else returns or raises what it
    did."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001  (re-raised below)
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"no result after {timeout} s (a deadlock)"
    if "error" in out:
        raise out["error"]
    return out["value"]


# ---------------------------------------------------------------------------
# the programs: build(fluid, layers, concurrency) -> (feed, fetch vars,
# the expected fetches)
# ---------------------------------------------------------------------------

def _simple_routine(fl, L, C):
    """A Go block sends 1234; the main block receives it."""
    ch = C.make_channel(capacity=0, in_program=True)
    result = fl.default_main_program().global_block().create_var(
        name="ret", shape=(1,), dtype="float32")
    with C.ProgramGo():
        val = L.fill_constant(shape=[1], dtype="float32", value=1234.0)
        C.channel_send(ch, val)
    out, _ = C.channel_recv(ch, result)
    C.channel_close(ch)
    return {}, [out], [1234.0]


def _daisy_chain(fl, L, C, n=12):
    """Each Go stage receives from the right and sends value + 1 left."""
    leftmost = C.make_channel(capacity=0, in_program=True)
    left = leftmost
    main = fl.default_main_program()
    for i in range(n):
        right = C.make_channel(capacity=0, in_program=True)
        with C.ProgramGo():
            ret = main.current_block().create_var(
                name=f"ret_{i}", shape=(1,), dtype="float32")
            got, _ = C.channel_recv(right, ret)
            one = L.fill_constant(shape=[1], dtype="float32", value=1.0)
            C.channel_send(left, L.elementwise_add(one, got))
        left = right
    with C.ProgramGo():
        one = L.fill_constant(shape=[1], dtype="float32", value=1.0)
        C.channel_send(right, one)
    final = main.global_block().create_var(name="final", shape=(1,),
                                           dtype="float32")
    out, _ = C.channel_recv(leftmost, final)
    return {}, [out], [n + 1.0]


def _fibonacci(fl, L, C):
    """A while + select producer of Fibonacci numbers and a Go consumer
    that receives 10 of them, then sends quit; the last is 34."""
    main = fl.default_main_program()
    ch = C.make_channel(capacity=0, in_program=True)
    quit_ch = C.make_channel(capacity=0, in_program=True)
    result = main.global_block().create_var(name="result", shape=(1,),
                                            dtype="float32")
    L.fill_constant(shape=[1], dtype="float32", value=-1.0, out=result)
    with C.ProgramGo():
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        limit = L.fill_constant(shape=[1], dtype="int64", value=10)
        cond = L.less_than(x=i, y=limit)
        w = L.While(cond=cond)
        with w.block():
            got, _ = C.channel_recv(ch, result)
            L.assign(got, output=result)
            L.increment(i, value=1, in_place=True)
            L.less_than(x=i, y=limit, cond=cond)
        one = L.fill_constant(shape=[1], dtype="int64", value=1)
        C.channel_send(quit_ch, one)
    fib_x = main.global_block().create_var(name="fibX", shape=(1,),
                                           dtype="float32")
    fib_y = main.global_block().create_var(name="fibY", shape=(1,),
                                           dtype="float32")
    L.fill_constant(shape=[1], dtype="float32", value=0.0, out=fib_x)
    L.fill_constant(shape=[1], dtype="float32", value=1.0, out=fib_y)
    quit_var = main.global_block().create_var(name="quitVar", shape=(1,),
                                              dtype="int64")
    zero = L.fill_constant(shape=[1], dtype="int64", value=0)
    one_i = L.fill_constant(shape=[1], dtype="int64", value=1)
    go_on = L.less_than(x=zero, y=one_i)
    w = L.While(cond=go_on)
    with w.block():
        with C.ProgramSelect() as sel:
            with sel.case(C.channel_send, ch, fib_x):
                xtemp = L.assign(fib_x)
                L.assign(fib_y, output=fib_x)
                L.assign(L.elementwise_add(xtemp, fib_y), output=fib_y)
            with sel.case(C.channel_recv, quit_ch, quit_var):
                L.less_than(x=one_i, y=zero, cond=go_on)
    return {}, [result], [34.0]


def _fed(fl, L, C):
    """A fed and fetched program: its send's Status is never read."""
    ch = C.make_channel(capacity=1, in_program=True)
    x = L.data(name="x", shape=[1], dtype="float32")
    doubled = L.scale(x, scale=2.0)
    C.channel_send(ch, doubled)
    ret = fl.default_main_program().global_block().create_var(
        name="ret", shape=(1, 1), dtype="float32")
    got, _ = C.channel_recv(ch, ret)
    return ({"x": np.ones((1, 1), np.float32)}, [doubled, got],
            [2.0, 2.0])


def _select_closed_drained(fl, L, C):
    """A select recv case on a closed, drained channel fires: its body
    runs and the value var keeps its value."""
    ch = C.make_channel(capacity=1, in_program=True)
    marker = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    val = L.fill_constant(shape=[1], dtype="float32", value=-1.0)
    C.channel_close(ch)
    with C.ProgramSelect() as sel:
        with sel.case(C.channel_recv, ch, val):
            L.assign(L.fill_constant(shape=[1], dtype="float32", value=7.0),
                     output=marker)
    return {}, [marker, val], [7.0, -1.0]


def _select_default(fl, L, C):
    """With a default case and no ready channel case, default runs."""
    ch = C.make_channel(capacity=0, in_program=True)      # no peer
    x = L.fill_constant(shape=[1], dtype="float32", value=3.0)
    out = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    with C.ProgramSelect() as sel:
        with sel.case(C.channel_send, ch, x):
            pass
        with sel.default():
            L.assign(L.fill_constant(shape=[1], dtype="float32", value=9.0),
                     output=out)
    return {}, [out], [9.0]


def _send_closed(fl, L, C):
    """A send on a closed channel reports Status False."""
    ch = C.make_channel(capacity=1, in_program=True)
    C.channel_close(ch)
    x = L.fill_constant(shape=[1], dtype="float32", value=5.0)
    status = C.channel_send(ch, x)
    return {}, [status], [False]


def _recv_closed(fl, L, C):
    """A recv on a closed, drained channel gives zeros of the var's shape
    and dtype, and Status False."""
    ch = C.make_channel(capacity=2, in_program=True)
    C.channel_close(ch)
    ret = fl.default_main_program().global_block().create_var(
        name="ret", shape=(2, 3), dtype="float32")
    got, status = C.channel_recv(ch, ret)
    return {}, [got, status], [np.zeros((2, 3), np.float32), False]


def _select_send_value_only_in_cases(fl, L, C):
    """The value a select send case sends is read nowhere else: it must
    count as read."""
    ch = C.make_channel(capacity=1, in_program=True)
    x = L.fill_constant(shape=[1], dtype="float32", value=4.5)
    with C.ProgramSelect() as sel:
        with sel.case(C.channel_send, ch, x):
            pass
    ret = fl.default_main_program().global_block().create_var(
        name="ret", shape=(1,), dtype="float32")
    got, _ = C.channel_recv(ch, ret)
    return {}, [got], [4.5]


PROGRAMS = {"simple_routine": _simple_routine, "daisy_chain": _daisy_chain,
            "fibonacci": _fibonacci, "fed": _fed,
            "select_closed_drained": _select_closed_drained,
            "select_default": _select_default, "send_closed": _send_closed,
            "recv_closed": _recv_closed,
            "select_send_value_only_in_cases":
                _select_send_value_only_in_cases}


def _build(pkg, build):
    pkg[0].core.program.reset_default_programs()
    feed, fetch, want = build(*pkg)
    return pkg[0].default_main_program(), feed, [v.name for v in fetch], want


def _check(got, want, label):
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.reshape(-1).tolist() == np.asarray(
            w, g.dtype).reshape(-1).tolist(), (label, k, g, w)


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_front_ends_give_the_same_json(name):
    jmain = _build(JAX, PROGRAMS[name])[0]
    pmain = _build(PORT, PROGRAMS[name])[0]
    assert pmain.to_dict() == jmain.to_dict()
    assert pmain.serialize_to_string() == jmain.serialize_to_string()


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_jax_program_runs_in_the_port(name):
    """The JAX-built program in both packages: equal fetches, and the
    reference's constants."""
    jmain, feed, names, want = _build(JAX, PROGRAMS[name])
    jgot = _bounded(lambda: jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=dict(feed), fetch_list=names))
    prog = Program.parse_from_string(jmain.serialize_to_string())
    got = _bounded(lambda: fluid.Executor(fluid.CPUPlace()).run(
        prog, feed=dict(feed), fetch_list=names))
    _check(jgot, want, "jax")
    _check(got, want, "port")
    for g, j in zip(got, jgot):
        assert np.asarray(g).dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(j))


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_port_program_runs(name):
    """The port-built program, fetched twice as tensors: the fetches are
    the reference's constants."""
    main, feed, names, want = _build(PORT, PROGRAMS[name])
    got = _bounded(lambda: fluid.Executor(fluid.CPUPlace()).run(
        main, feed=dict(feed), fetch_list=names, return_numpy=False))
    assert all(isinstance(g, torch.Tensor) for g in got)
    _check([g.numpy() for g in got], want, "port")


def test_unread_send_status_still_delivers():
    """Liveness: a send whose Status nothing reads still runs, so the
    receive after it does not block."""
    ch = conc.make_channel(capacity=1, in_program=True)
    x = layers.fill_constant(shape=[1], dtype="float32", value=2.5)
    conc.channel_send(ch, x)
    ret = fluid.default_main_program().global_block().create_var(
        name="ret", shape=(1,), dtype="float32")
    got, _ = conc.channel_recv(ch, ret)
    out = _bounded(lambda: fluid.Executor(fluid.CPUPlace()).run(
        fetch_list=[got]), timeout=20.0)
    assert out[0].tolist() == [2.5]


def test_startup_like_csp_program_runs_and_joins():
    """A feedless, fetchless CSP program goes to run_startup, which joins
    its go threads: the go block's write to a persistable reaches the
    scope."""
    main = fluid.default_main_program()
    acc = main.global_block().create_var(name="acc", shape=(1,),
                                         dtype="float32", persistable=True)
    ch = conc.make_channel(capacity=0, in_program=True)
    with conc.ProgramGo():
        got, _ = conc.channel_recv(ch)
        layers.assign(layers.scale(got, scale=3.0), output=acc)
    conc.channel_send(ch, layers.fill_constant(shape=[1], dtype="float32",
                                               value=2.0))
    _bounded(lambda: fluid.Executor(fluid.CPUPlace()).run(main))
    assert fluid.global_scope().get("acc").tolist() == [6.0]


def test_go_thread_takes_the_spawning_threads_state(monkeypatch):
    """A go block runs with the spawning op's grad mode (off: the op ran
    without recording) and autocast state, not a fresh thread's."""
    seen = []
    rule = OpRegistry.get("fill_constant")
    inner = rule.fn

    def probe(ctx):
        if threading.current_thread() is not threading.main_thread():
            seen.append((torch.is_grad_enabled(),
                         torch.is_autocast_enabled("cpu")))
        return inner(ctx)

    monkeypatch.setattr(rule, "fn", probe)
    ch = conc.make_channel(capacity=0, in_program=True)
    with conc.ProgramGo():
        conc.channel_send(ch, layers.fill_constant(
            shape=[1], dtype="float32", value=1.0))
    got, _ = conc.channel_recv(ch)
    exe = fluid.Executor(fluid.CPUPlace())
    # the executor runs on this (main) thread, under autocast
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = exe.run(fetch_list=[got])
    assert out[0].tolist() == [1.0]
    assert seen == [(False, True)]


def test_go_block_error_raises_at_the_run():
    """What a go block raises comes out of Executor.run."""
    main = fluid.default_main_program()
    with conc.ProgramGo():
        missing = main.current_block().create_var(name="never_set",
                                                  shape=(1,))
        layers.scale(missing, scale=2.0)
    out = layers.fill_constant(shape=[1], dtype="float32", value=1.0)
    with pytest.raises(RuntimeError, match="go block failed"):
        _bounded(lambda: fluid.Executor(fluid.CPUPlace()).run(
            fetch_list=[out]))


def test_channel_var_is_fetched_as_it_is():
    """A channel in the env passes the fetch untouched."""
    ch = conc.make_channel(capacity=3, in_program=True)
    got = fluid.Executor(fluid.CPUPlace()).run(fetch_list=[ch])
    assert isinstance(got[0], conc.Channel)
    assert got[0].ready_for_send()


def test_channel_in_the_scope_passes_the_state():
    """A persistable that holds a channel reaches the rules as the same
    object."""
    main = fluid.default_main_program()
    ch = main.global_block().create_var(name="shared_ch", persistable=True)
    x = layers.fill_constant(shape=[1], dtype="float32", value=8.0)
    conc.channel_send(ch, x)
    host = conc.Channel(capacity=1)
    fluid.global_scope().set("shared_ch", host)
    _bounded(lambda: fluid.Executor(fluid.CPUPlace()).run(
        main, fetch_list=[x]))
    assert fluid.global_scope().get("shared_ch") is host
    v, ok = host.recv(timeout=1.0)
    assert ok and v.tolist() == [8.0]


def test_is_copy_sends_a_clone():
    """Without is_copy the receiver gets the sender's tensor; with it, a
    clone."""
    for is_copy in (False, True):
        fluid.core.program.reset_default_programs()
        ch = conc.make_channel(capacity=1, in_program=True)
        x = layers.fill_constant(shape=[2], dtype="float32", value=1.5)
        conc.channel_send(ch, x, is_copy=is_copy)
        got, _ = conc.channel_recv(ch)
        out = fluid.Executor(fluid.CPUPlace()).run(
            fetch_list=[x, got], return_numpy=False)
        assert (out[0].data_ptr() == out[1].data_ptr()) is not is_copy
        assert out[1].tolist() == [1.5, 1.5]


# ---------------------------------------------------------------------------
# the host API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [0, 1, 4])
def test_channel_send_recv_in_order(capacity):
    ch = conc.Channel(capacity=capacity)
    got = []
    g = conc.Go(lambda: [ch.send(i) for i in range(20)] and ch.close())
    _bounded(lambda: got.extend(ch), timeout=20.0)
    g.join(5)
    assert got == list(range(20))


def test_buffered_channel_close_drain():
    ch = fluid.make_channel(capacity=4)
    for i in range(4):
        fluid.channel_send(ch, i)
    fluid.channel_close(ch)
    assert list(ch) == [0, 1, 2, 3]
    assert fluid.channel_recv(ch) == (None, False)
    with pytest.raises(conc.ChannelClosed):
        ch.send(5)


def test_unbuffered_send_blocks_until_received():
    ch = conc.Channel(capacity=0)
    assert ch.send("x", timeout=0.05) is False       # nobody received
    assert not ch.ready_for_recv()
    got = []
    g = conc.go(lambda: got.append(ch.recv()))
    assert _bounded(lambda: ch.send("y"), timeout=10.0) is True
    g.join(5)
    assert got == [("y", True)]


def test_recv_timeout_raises():
    with pytest.raises(TimeoutError):
        conc.Channel(capacity=1).recv(timeout=0.01)


def test_host_select_fibonacci_matches_jax():
    """test_aux_subsystems' Fibonacci over host channels, in both
    packages."""
    def run(pk):
        ch = pk.make_channel(capacity=0)
        quit_ch = pk.make_channel(capacity=0)

        def fib():
            a, b = 0, 1
            while True:
                sel = pk.Select([("send", ch, a, None),
                                 ("recv", quit_ch, lambda v, ok: "quit")])
                if sel.run() == "quit":
                    return
                a, b = b, a + b

        pk.Go(fib)
        got = [ch.recv()[0] for _ in range(10)]
        quit_ch.send(None)
        return got

    want = _bounded(lambda: run(jfluid))
    assert _bounded(lambda: run(fluid)) == want == [0, 1, 1, 2, 3, 5, 8,
                                                    13, 21, 34]


def test_host_select_rotation_fairness():
    """An always-ready early case does not starve a later one."""
    a, b = conc.Channel(capacity=16), conc.Channel(capacity=16)
    for i in range(12):
        a.send(("a", i))
        b.send(("b", i))
    seen = set()
    for _ in range(16):    # P(the same origin every time) = 2^-15
        v, ok = conc.Select([("recv", a, None), ("recv", b, None)]).run()
        assert ok
        seen.add(v[0])
    assert seen == {"a", "b"}


def test_host_select_default_and_closed():
    ch = conc.Channel(capacity=0)
    assert conc.Select([("send", ch, 1, None),
                        ("default", lambda: "idle")]).run() == "idle"
    ch.close()
    assert conc.Select([("recv", ch, None)]).run() == (None, False)


def test_select_wakes_on_a_later_send():
    """A select with no ready case blocks on its waiter and wakes on the
    send, well before the 250 ms rescan would find it."""
    ch = conc.Channel(capacity=1)

    def later():
        time.sleep(0.05)
        ch.send(7)

    g = conc.Go(later)
    t0 = time.perf_counter()
    v = _bounded(lambda: conc.Select([("recv", ch, None)]).run(), 10.0)
    g.join(5)
    assert v == (7, True)
    assert time.perf_counter() - t0 < 0.25


def test_waiter_snapshot_closes_the_missed_wakeup():
    w = conc.SelectWaiter()
    snap = w.snapshot()
    w.notify()
    assert w.wait(snap, timeout=0.0) is True
    assert w.wait(w.snapshot(), timeout=0.01) is False


def test_unbuffered_send_timeout_delivery_race():
    """When an unbuffered send times out in the same wakeup window as a
    receiver takes the cell, the send reports True (delivered)."""
    ch = conc.Channel(capacity=0)
    results = []
    t_end = time.monotonic() + 5.0

    def sender():
        for _ in range(200):
            try:
                results.append(ch.send("x", timeout=0.0005))
            except conc.ChannelClosed:
                results.append("closed")
                return

    def receiver():
        got = 0
        while got < 60 and time.monotonic() < t_end:
            try:
                v, ok = ch.recv(timeout=0.0005)
                if ok:
                    got += 1
            except TimeoutError:
                continue
        results.append(("received", got))

    ts = threading.Thread(target=sender, daemon=True)
    tr = threading.Thread(target=receiver, daemon=True)
    ts.start()
    tr.start()
    ts.join(10)
    tr.join(10)
    assert not ts.is_alive() and not tr.is_alive()
    delivered = sum(1 for r in results if r is True)
    received = next(r[1] for r in results if isinstance(r, tuple))
    assert delivered >= received, (delivered, received)


def test_tensor_payloads_are_not_compared_by_value():
    """Two equal tensors sent unbuffered are two cells (identity, not
    ==, which a tensor refuses)."""
    ch = conc.Channel(capacity=0)
    t = torch.ones(3)
    g = conc.Go(lambda: [ch.send(t), ch.send(t.clone()), ch.close()])
    got = _bounded(lambda: list(ch), 10.0)
    g.join(5)
    assert len(got) == 2 and got[0] is t
