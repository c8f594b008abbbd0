"""The two packages' legacy training surfaces side by side, for the twin
tests of the port's v1/v2 API (tests/test_torch_v2_api.py,
tests/test_torch_v1_layers.py).

A twin builds one config through each package (``build(pk)`` with ``pk``
either `JAX` or `PORT`), checks that both front ends emit the same
Program JSON, carries the JAX package's initial state into the port (the
scope's persistables, or a `v2.parameters` tar the JAX package wrote),
runs both on the same feeds and holds the port's results to the JAX
package's at the whole-model tolerance.
"""
import io
from types import SimpleNamespace

import numpy as np
import torch

import paddle_tpu as jfluid
import paddle_tpu.v2 as jv2
from paddle_tpu import layers as jlayers
from paddle_tpu.trainer_config_helpers import activations as jA
from paddle_tpu.trainer_config_helpers import evaluators as jE
from paddle_tpu.trainer_config_helpers import layers as jL
from paddle_tpu.trainer_config_helpers import networks as jN

import paddle_tpu_torch as pfluid
import paddle_tpu_torch.v2 as pv2
from paddle_tpu_torch import layers as players
from paddle_tpu_torch.trainer_config_helpers import activations as pA
from paddle_tpu_torch.trainer_config_helpers import evaluators as pE
from paddle_tpu_torch.trainer_config_helpers import layers as pL
from paddle_tpu_torch.trainer_config_helpers import networks as pN

JAX = SimpleNamespace(name="jax", fluid=jfluid, v2=jv2, layers=jlayers,
                      L=jL, N=jN, E=jE, A=jA, place=jfluid.CPUPlace())
PORT = SimpleNamespace(name="port", fluid=pfluid, v2=pv2, layers=players,
                       L=pL, N=pN, E=pE, A=pA, place=pfluid.CPUPlace())

#: whole models (ROADMAP): max abs error within TOL of max(1, max |value|)
TOL = 1e-4


def fresh():
    """Fresh default programs, names and global scope in both packages."""
    for pk in (JAX, PORT):
        pk.fluid.core.program.reset_default_programs()
        pk.fluid.core.scope._global_scope = pk.fluid.core.scope.Scope()


def assert_close(got, want, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max(initial=0.0))
    limit = tol * max(1.0, float(np.abs(want).max(initial=0.0)))
    assert err <= limit, f"{what}: max abs error {err} > {limit}"


def same_program():
    """Both default main programs serialise to the same JSON."""
    assert (pfluid.default_main_program().to_dict()
            == jfluid.default_main_program().to_dict())


def jax_state():
    """The JAX global scope's persistables of its default main program."""
    scope = jfluid.global_scope()
    out = {}
    for v in jfluid.default_main_program().list_vars():
        val = scope.get(v.name) if v.persistable else None
        if val is not None:
            out[v.name] = np.array(val)
    return out


def load_into_port(state):
    scope = pfluid.global_scope()
    for name, arr in state.items():
        scope.set(name, torch.from_numpy(np.array(arr)))


def run_graph(build, feeds, same_json=True):
    """``build(pk)`` -> LayerOutputs, parsed and run once on ``feeds`` in
    both packages, the port from the JAX startup's state -> (JAX fetches,
    port fetches), as numpy."""
    fresh()
    outs = []
    for pk in (JAX, PORT):
        fetch = pk.L.parse_network(*build(pk))
        exe = pk.fluid.Executor(pk.place)
        exe.run(pk.fluid.default_startup_program())
        if pk is JAX:
            state = jax_state()
        else:
            load_into_port(state)
        outs.append([np.asarray(o) for o in
                     exe.run(feed=feeds, fetch_list=fetch)])
    if same_json:
        same_program()
    return outs


def assert_twins(outs, tol=TOL):
    for i, (j, p) in enumerate(zip(*outs)):
        assert_close(p, j, tol, what=f"fetch {i}")


def event_log(pk, costs, events=None):
    """An event handler appending each EndIteration's cost to ``costs``
    (and every event's class name to ``events``)."""
    def handler(ev):
        if events is not None:
            events.append(type(ev).__name__)
        if isinstance(ev, pk.v2.event.EndIteration):
            costs.append(ev.cost)
    return handler


def v2_twins(build, make_reader, make_opt, batch_size, passes):
    """One v2 topology trained through ``paddle.trainer.SGD`` in each
    package: ``build(pk)`` -> (cost, extra outputs...); the JAX package's
    ``parameters.create`` draws the initial values, the port reads them
    from the JAX tar.  The port's own ``create`` must give the same
    names and shapes.  -> a namespace with both trainers, parameters,
    per-iteration costs, event names and topologies."""
    fresh()
    jbuilt, pbuilt = build(JAX), build(PORT)
    jparams = jv2.parameters.create(jbuilt[0])
    names = sorted(jparams.names())
    own = pv2.parameters.create(pbuilt[0])
    assert sorted(own.names()) == names
    for n in names:
        assert own.get(n).shape == jparams.get(n).shape, n
        assert own.get(n).dtype == jparams.get(n).dtype, n
    buf = io.BytesIO()
    jparams.to_tar(buf)
    pparams = pv2.parameters.Parameters.from_tar(io.BytesIO(buf.getvalue()))
    res = SimpleNamespace(names=names, jparams=jparams, pparams=pparams,
                          jbuilt=jbuilt, pbuilt=pbuilt)
    for pk, built, params in ((JAX, jbuilt, jparams),
                              (PORT, pbuilt, pparams)):
        kw = {"place": pk.place} if pk is PORT else {}
        trainer = pk.v2.trainer.SGD(cost=built[0], parameters=params,
                                    update_equation=make_opt(pk), **kw)
        costs, events = [], []
        trainer.train(pk.v2.batch(make_reader(), batch_size),
                      num_passes=passes,
                      event_handler=event_log(pk, costs, events))
        setattr(res, pk.name, SimpleNamespace(trainer=trainer, costs=costs,
                                              events=events))
    return res


def assert_v2_twins(res, tol=TOL):
    """Every iteration's cost and every final parameter within ``tol``."""
    assert len(res.port.costs) == len(res.jax.costs)
    assert_close(res.port.costs, res.jax.costs, tol, "costs")
    for n in res.names:
        assert_close(res.pparams.get(n), res.jparams.get(n), tol, n)
