"""The port's ``merge_model``, ``dump_config``, ``make_diagram`` and
``version`` verbs and its ``debuger`` (twins of the five tests of
tests/test_cli.py on those verbs).

``version`` runs as ``python -m paddle_tpu_torch``; the other verbs,
and the JAX verbs the port's are held to, run in this process
(``main(argv)`` of each package's ``__main__``: a process start imports
torch, about 3.5 s), on the same script with its import changed:
``dump_config`` prints the same JSON and ``make_diagram`` the same dot.
A model the JAX package exported and the port merged loads and predicts
in the JAX package.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu as jfluid
import paddle_tpu.__main__ as jmain
from paddle_tpu import debuger as jdebuger

import paddle_tpu_torch as pfluid
import paddle_tpu_torch.__main__ as pmain
from paddle_tpu_torch import debuger as pdebuger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = ("import {pkg} as fluid\n"
       "from {pkg} import layers\n"
       "x = layers.data(name='x', shape=[4], dtype='float32')\n"
       "h = layers.fc(input=x, size=3, act='relu')\n"
       "y = layers.fc(input=h, size=2, act='softmax')\n")


@pytest.fixture(autouse=True)
def _fresh():
    for fl in (jfluid, pfluid):
        fl.core.program.reset_default_programs()
        fl.core.scope._global_scope = fl.core.scope.Scope()
    yield


def _scripts(tmp_path, body=CFG, tail=""):
    """The same config written for each package -> (port script, JAX
    script)."""
    out = []
    for pkg in ("paddle_tpu_torch", "paddle_tpu"):
        p = tmp_path / f"cfg_{pkg}.py"
        p.write_text(body.format(pkg=pkg) + tail)
        out.append(str(p))
    return out


def _verb(main, capsys, monkeypatch, *argv):
    """A package's verb in this process -> its stdout."""
    monkeypatch.setattr(sys, "argv", list(sys.argv))
    capsys.readouterr()
    assert main(list(argv)) == 0
    return capsys.readouterr().out


def test_version():
    """In its own process: the verb table dispatches, and nothing of JAX
    is imported or printed."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['paddle_tpu_torch', 'version']; "
         "code = 0\n"
         "try:\n    runpy.run_module('paddle_tpu_torch', "
         "run_name='__main__')\n"
         "except SystemExit as e:\n    code = e.code\n"
         "bad = [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'paddle_tpu')]\n"
         "print('imported', bad); sys.exit(code)"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"paddle_tpu_torch {pfluid.__version__}\n")
    assert "torch " in r.stdout and "CUDA" in r.stdout
    assert "devices " in r.stdout
    assert "jax" not in r.stdout.lower().replace("imported", "")
    assert r.stdout.rstrip().endswith("imported []")


def test_train_and_dump_config(tmp_path, capsys, monkeypatch):
    port_script, jax_script = _scripts(tmp_path)
    cfg = json.loads(_verb(pmain.main, capsys, monkeypatch, "dump_config",
                           port_script))
    op_types = [op["type"] for op in cfg["blocks"][0]["ops"]]
    assert "mul" in op_types and "elementwise_add" in op_types, op_types
    assert cfg == json.loads(_verb(jmain.main, capsys, monkeypatch,
                                   "dump_config", jax_script))
    _verb(pmain.main, capsys, monkeypatch, "train", port_script)


V1_CFG = ("from {pkg}.trainer_config_helpers import *\n"
          "from {pkg}.v2 import data_type\n"
          "img = data_layer(name='pixel', size=16)\n"
          "h = fc_layer(input=img, size=8, act=ReluActivation())\n"
          "pred = fc_layer(input=h, size=4, act=SoftmaxActivation())\n"
          "lbl = data_layer(name='label', size=1,\n"
          "                 type=data_type.integer_value(4))\n"
          "parse_network(classification_cost(input=pred, label=lbl))\n")


def test_dump_config_of_a_v1_script(tmp_path, capsys, monkeypatch):
    """A v1 trainer_config_helpers config: the port's dump_config prints
    the JSON the JAX verb prints."""
    port_script, jax_script = _scripts(tmp_path, body=V1_CFG)
    cfg = json.loads(_verb(pmain.main, capsys, monkeypatch, "dump_config",
                           port_script))
    op_types = [op["type"] for op in cfg["blocks"][0]["ops"]]
    assert "cross_entropy" in op_types and "softmax" in op_types, op_types
    assert cfg == json.loads(_verb(jmain.main, capsys, monkeypatch,
                                   "dump_config", jax_script))


def test_dump_config_does_not_fire_main_guard(tmp_path, capsys,
                                              monkeypatch):
    port_script, _ = _scripts(tmp_path, tail=(
        "if __name__ == '__main__':\n"
        "    raise SystemExit('training ran during dump_config!')\n"))
    out = _verb(pmain.main, capsys, monkeypatch, "dump_config", port_script)
    assert json.loads(out)["blocks"][0]["ops"]
    # train does run the script as __main__
    with pytest.raises(SystemExit, match="training ran"):
        pmain.main(["train", port_script])


def test_make_diagram(tmp_path, capsys, monkeypatch):
    port_script, jax_script = _scripts(tmp_path)
    out, jout = tmp_path / "g.dot", tmp_path / "g_jax.dot"
    _verb(pmain.main, capsys, monkeypatch, "make_diagram", port_script,
          str(out))
    assert out.read_text().startswith("digraph")
    _verb(jmain.main, capsys, monkeypatch, "make_diagram", jax_script,
          str(jout))
    assert out.read_text() == jout.read_text()


def test_merge_model_roundtrip(tmp_path, capsys, monkeypatch):
    build = tmp_path / "export.py"
    build.write_text(
        "import sys, numpy as np\n"
        "import paddle_tpu_torch as fluid\n"
        "from paddle_tpu_torch import layers\n"
        "x = layers.data(name='x', shape=[4], dtype='float32')\n"
        "y = layers.fc(input=x, size=2, act='softmax')\n"
        "exe = fluid.Executor(fluid.CPUPlace())\n"
        "exe.run(fluid.default_startup_program())\n"
        "fluid.io.save_inference_model(sys.argv[1], ['x'], [y], exe)\n")
    model_dir, merged_dir = tmp_path / "m", tmp_path / "merged"
    _verb(pmain.main, capsys, monkeypatch, "train", str(build),
          str(model_dir))
    _verb(pmain.main, capsys, monkeypatch, "merge_model", str(model_dir),
          str(merged_dir))
    assert "__params__.npz" in os.listdir(merged_dir)
    # the merged model reloads and predicts what the original does
    outs = []
    for d, fname in ((model_dir, None), (merged_dir, "__params__.npz")):
        pfluid.core.scope._global_scope = pfluid.core.scope.Scope()
        exe = pfluid.Executor(pfluid.CPUPlace())
        prog, feeds, fetches = pfluid.io.load_inference_model(
            str(d), exe, params_filename=fname)
        outs.append(exe.run(prog, feed={feeds[0]: np.ones((2, 4),
                                                          np.float32)},
                            fetch_list=fetches)[0])
    assert outs[0].shape == (2, 2) and np.array_equal(outs[0], outs[1])
    # re-merging the merged dir without --params-filename fails loudly
    # (the verb reads into the global scope, as a fresh process has it)
    pfluid.core.scope._global_scope = pfluid.core.scope.Scope()
    with pytest.raises(SystemExit, match="params-filename"):
        pmain.main(["merge_model", str(merged_dir), str(tmp_path / "m2")])
    _verb(pmain.main, capsys, monkeypatch, "merge_model", str(merged_dir),
          str(tmp_path / "m2"), "--params-filename", "__params__.npz")
    assert "__params__.npz" in os.listdir(tmp_path / "m2")


def test_merge_model_of_a_jax_export_loads_in_jax(tmp_path, capsys,
                                                 monkeypatch):
    """A model the JAX package exported, merged by the port's verb, loads
    in the JAX package and predicts what the JAX original does."""
    layers = jfluid.layers
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.fc(input=layers.fc(input=x, size=3, act="relu"), size=2,
                  act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jfluid.default_startup_program())
    model_dir, merged_dir = tmp_path / "jm", tmp_path / "jmerged"
    jfluid.io.save_inference_model(str(model_dir), ["x"], [y], exe)
    _verb(pmain.main, capsys, monkeypatch, "merge_model", str(model_dir),
          str(merged_dir))
    feed = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    outs = []
    for d, fname in ((model_dir, None), (merged_dir, "__params__.npz")):
        jfluid.core.scope._global_scope = jfluid.core.scope.Scope()
        exe = jfluid.Executor(jfluid.CPUPlace())
        prog, feeds, fetches = jfluid.io.load_inference_model(
            str(d), exe, params_filename=fname)
        outs.append(np.asarray(exe.run(prog, feed={feeds[0]: feed},
                                       fetch_list=fetches)[0]))
    assert np.array_equal(outs[0], outs[1])


def test_debuger_text_and_dot_match_the_jax_package(tmp_path):
    """pprint_program_codes and draw_block_graphviz of the same training
    program, built by each front end, are the same text."""
    texts = []
    for fl, dbg in ((jfluid, jdebuger), (pfluid, pdebuger)):
        layers = fl.layers
        x = layers.data(name="x", shape=[4], dtype="float32")
        lbl = layers.data(name="l", shape=[1], dtype="int64")
        pred = layers.fc(input=x, size=3, act="softmax")
        loss = layers.mean(layers.cross_entropy(input=pred, label=lbl))
        fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
        prog = fl.default_main_program()
        dot = str(tmp_path / f"{fl.__name__}.dot")
        texts.append((dbg.pprint_program_codes(prog),
                      dbg.pprint_program_codes(prog, show_backward=True),
                      dbg.draw_block_graphviz(prog.global_block(),
                                              highlights=[loss.name],
                                              path=dot),
                      open(dot).read()))
    assert texts[1] == texts[0]
    assert "[backward] backward(...)" in texts[1][0]
    assert pdebuger.program_to_code is pdebuger.pprint_program_codes
