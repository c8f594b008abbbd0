"""The seq2seq attention NMT model (models/seq2seq.py) in the port against
the JAX package, on the CPU, and the interpreter's dead-op skip on it.

Twins of tests/test_machine_translation.py at its small sizes (embedding,
encoder and decoder 64, vocabulary 100, each package's own
``dataset.wmt14``): both packages build the same program, the port loads
the JAX startup's state, and both take the same Adam steps on the same
batches (each package's `DataFeeder`): losses agree step for step within
1e-4 relative and fall.  The masked token mean equals the loss of the
physically trimmed batch.  The generation twin (test_beam_search.py's
``test_seq2seq_generation_runs``) gives the JAX package's ids exactly and
its scores within 1e-5.
"""
import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import io as jio
from paddle_tpu.models import seq2seq as JS
import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch.core.lowering import Interpreter
from paddle_tpu_torch.core.registry import OpRegistry
from paddle_tpu_torch.models import seq2seq as PS

SMALL = dict(embedding_dim=64, encoder_size=64, decoder_size=64,
             source_dict_dim=100, target_dict_dim=100)
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _fresh():
    jfluid.core.program.reset_default_programs()
    fluid.core.program.reset_default_programs()
    jfluid.global_scope().clear()
    fluid.core.scope._global_scope = fluid.core.scope.Scope()
    yield


def _train_both(tmp_path, lr=0.01, **cfg):
    """The training program + Adam in both packages (equal JSON), the JAX
    startup's state in the port -> [(pkg, exe, main, avg_cost, prediction,
    feeder)] for JAX then the port."""
    runs = []
    for pkg, model in ((jfluid, JS), (fluid, PS)):
        pkg.core.program.reset_default_programs()
        avg_cost, prediction, order = model.seq_to_seq_net(**cfg)
        pkg.optimizer.Adam(learning_rate=lr).minimize(avg_cost)
        main = pkg.default_main_program()
        feeder = pkg.DataFeeder(feed_list=[main.global_block().var(n)
                                           for n in order])
        runs.append([pkg, None, main, avg_cost, prediction, feeder])
    assert runs[0][2].to_dict() == runs[1][2].to_dict()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jio.save_persistables(jexe, str(tmp_path), runs[0][2])
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path), runs[1][2])
    runs[0][1], runs[1][1] = jexe, exe
    return runs


def _batches(pkg, n, size=64, dict_size=100):
    samples = list(pkg.dataset.wmt14.train(dict_size)())
    return [samples[i * size:(i + 1) * size] for i in range(n)]


def test_seq2seq_attention_trains(tmp_path):
    """test_seq2seq_attention_trains's model, data and optimizer: 8 Adam
    steps at batch 64, the port's loss the JAX package's at every step."""
    runs = _train_both(tmp_path, **SMALL)
    batches = _batches(fluid, 8)
    assert batches == _batches(jfluid, 8)
    losses = ([], [])
    for batch in batches:
        for k, (pkg, exe, main, avg, _, feeder) in enumerate(runs):
            (loss,) = exe.run(main, feed=feeder.feed(batch), fetch_list=[avg])
            losses[k].append(float(np.asarray(loss).reshape(-1)[0]))
    jl, pl = np.asarray(losses[0]), np.asarray(losses[1])
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert np.isfinite(pl).all() and pl[-1] < pl[0]


def test_seq2seq_masked_loss_matches_trimmed_sequences():
    """With ragged @SEQ_LEN the masked token mean equals the loss of the
    batch physically trimmed to its lengths (the same parameters)."""
    def loss_of(feed):
        fluid.core.program.reset_default_programs()
        fluid.core.scope._global_scope = fluid.core.scope.Scope()
        avg_cost, _, _ = PS.seq_to_seq_net(
            embedding_dim=16, encoder_size=16, decoder_size=16,
            source_dict_dim=40, target_dict_dim=40)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        (val,) = exe.run(feed=feed, fetch_list=[avg_cost])
        return float(np.asarray(val))

    rng = np.random.RandomState(5)
    b, t, n = 4, 10, 6
    data = rng.randint(1, 40, (b, t)).astype(np.int64)
    data[:, n:] = 0
    lens = np.full((b,), n, np.int32)

    def feed_with(t_phys):
        feed = {}
        for name in ("source_sequence", "target_sequence", "label_sequence"):
            feed[name] = data[:, :t_phys]
            feed[name + "@SEQ_LEN"] = lens
        return feed
    padded, trimmed = loss_of(feed_with(t)), loss_of(feed_with(n))
    assert np.isclose(padded, trimmed, rtol=1e-5), (padded, trimmed)


def test_seq2seq_generation_matches_jax(tmp_path):
    """seq_to_seq_generate at test_beam_search.py's size: the port's ids
    are the JAX package's, its scores within 1e-5."""
    fetches = []
    for pkg, model in ((jfluid, JS), (fluid, PS)):
        pkg.core.program.reset_default_programs()
        fetches.append(model.seq_to_seq_generate(
            embedding_dim=16, encoder_size=16, decoder_size=16,
            source_dict_dim=50, target_dict_dim=50, beam_size=3,
            max_length=7))
    assert (jfluid.default_main_program().to_dict()
            == fluid.default_main_program().to_dict())
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jfluid.default_startup_program())
    jio.save_persistables(jexe, str(tmp_path), jfluid.default_main_program())
    exe = fluid.Executor(fluid.CPUPlace())
    pio.load_persistables(exe, str(tmp_path), fluid.default_main_program())
    feed = {"source_sequence": np.random.RandomState(0).randint(
                3, 50, size=(2, 6)).astype(np.int64),
            "source_sequence@SEQ_LEN": np.array([6, 4], np.int32)}
    jids, jscores = jexe.run(jfluid.default_main_program(), feed=feed,
                             fetch_list=list(fetches[0]))
    ids, scores = exe.run(fluid.default_main_program(), feed=feed,
                          fetch_list=list(fetches[1]))
    assert ids.shape == (2 * 3, 7) and ids.min() >= 0 and ids.max() < 50
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(scores, jscores, rtol=1e-5)


def test_generator_loads_the_training_parameters_by_name(tmp_path):
    """The generator's parameters are the training program's by name and
    shape, but its vocabulary projection: the JAX model builds that fc
    with an automatic name (fc_9), not the training head's s2s_vocab_w /
    s2s_vocab_b (ROADMAP queue C), and the port keeps the JAX program."""
    PS.seq_to_seq_net(**SMALL)
    train = {p.name: p.shape for p in
             fluid.default_main_program().all_parameters()}
    fluid.core.program.reset_default_programs()
    PS.seq_to_seq_generate(beam_size=2, max_length=3, **SMALL)
    gen = {p.name: p.shape for p in
           fluid.default_main_program().all_parameters()}
    unmatched = sorted(n for n, s in gen.items() if train.get(n) != s)
    assert unmatched == ["fc_9.b_0", "fc_9.w_0"], unmatched
    assert gen["fc_9.w_0"] == train["s2s_vocab_w_0"]
    assert len(gen) == 27


# ---------------------------------------------------------------------------
# the interpreter's dead-op skip
# ---------------------------------------------------------------------------

def _prediction_ops(main, prediction):
    """Indices of the 3-D prediction head's ops: the op that writes
    ``prediction`` and every earlier op whose outputs only the head
    reads."""
    ops = main.global_block().ops
    readers = {}
    for i, op in enumerate(ops):
        for n in op.desc.input_names():
            readers.setdefault(n, set()).add(i)
    head = {i for i, op in enumerate(ops)
            if prediction.name in op.desc.output_names()}
    for i in range(len(ops) - 1, -1, -1):
        outs = ops[i].desc.output_names()
        read = set().union(*(readers.get(n, set()) for n in outs))
        if read and read <= head:
            head.add(i)
    return sorted(head)


def test_unfetched_prediction_head_runs_no_op(tmp_path, monkeypatch):
    """Training fetches only the loss: the interpreter marks the
    prediction head's three ops (mul, elementwise_add, softmax) dead and
    runs no softmax; the losses of 3 Adam steps are bitwise those of the
    same steps with every op run."""
    cfg = dict(embedding_dim=16, encoder_size=16, decoder_size=16,
               source_dict_dim=40, target_dict_dim=40)
    runs = _train_both(tmp_path, **cfg)
    _, exe, main, avg, prediction, feeder = runs[1]
    head = _prediction_ops(main, prediction)
    assert [main.global_block().ops[i].type for i in head] == [
        "mul", "elementwise_add", "softmax"]
    interp = Interpreter(main, exe.device, None, [avg.name])
    live = interp.live_ops(main.global_block())
    assert [i for i, keep in enumerate(live) if not keep] == head

    calls = []
    softmax = OpRegistry.get("softmax").fn

    def counted(ctx):
        calls.append(ctx.op.type)
        return softmax(ctx)
    monkeypatch.setattr(OpRegistry.get("softmax"), "fn", counted)
    state = {n: exe_val.clone() for n, exe_val in
             fluid.global_scope()._vars.items()}
    batches = [feeder.feed(b) for b in _batches(fluid, 3, size=8,
                                                dict_size=40)]

    def steps(skip):
        fluid.core.scope._global_scope = fluid.core.scope.Scope()
        for n, v in state.items():
            fluid.global_scope().set(n, v.clone())
        monkeypatch.setattr(Interpreter, "skip_dead_ops", skip)
        e = fluid.Executor(fluid.CPUPlace())
        return [float(np.asarray(e.run(main, feed=f, fetch_list=[avg])[0]))
                for f in batches]
    skipped = steps(True)
    assert calls == []
    every = steps(False)
    assert calls == ["softmax"] * 3
    assert skipped == every
