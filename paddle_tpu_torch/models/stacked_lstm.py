"""Stacked dynamic LSTM sentiment model (counterpart of
``paddle_tpu/models/stacked_lstm.py``, after the reference's
benchmark/fluid/stacked_dynamic_lstm.py): a DynamicRNN LSTM cell built
from fc/sums layers, deepened with ``dynamic_lstm`` layers."""
from __future__ import annotations

from .. import layers


def lstm_net(data, label, dict_dim, emb_dim=512, hid_dim=512,
             stacked_num=3, class_dim=2):
    """Returns (avg_cost, accuracy, prediction).  data: ragged token ids
    (lod_level=1, fed padded [batch, time] with ``<name>@SEQ_LEN``),
    label: [batch, 1] int64."""
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
    sentence = layers.fc(input=emb, size=hid_dim, num_flatten_dims=2,
                         act="tanh")

    rnn = layers.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(sentence)
        prev_hidden = rnn.memory(shape=[hid_dim], value=0.0)
        prev_cell = rnn.memory(shape=[hid_dim], value=0.0)

        def gate_common(ipt, hidden, size):
            gate0 = layers.fc(input=ipt, size=size, bias_attr=True)
            gate1 = layers.fc(input=hidden, size=size, bias_attr=False)
            return layers.sums(input=[gate0, gate1])

        forget_gate = layers.sigmoid(x=gate_common(word, prev_hidden, hid_dim))
        input_gate = layers.sigmoid(x=gate_common(word, prev_hidden, hid_dim))
        output_gate = layers.sigmoid(x=gate_common(word, prev_hidden, hid_dim))
        cell_gate = layers.tanh(x=gate_common(word, prev_hidden, hid_dim))

        cell = layers.sums(input=[
            layers.elementwise_mul(x=forget_gate, y=prev_cell),
            layers.elementwise_mul(x=input_gate, y=cell_gate)])
        hidden = layers.elementwise_mul(x=output_gate,
                                        y=layers.tanh(x=cell))
        rnn.update_memory(prev_hidden, hidden)
        rnn.update_memory(prev_cell, cell)
        rnn.output(hidden)

    seq = rnn()
    # deepen with fused dynamic_lstm layers (stacked_num recurrences in all)
    for _ in range(stacked_num - 1):
        proj = layers.fc(input=seq, size=hid_dim * 4, num_flatten_dims=2,
                         bias_attr=False)
        seq, _ = layers.dynamic_lstm(input=proj, size=hid_dim * 4,
                                     use_peepholes=False)

    last = layers.sequence_pool(seq, "last")
    logit = layers.fc(input=last, size=class_dim, act="softmax")
    loss = layers.mean(layers.cross_entropy(input=logit, label=label))
    acc = layers.accuracy(input=logit, label=label)
    return loss, acc, logit
