"""Seq2seq with attention (counterpart of ``paddle_tpu/models/seq2seq.py``;
benchmark/fluid/machine_translation.py: a bidirectional LSTM encoder and
a Bahdanau-attention DynamicRNN decoder).

The layer order and the explicit parameter names (``s2s_att_wd``,
``s2s_att_ws``, ``s2s_vocab_w``, ``s2s_vocab_b``, and ``embedding_1.w_0``
in the generator) are the JAX model's, so both packages build the same
program and the training program's parameters load into the generator
by name.  The loss is a length-masked token mean (the padded batch's
stand-in for LoD flattening).
"""
from __future__ import annotations

from .. import layers, unique_name
from ..param_attr import ParamAttr


def lstm_step(x_t, hidden_t_prev, cell_t_prev, size):
    """machine_translation.py:96 lstm_step: gates from fc sums."""
    def linear(inputs):
        return layers.fc(input=inputs, size=size, bias_attr=True)

    forget_gate = layers.sigmoid(x=linear([hidden_t_prev, x_t]))
    input_gate = layers.sigmoid(x=linear([hidden_t_prev, x_t]))
    output_gate = layers.sigmoid(x=linear([hidden_t_prev, x_t]))
    cell_tilde = layers.tanh(x=linear([hidden_t_prev, x_t]))

    cell_t = layers.sums(input=[
        layers.elementwise_mul(x=forget_gate, y=cell_t_prev),
        layers.elementwise_mul(x=input_gate, y=cell_tilde)])
    hidden_t = layers.elementwise_mul(x=output_gate,
                                      y=layers.tanh(x=cell_t))
    return hidden_t, cell_t


def bi_lstm_encoder(input_seq, gate_size):
    """machine_translation.py:121 bidirectional dynamic LSTM encoder."""
    input_forward_proj = layers.fc(input=input_seq, size=gate_size * 4,
                                   num_flatten_dims=2, act=None,
                                   bias_attr=False)
    forward, _ = layers.dynamic_lstm(input=input_forward_proj,
                                     size=gate_size * 4,
                                     use_peepholes=False)
    input_reversed_proj = layers.fc(input=input_seq, size=gate_size * 4,
                                    num_flatten_dims=2, act=None,
                                    bias_attr=False)
    reversed_lstm, _ = layers.dynamic_lstm(input=input_reversed_proj,
                                           size=gate_size * 4,
                                           is_reverse=True,
                                           use_peepholes=False)
    return forward, reversed_lstm


def simple_attention(encoder_vec, encoder_proj, decoder_state, decoder_size):
    """machine_translation.py:171 Bahdanau additive attention.

    The reference's one fc over [encoder_proj, state] is split into an fc
    of encoder_proj plus state @ (W_d @ w_s): the same affine map (no
    bias on either), written so that the encoder term and W_d @ w_s
    depend on nothing the loop changes (the JAX package's XLA hoists
    them; the port's eager step recomputes them each step)."""
    H = decoder_size
    w_d = layers.create_parameter(shape=[H, H], dtype="float32",
                                  name=unique_name.generate("s2s_att_wd"))
    w_s = layers.create_parameter(shape=[H, 1], dtype="float32",
                                  name=unique_name.generate("s2s_att_ws"))
    enc_term = layers.fc(input=encoder_proj, size=1, num_flatten_dims=2,
                         bias_attr=False)                 # [B, T, 1]
    u = layers.matmul(w_d, w_s)                           # [H, 1] hoisted
    state_term = layers.matmul(decoder_state, u)          # [B, 1]
    state_expand = layers.sequence_expand(x=state_term, y=encoder_proj)
    attention_weights = layers.tanh(
        layers.elementwise_add(enc_term, state_expand))
    attention_weights = layers.sequence_softmax(input=attention_weights)
    scaled = layers.elementwise_mul(x=encoder_vec, y=attention_weights,
                                    axis=0)
    context = layers.sequence_pool(input=scaled, pool_type="sum")
    return context


def seq_to_seq_net(embedding_dim, encoder_size, decoder_size,
                   source_dict_dim, target_dict_dim, is_generating=False,
                   beam_size=3, max_length=50):
    """machine_translation.py:143 training network; returns
    (avg_cost, prediction, feed_order)."""
    src_word_idx = layers.data(name="source_sequence", shape=[1],
                               dtype="int64", lod_level=1)
    src_embedding = layers.embedding(
        input=src_word_idx, size=[source_dict_dim, embedding_dim],
        dtype="float32")

    src_forward, src_reversed = bi_lstm_encoder(
        input_seq=src_embedding, gate_size=encoder_size)

    encoded_vector = layers.concat(input=[src_forward, src_reversed], axis=2)
    encoded_proj = layers.fc(input=encoded_vector, size=decoder_size,
                             num_flatten_dims=2, bias_attr=False)

    backward_first = layers.sequence_pool(input=src_reversed,
                                          pool_type="first")
    decoder_boot = layers.fc(input=backward_first, size=decoder_size,
                             bias_attr=False, act="tanh")

    trg_word_idx = layers.data(name="target_sequence", shape=[1],
                               dtype="int64", lod_level=1)
    trg_embedding = layers.embedding(
        input=trg_word_idx, size=[target_dict_dim, embedding_dim],
        dtype="float32")

    rnn = layers.DynamicRNN()
    cell_init = layers.fill_constant_batch_size_like(
        input=decoder_boot, value=0.0, shape=[-1, decoder_size],
        dtype="float32")
    cell_init.stop_gradient = False

    with rnn.block():
        current_word = rnn.step_input(trg_embedding)
        encoder_vec = rnn.static_input(encoded_vector)
        encoder_proj_s = rnn.static_input(encoded_proj)
        hidden_mem = rnn.memory(init=decoder_boot, need_reorder=True)
        cell_mem = rnn.memory(init=cell_init)
        context = simple_attention(encoder_vec, encoder_proj_s, hidden_mem,
                                   decoder_size)
        decoder_inputs = layers.concat(input=[context, current_word], axis=1)
        h, c = lstm_step(decoder_inputs, hidden_mem, cell_mem, decoder_size)
        rnn.update_memory(hidden_mem, h)
        rnn.update_memory(cell_mem, c)
        rnn.output(h)

    hidden_seq = rnn()                       # [B, T, H] padded

    # The vocabulary projection does not recur, so it runs once after
    # the decoder over the flat [B*T, H] hidden states, and the loss is
    # the fused softmax cross-entropy over those flat logits (the
    # [B*T, V] probabilities never exist).  The 3-D `prediction` head
    # shares its parameters and runs only when fetched: the
    # interpreter skips it otherwise (core/lowering.py).
    head_w = unique_name.generate("s2s_vocab_w")
    head_b = unique_name.generate("s2s_vocab_b")
    hidden_flat = layers.reshape(hidden_seq, shape=[-1, decoder_size])
    logits_flat = layers.fc(input=hidden_flat, size=target_dict_dim,
                            param_attr=ParamAttr(name=head_w),
                            bias_attr=ParamAttr(name=head_b))
    prediction = layers.softmax(
        layers.fc(input=hidden_seq, size=target_dict_dim,
                  num_flatten_dims=2, param_attr=ParamAttr(name=head_w),
                  bias_attr=ParamAttr(name=head_b)))

    label = layers.data(name="label_sequence", shape=[1], dtype="int64",
                        lod_level=1)
    cost_flat = layers.softmax_with_cross_entropy(
        logits=logits_flat,
        label=layers.reshape(label, shape=[-1, 1]))      # [B*T, 1]
    # masked token mean: sum over valid tokens / token count
    mask_flat = layers.reshape(
        layers.cast(layers.sequence_mask_like(label), "float32"),
        shape=[-1, 1])
    total = layers.reduce_sum(layers.elementwise_mul(cost_flat, mask_flat))
    token_count = layers.reduce_sum(mask_flat)
    avg_cost = layers.elementwise_div(total, token_count)

    feed_order = ["source_sequence", "target_sequence", "label_sequence"]
    return avg_cost, prediction, feed_order


def seq_to_seq_generate(embedding_dim, encoder_size, decoder_size,
                        source_dict_dim, target_dict_dim, beam_size=3,
                        max_length=20, start_id=0, end_id=1):
    """Generation network (machine_translation.py's is_generating path):
    the same encoder, and a beam-search decoder over a StaticRNN with
    flattened [batch*beam] state (the beam_search and beam_search_decode
    ops).

    Build it in a fresh program with the same layer order as the
    training net so that the parameter names line up; returns
    (sentence_ids, sentence_scores).
    """
    src_word_idx = layers.data(name="source_sequence", shape=[1],
                               dtype="int64", lod_level=1)
    src_embedding = layers.embedding(
        input=src_word_idx, size=[source_dict_dim, embedding_dim],
        dtype="float32")
    src_forward, src_reversed = bi_lstm_encoder(
        input_seq=src_embedding, gate_size=encoder_size)
    encoded_vector = layers.concat(input=[src_forward, src_reversed], axis=2)
    encoded_proj = layers.fc(input=encoded_vector, size=decoder_size,
                             num_flatten_dims=2, bias_attr=False)
    backward_first = layers.sequence_pool(input=src_reversed,
                                          pool_type="first")
    decoder_boot = layers.fc(input=backward_first, size=decoder_size,
                             bias_attr=False, act="tanh")

    # dummy target-embedding creation to keep parameter order aligned with
    # the training graph (embedding_1 is the target table there)
    trg_table = layers.embedding(
        input=src_word_idx, size=[target_dict_dim, embedding_dim],
        dtype="float32", param_attr=None)

    # beam expansion
    enc_vec = layers.repeat_batch(encoded_vector, beam_size)
    enc_proj = layers.repeat_batch(encoded_proj, beam_size)
    boot = layers.repeat_batch(decoder_boot, beam_size)
    cell_init = layers.fill_constant_batch_size_like(
        input=boot, value=0.0, shape=[-1, decoder_size], dtype="float32")
    tok_init = layers.fill_constant_batch_size_like(
        input=boot, value=float(start_id), shape=[-1, 1], dtype="int64")
    fin_init = layers.fill_constant_batch_size_like(
        input=boot, value=0.0, shape=[-1, 1], dtype="float32")

    score_init = layers.beam_init_scores(boot, beam_size)

    steps = layers.fill_constant_batch_size_like(
        input=boot, value=0.0, shape=[-1, max_length], dtype="float32")

    rnn = layers.StaticRNN()
    with rnn.block():
        _t = rnn.step_input(steps)                      # drives max_length
        tok = rnn.memory(init=tok_init)
        score = rnn.memory(init=score_init)
        fin = rnn.memory(init=fin_init)
        hidden = rnn.memory(init=boot)
        cell = rnn.memory(init=cell_init)
        enc_vec_s = rnn.static_input(enc_vec)
        enc_proj_s = rnn.static_input(enc_proj)

        emb = layers.embedding(input=tok,
                               size=[target_dict_dim, embedding_dim],
                               param_attr="embedding_1.w_0")
        context = simple_attention(enc_vec_s, enc_proj_s, hidden,
                                   decoder_size)
        decoder_inputs = layers.concat(input=[context, emb], axis=1)
        h, c = lstm_step(decoder_inputs, hidden, cell, decoder_size)
        out = layers.fc(input=h, size=target_dict_dim, bias_attr=True,
                        act="softmax")
        ids, scores, parents, finished = layers.beam_search(
            score, out, fin, beam_size, end_id=end_id)
        h2 = layers.gather(h, parents)
        c2 = layers.gather(c, parents)
        rnn.update_memory(tok, ids)
        rnn.update_memory(score, scores)
        rnn.update_memory(fin, finished)
        rnn.update_memory(hidden, h2)
        rnn.update_memory(cell, c2)
        parents_f = layers.cast(parents, "int32")
        rnn.output(ids, parents_f, scores)

    ids_seq, parents_seq, scores_seq = rnn()
    final_scores = layers.sequence_pool(scores_seq, "last")
    sent_ids, sent_scores = layers.beam_search_decode(
        ids_seq, parents_seq, final_scores, beam_size, end_id)
    return sent_ids, sent_scores
