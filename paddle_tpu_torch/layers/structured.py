"""Structured-prediction and beam layers (counterpart of
``paddle_tpu/layers/structured.py``): linear_chain_crf, crf_decoding,
warpctc, edit_distance, chunk_eval, ctc_greedy_decoder, nce, and the beam
helpers beam_search, beam_search_decode, beam_init_scores and
repeat_batch."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from ..initializer import NormalInitializer


def linear_chain_crf(input, label, param_attr=None):
    """Returns the per-sequence NEGATIVE log likelihood [batch, 1] (minimise
    its mean), with the CRF transition matrix as a parameter
    (nn.py linear_chain_crf)."""
    helper = LayerHelper("linear_chain_crf", input=input,
                         param_attr=param_attr)
    num_tags = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, shape=[num_tags + 2, num_tags],
        dtype=input.dtype,
        default_initializer=NormalInitializer(0.0, 0.1))
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    e_exps = helper.create_variable_for_type_inference(input.dtype)
    t_exps = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="linear_chain_crf",
                     inputs={"Emission": [input], "Transition": [transition],
                             "Label": [label]},
                     outputs={"LogLikelihood": [ll], "Alpha": [alpha],
                              "EmissionExps": [e_exps],
                              "TransitionExps": [t_exps]})
    # negate: op returns ll; loss = -ll (reference emits -ll directly)
    neg = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="scale", inputs={"X": [ll]},
                     outputs={"Out": [neg]}, attrs={"scale": -1.0})
    neg.desc.shape = (input.shape[0], 1) if input.shape else None
    return neg


def crf_decoding(input, param_attr, label=None):
    helper = LayerHelper("crf_decoding", input=input, param_attr=param_attr)
    transition = helper.main_program.global_block().var(
        param_attr.name if hasattr(param_attr, "name") else param_attr)
    out = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [out]})
    out.desc.lod_level = input.lod_level
    return out


def edit_distance(input, label, normalized=False, ignored_tokens=None):
    helper = LayerHelper("edit_distance", input=input)
    if ignored_tokens:
        erased = helper.create_variable_for_type_inference(input.dtype)
        helper.append_op(type="sequence_erase", inputs={"X": [input]},
                         outputs={"Out": [erased]},
                         attrs={"tokens": list(ignored_tokens)})
        input = erased
        erased_l = helper.create_variable_for_type_inference(label.dtype)
        helper.append_op(type="sequence_erase", inputs={"X": [label]},
                         outputs={"Out": [erased_l]},
                         attrs={"tokens": list(ignored_tokens)})
        label = erased_l
    out = helper.create_variable_for_type_inference("float32")
    seq_num = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [input], "Refs": [label]},
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized})
    return out, seq_num


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    helper = LayerHelper("chunk_eval", input=input)
    precision = helper.create_variable_for_type_inference("float32")
    recall = helper.create_variable_for_type_inference("float32")
    f1 = helper.create_variable_for_type_inference("float32")
    num_infer = helper.create_variable_for_type_inference("int64")
    num_label = helper.create_variable_for_type_inference("int64")
    num_correct = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="chunk_eval",
                     inputs={"Inference": [input], "Label": [label]},
                     outputs={"Precision": [precision], "Recall": [recall],
                              "F1-Score": [f1],
                              "NumInferChunks": [num_infer],
                              "NumLabelChunks": [num_label],
                              "NumCorrectChunks": [num_correct]},
                     attrs={"num_chunk_types": num_chunk_types,
                            "chunk_scheme": chunk_scheme,
                            "excluded_chunk_types": excluded_chunk_types or []})
    return precision, recall, f1, num_infer, num_label, num_correct


def warpctc(input, label, blank=0, norm_by_times=False):
    helper = LayerHelper("warpctc", input=input)
    loss = helper.create_variable_for_type_inference(input.dtype)
    grad = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="warpctc",
                     inputs={"Logits": [input], "Label": [label]},
                     outputs={"Loss": [loss], "WarpCTCGrad": [grad]},
                     attrs={"blank": blank, "norm_by_times": norm_by_times})
    loss.desc.shape = (input.shape[0], 1) if input.shape else None
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """argmax over classes then ctc_align collapse (nn.py ctc_greedy_decoder)."""
    helper = LayerHelper("ctc_greedy_decoder", input=input, name=name)
    argmax = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_max", inputs={"X": [input]},
                     outputs={"Out": [argmax]}, attrs={"axis": -1})
    aligned = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="ctc_align", inputs={"Input": [argmax]},
                     outputs={"Output": [aligned]}, attrs={"blank": blank})
    aligned.desc.lod_level = 1
    return aligned


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None):
    """Noise-contrastive estimation loss (nce_op.cc): a sampled binary
    loss with uniform negative samples."""
    helper = LayerHelper("nce", input=input, param_attr=param_attr,
                         bias_attr=bias_attr)
    dim = input.shape[-1]
    w = helper.create_parameter(helper.param_attr,
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(helper.bias_attr,
                                shape=[num_total_classes, 1],
                                dtype=input.dtype, is_bias=True)
    cost = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="nce",
                     inputs={"Input": [input], "Label": [label],
                             "Weight": [w], "Bias": [b]},
                     outputs={"Cost": [cost]},
                     attrs={"num_total_classes": num_total_classes,
                            "num_neg_samples": num_neg_samples or 10})
    cost.desc.shape = (input.shape[0], 1) if input.shape else None
    return cost


def beam_search(pre_scores, probs, pre_finished, beam_size, end_id=1):
    """One beam-search pruning step over the flattened [batch*beam]
    layout (see ops/beam_ops.py)."""
    helper = LayerHelper("beam_search", input=probs)
    ids = helper.create_variable_for_type_inference("int64")
    scores = helper.create_variable_for_type_inference("float32")
    parents = helper.create_variable_for_type_inference("int32")
    finished = helper.create_variable_for_type_inference("float32")
    inputs = {"PreScores": [pre_scores], "Probs": [probs]}
    if pre_finished is not None:
        inputs["PreFinished"] = [pre_finished]
    helper.append_op(type="beam_search", inputs=inputs,
                     outputs={"SelectedIds": [ids],
                              "SelectedScores": [scores],
                              "ParentIdx": [parents],
                              "Finished": [finished]},
                     attrs={"beam_size": beam_size, "end_id": end_id})
    if probs.shape:
        ids.desc.shape = (probs.shape[0], 1)
        scores.desc.shape = (probs.shape[0], 1)
        parents.desc.shape = (probs.shape[0],)
        finished.desc.shape = (probs.shape[0], 1)
    return ids, scores, parents, finished


def beam_search_decode(ids, parents, scores, beam_size=None, end_id=1,
                       num_results=None):
    """Backtrace stacked beam steps.  ``num_results`` < beam_size keeps
    only each sample's best ``num_results`` sequences (v1
    num_results_per_sample)."""
    helper = LayerHelper("beam_search_decode", input=ids)
    sent_ids = helper.create_variable_for_type_inference("int64")
    sent_scores = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="beam_search_decode",
                     inputs={"Ids": [ids], "Parents": [parents],
                             "Scores": [scores]},
                     outputs={"SentenceIds": [sent_ids],
                              "SentenceScores": [sent_scores]},
                     attrs={"beam_size": beam_size or 0, "end_id": end_id,
                            "num_results": num_results or 0})
    if ids.shape:
        rows = ids.shape[0]
        if (beam_size and num_results and num_results < beam_size
                and rows and rows > 0):
            # the op trims each sample's beam block to its best
            # num_results rows — keep the static shape in sync
            rows = rows // beam_size * num_results
        sent_ids.desc.shape = (rows,) + tuple(ids.shape[1:2])
    return sent_ids, sent_scores


def beam_init_scores(ref, beam_size):
    """Initial cumulative log-probs for a [batch*beam] flattened beam:
    0 for each sample's beam 0, -1e9 for the rest."""
    helper = LayerHelper("beam_init")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="beam_init_scores", inputs={"Ref": [ref]},
                     outputs={"Out": [out]},
                     attrs={"beam_size": beam_size})
    out.desc.shape = (-1, 1)
    return out


def repeat_batch(x, times):
    """Repeat each row `times` times along batch (beam expansion helper)."""
    helper = LayerHelper("repeat_batch", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="repeat_batch", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"times": times})
    if x.shape:
        out.desc.shape = ((x.shape[0] * times if x.shape[0] and x.shape[0] > 0
                           else -1),) + tuple(x.shape[1:])
    out.desc.lod_level = x.lod_level
    return out
