"""v1 evaluator DSL (reference: trainer_config_helpers/evaluators.py).

Evaluators become extra metric nodes in the layer graph; the v2 trainer
collects them per batch/pass (replacing gserver/evaluators C++ classes).
"""
from __future__ import annotations

from .. import layers as F
from ..unique_name import generate as _uniq
from .layers import LayerOutput

__all__ = [
    "evaluator_base",
    "evaluator",
    "EvaluatorAttribute",
    "classification_error_evaluator",
    "auc_evaluator",
    "pnpair_evaluator",
    "precision_recall_evaluator",
    "ctc_error_evaluator",
    "chunk_evaluator",
    "sum_evaluator",
    "column_sum_evaluator",
    "value_printer_evaluator",
    "gradient_printer_evaluator",
    "maxid_printer_evaluator",
    "maxframe_printer_evaluator",
    "seqtext_printer_evaluator",
    "classification_error_printer_evaluator",
    "detection_map_evaluator",
]


class EvaluatorAttribute(object):
    """Parity: evaluators.py EvaluatorAttribute — category bitmask."""
    FOR_CLASSIFICATION = 1
    FOR_REGRESSION = 1 << 1
    FOR_RANK = 1 << 2
    FOR_PRINT = 1 << 3
    FOR_UTILS = 1 << 4
    FOR_DETECTION = 1 << 5


def evaluator(*attrs):
    """Parity: the `@evaluator(attr)` decorator — tags the wrapper with its
    category mask (`for_classification` test-ability etc.)."""
    import functools

    def impl(method):
        @functools.wraps(method)
        def wrapper(*args, **kwargs):
            return method(*args, **kwargs)
        mask = 0
        for a in attrs:
            mask |= a
        wrapper.is_evaluator = True
        wrapper.for_attr = mask
        return wrapper
    return impl


@evaluator(EvaluatorAttribute.FOR_CLASSIFICATION)
def classification_error_evaluator(input, label, name=None, top_k=1):
    name = name or _uniq("classification_error")

    def build(parents):
        acc = F.accuracy(input=parents[0], label=parents[1], k=top_k)
        return F.scale(acc, scale=-1.0, bias=1.0)  # error = 1 - accuracy

    return LayerOutput(name, "classification_error", [input, label],
                       size=1, build=build)


@evaluator(EvaluatorAttribute.FOR_CLASSIFICATION)
def auc_evaluator(input, label, name=None, weight=None):
    name = name or _uniq("auc")

    def build(parents):
        auc, _stats = F.auc(input=parents[0], label=parents[1])
        return auc

    return LayerOutput(name, "auc", [input, label], size=1, build=build)


@evaluator(EvaluatorAttribute.FOR_CLASSIFICATION)
def precision_recall_evaluator(input, label, name=None, positive_label=1,
                               weight=None):
    name = name or _uniq("precision_recall")

    def build(parents):
        from ..layers.tensor import create_global_var
        from ..layer_helper import LayerHelper
        probs, lab = parents
        ncls = input.size or 2
        helper = LayerHelper("precision_recall", input=probs)
        states = create_global_var(shape=[ncls, 4], value=0,
                                   dtype="float32", persistable=True)
        pred = F.argmax(probs, axis=-1)
        batch_m = helper.create_variable_for_type_inference("float32")
        accum_m = helper.create_variable_for_type_inference("float32")
        helper.append_op(
            type="precision_recall",
            inputs={"MaxProbs": [probs], "Indices": [pred],
                    "Labels": [lab], "StatesInfo": [states]},
            outputs={"BatchMetrics": [batch_m], "AccumMetrics": [accum_m],
                     "AccumStatesInfo": [states]})
        batch_m.desc.shape = (6,)
        return batch_m

    return LayerOutput(name, "precision_recall", [input, label], size=1,
                       build=build)


@evaluator(EvaluatorAttribute.FOR_CLASSIFICATION)
def chunk_evaluator(input, label, chunk_scheme, num_chunk_types, name=None,
                    excluded_chunk_types=None):
    name = name or _uniq("chunk")

    def build(parents):
        res = F.chunk_eval(input=parents[0], label=parents[1],
                           chunk_scheme=chunk_scheme,
                           num_chunk_types=num_chunk_types,
                           excluded_chunk_types=excluded_chunk_types)
        return res[0] if isinstance(res, (list, tuple)) else res

    return LayerOutput(name, "chunk", [input, label], size=1, build=build)


def evaluator_base(input, type, label=None, weight=None, name=None,
                   **attrs):
    """Generic constructor (parity: evaluators.py:71 evaluator_base).

    The reference appends an Evaluator proto to the ModelConfig; here the
    typed wrappers below build real metric subgraphs, and evaluator_base is
    the escape hatch for configs that call it directly — it records the
    spec and evaluates to the built input variable."""
    name = name or _uniq(type)
    parents = [x for x in ([input] if not isinstance(input, (list, tuple))
                           else list(input)) if x is not None]
    if label is not None:
        parents.append(label)
    if weight is not None:
        parents.append(weight)

    def build(built):
        return built[0]

    return LayerOutput(name, type, parents, size=1, build=build,
                       extra={"evaluator_attrs": dict(attrs)})


@evaluator(EvaluatorAttribute.FOR_RANK)
def pnpair_evaluator(input, label, query_id, weight=None, name=None):
    """Positive-negative pair rate for rank tasks (parity:
    evaluators.py:306; PnpairEvaluator gserver/evaluators)."""
    name = name or _uniq("pnpair")
    parents = [input, label, query_id] + ([weight] if weight else [])

    def build(built):
        from ..layers.misc import positive_negative_pair
        score, lab, qid = built[0], built[1], built[2]
        w = built[3] if len(built) > 3 else None
        pos, neg, _neu = positive_negative_pair(score, lab, qid, weight=w)
        return F.elementwise_div(pos, F.elementwise_max(
            neg, F.fill_constant(shape=[1], dtype="float32", value=1e-6)))

    return LayerOutput(name, "pnpair", parents, size=1, build=build)


@evaluator(EvaluatorAttribute.FOR_CLASSIFICATION)
def ctc_error_evaluator(input, label, name=None):
    """Sequence edit-distance (parity: evaluators.py:398
    ctc_error_evaluator, type="ctc_edit_distance")."""
    name = name or _uniq("ctc_edit_distance")

    def build(built):
        from ..layers.structured import edit_distance
        dist, _num = edit_distance(built[0], built[1], normalized=True)
        return F.mean(dist)

    return LayerOutput(name, "ctc_edit_distance", [input, label], size=1,
                       build=build)


@evaluator(EvaluatorAttribute.FOR_UTILS)
def sum_evaluator(input, name=None, weight=None):
    """Sum of the input over the batch (parity: evaluators.py:532)."""
    name = name or _uniq("sum")
    parents = [input] + ([weight] if weight else [])

    def build(built):
        x = built[0]
        if len(built) > 1:
            x = F.elementwise_mul(x, built[1])
        return F.reduce_sum(x)

    return LayerOutput(name, "sum", parents, size=1, build=build)


@evaluator(EvaluatorAttribute.FOR_UTILS)
def column_sum_evaluator(input, name=None, weight=None):
    """Per-column sum over the batch (parity: evaluators.py:558,
    type="last-column-sum")."""
    name = name or _uniq("column_sum")
    parents = [input] + ([weight] if weight else [])

    def build(built):
        x = built[0]
        if len(built) > 1:
            x = F.elementwise_mul(x, built[1])
        return F.reduce_sum(x, dim=0)

    return LayerOutput(name, "last-column-sum", parents, size=None,
                       build=build)


# ---------------------------------------------------------------------------
# printer evaluators (reference: FOR_PRINT family, evaluators.py:585-815)
# ---------------------------------------------------------------------------

@evaluator(EvaluatorAttribute.FOR_PRINT)
def value_printer_evaluator(input, name=None):
    """Print the values of one or more layers (evaluators.py:589)."""
    name = name or _uniq("value_printer")
    parents = [input] if not isinstance(input, (list, tuple)) else list(input)

    def build(built):
        out = None
        for node, var in zip(parents, built):
            out = F.Print(var, message=f"[value_printer] {node.name}:")
        return out

    return LayerOutput(name, "value_printer", parents, size=None, build=build)


@evaluator(EvaluatorAttribute.FOR_PRINT)
def gradient_printer_evaluator(input, name=None):
    """Print the gradient flowing through the input edge during backward
    (evaluators.py:612; print_op print_phase=backward analog via the
    print_grad custom-vjp identity op)."""
    name = name or _uniq("gradient_printer")
    parents = [input] if not isinstance(input, (list, tuple)) else list(input)

    def build(built):
        # v1 evaluators never rewire the graph, so a probe op on a side
        # branch would receive no cotangent.  Instead FLAG the variable;
        # the interpreter hooks a flagged var's recorded forward value
        # (core.backward.hook_print_grad), so the real gradient flowing
        # to downstream consumers is printed.
        for var in built:
            var.desc.print_grad = True
        return built[-1]

    return LayerOutput(name, "gradient_printer", parents, size=None,
                       build=build)


@evaluator(EvaluatorAttribute.FOR_PRINT)
def maxid_printer_evaluator(input, num_results=None, name=None):
    """Print top-k ids per row (evaluators.py:635, type=max_id_printer)."""
    name = name or _uniq("max_id_printer")
    parents = [input] if not isinstance(input, (list, tuple)) else list(input)
    k = num_results or 1

    def build(built):
        out = None
        for node, var in zip(parents, built):
            _vals, ids = F.topk(var, k=k)
            out = F.Print(ids, message=f"[maxid_printer] {node.name} top{k}:")
        return out

    return LayerOutput(name, "max_id_printer", parents, size=None,
                       build=build)


@evaluator(EvaluatorAttribute.FOR_PRINT)
def maxframe_printer_evaluator(input, num_results=None, name=None):
    """Print the top-k frames (time steps) of each sequence
    (evaluators.py:664, type=max_frame_printer)."""
    name = name or _uniq("max_frame_printer")
    parents = [input] if not isinstance(input, (list, tuple)) else list(input)
    k = num_results or 1

    def build(built):
        out = None
        for node, var in zip(parents, built):
            # frame score = the width-1 value per time step: fold the
            # trailing width axis into T ([B,T,1] -> [B,T]) so top-k runs
            # over the TIME axis (gserver MaxFramePrinter semantics)
            # [B,T,1] (runtime) -> [B,T]; identity for 2-D inputs.  The
            # declared desc shape can be 2-D while the fed sequence is 3-D,
            # so reshape unconditionally rather than testing var.shape.
            frames = F.reshape(var, [0, -1])
            _vals, idx = F.topk(frames, k=k)
            out = F.Print(idx, message=f"[maxframe_printer] {node.name}:")
        return out

    return LayerOutput(name, "max_frame_printer", parents, size=None,
                       build=build)


@evaluator(EvaluatorAttribute.FOR_PRINT)
def seqtext_printer_evaluator(input, result_file, id_input=None,
                              dict_file=None, delimited=None, name=None):
    """Decode id sequences through a dictionary and append them to
    ``result_file`` (evaluators.py:697, gserver SequenceTextPrinter)."""
    assert isinstance(result_file, str)
    name = name or _uniq("seq_text_printer")
    parents = [input] + ([id_input] if id_input is not None else [])

    def build(built):
        from ..layer_helper import LayerHelper
        ids = built[0]
        helper = LayerHelper("seq_text_printer", input=ids)
        out = helper.create_variable_for_type_inference("int32")
        inputs = {"Ids": [ids]}
        if len(built) > 1:
            inputs["SampleIds"] = [built[1]]
        helper.append_op(type="seq_text_printer", inputs=inputs,
                         outputs={"Out": [out]},
                         attrs={"result_file": result_file,
                                "dict_file": dict_file or "",
                                "delimited": (True if delimited is None
                                              else bool(delimited))})
        out.desc.shape = ()
        return out

    return LayerOutput(name, "seq_text_printer", parents, size=None,
                       build=build)


@evaluator(EvaluatorAttribute.FOR_PRINT)
def classification_error_printer_evaluator(input, label, threshold=0.5,
                                           name=None):
    """Print the per-sample classification error (evaluators.py:787)."""
    name = name or _uniq("classification_error_printer")

    def build(built):
        probs, lab = built
        if (probs.shape and probs.shape[-1] == 1) or len(probs.shape) == 1:
            pred = F.cast(F.greater_than(
                probs, F.fill_constant(shape=[1], dtype=probs.dtype,
                                       value=float(threshold))), "float32")
            err = F.cast(F.not_equal(pred, F.cast(lab, "float32")),
                         "float32")
        else:
            pred = F.argmax(probs, axis=-1)
            err = F.cast(F.not_equal(
                F.cast(pred, "int64"),
                F.reshape(F.cast(lab, "int64"), [-1])), "float32")
        return F.Print(err, message="[classification_error_printer]")

    return LayerOutput(name, "classification_error_printer", [input, label],
                       size=None, build=build)


@evaluator(EvaluatorAttribute.FOR_DETECTION)
def detection_map_evaluator(input, label, overlap_threshold=0.5,
                            background_id=0, evaluate_difficult=False,
                            ap_type="11point", name=None):
    """Detection mAP (parity: evaluators.py:170; detection_map op)."""
    name = name or _uniq("detection_map")

    def build(built):
        from ..layers.detection import detection_map
        det, gt = built
        # v1 detection label rows are [label, xmin, ymin, xmax, ymax,
        # difficult] (gserver DetectionMAPEvaluator input convention); the
        # detection_map op splits GTBoxes rows itself when GTLabels is
        # absent, so the combined tensor is passed straight through.
        m = detection_map(det, gt, None,
                          overlap_threshold=overlap_threshold,
                          background_label=background_id,
                          evaluate_difficult=evaluate_difficult,
                          ap_version=ap_type)
        return m[0] if isinstance(m, (list, tuple)) else m

    return LayerOutput(name, "detection_map", [input, label], size=1,
                       build=build)
