"""v1 layer DSL (reference: trainer_config_helpers/layers.py, ~7.6k lines).

The reference's layer functions append ``LayerConfig`` protobuf entries that
gserver's C++ ``Layer`` subclasses (gserver/layers, Layer.h:62) interpret at
run time.  Here each function returns a lazy ``LayerOutput`` node; the graph
is lowered onto the port's Program IR by :func:`parse_network` (the
analog of config_parser.py's parse); the port's Executor interprets that
Program op by op on the card.  Counterpart of
``paddle_tpu/trainer_config_helpers/layers.py``: the same config builds the
same Program and the same parameter names in both packages, so a tar of
`v2.parameters` written by either loads into the other.

Only behavior is mirrored — sizes, defaults, and composition semantics; the
implementation rides the port's fluid-style layers.  A v1 ``lstmemory``
keeps the reference's peepholes (``dynamic_lstm``'s default), which the
port runs as the scan, not the fused LSTM kernel; ``grumemory`` reaches
the GRU kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from .. import layers as F
from ..layers import ops as OPS
from .activations import (BaseActivation, TanhActivation, SigmoidActivation,
                          SoftmaxActivation, LinearActivation, to_act_name)
from .attrs import ParameterAttribute, ExtraLayerAttribute
from .poolings import BasePoolingType, MaxPooling, to_pool_name
from .. import unique_name as _unique_mod
from ..unique_name import generate as _uniq

__all__ = [
    "LayerOutput", "parse_network",
    "data_layer", "fc_layer", "embedding_layer", "lstmemory", "grumemory",
    "img_conv_layer", "img_pool_layer", "batch_norm_layer",
    "img_cmrnorm_layer", "pooling_layer", "last_seq", "first_seq",
    "expand_layer", "concat_layer", "seq_concat_layer", "addto_layer",
    "dropout_layer", "cos_sim", "trans_layer", "slope_intercept_layer",
    "scaling_layer", "power_layer", "interpolation_layer", "sum_cost",
    "classification_cost", "cross_entropy", "cross_entropy_cost",
    "mse_cost", "regression_cost", "square_error_cost",
    "crf_layer", "crf_decoding_layer", "ctc_layer", "warp_ctc_layer",
    "max_id_layer", "maxid_layer", "softmax_layer", "mixed_layer",
    "full_matrix_projection", "identity_projection", "table_projection",
    "memory", "recurrent_group", "get_output_layer",
    # round-2 tail
    "lstm_step_layer", "gru_step_layer", "gru_step_naive_layer",
    "recurrent_layer", "clip_layer", "pad_layer", "crop_layer",
    "maxout_layer", "prelu_layer", "multiplex_layer", "dot_prod_layer",
    "out_prod_layer", "l2_distance_layer", "row_l2_norm_layer",
    "sum_to_one_norm_layer", "scale_shift_layer", "resize_layer",
    "rotate_layer", "switch_order_layer", "repeat_layer",
    "seq_reshape_layer", "seq_slice_layer", "sub_seq_layer",
    "sub_nested_seq_layer", "kmax_seq_score_layer", "bilinear_interp_layer",
    "BeamInput", "cross_entropy_over_beam",
    "upsample_layer", "sampling_id_layer", "eos_layer", "printer_layer",
    "linear_comb_layer", "tensor_layer", "gated_unit_layer",
    "factorization_machine", "selective_fc_layer", "conv_shift_layer",
    "row_conv_layer", "block_expand_layer", "spp_layer", "roi_pool_layer",
    "img_conv3d_layer", "img_pool3d_layer", "rank_cost", "lambda_cost",
    "huber_regression_cost", "huber_classification_cost", "smooth_l1_cost",
    "multi_binary_label_cross_entropy", "cross_entropy_with_selfnorm",
    "nce_layer", "hsigmoid", "priorbox_layer", "cross_channel_norm_layer",
    "multibox_loss_layer", "detection_output_layer", "dotmul_projection",
    "scaling_projection", "trans_full_matrix_projection",
    "slice_projection", "context_projection", "conv_projection",
    "dotmul_operator", "conv_operator", "beam_search", "StaticInput",
    "layer_support",
]


_CREATION_HOOK: List = []      # recurrent_group records step-time nodes


class LayerOutput(object):
    """A lazy node in the v1 layer graph.

    ``build(built_parents) -> fluid Variable`` runs inside the Program being
    populated by :func:`parse_network`.  ``size`` mirrors the reference's
    LayerConfig.size (used by downstream layers for shape inference).
    """

    def __init__(self, name: str, layer_type: str,
                 parents: Sequence["LayerOutput"] = (),
                 size: Optional[int] = None,
                 build: Optional[Callable] = None,
                 extra: Optional[dict] = None):
        if _CREATION_HOOK:
            _CREATION_HOOK[-1].append(self)
        self.name = name
        self.layer_type = layer_type
        self.parents = list(parents)
        self.size = size
        self._build = build
        self.extra = extra or {}       # e.g. image meta: channels/height/width

    def __repr__(self):
        return f"<LayerOutput {self.name} type={self.layer_type} size={self.size}>"


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _apply_act(var, act):
    name = to_act_name(act)
    if not name:
        return var
    fn = getattr(OPS, name, None) or getattr(F, name, None)
    if fn is None:
        raise ValueError(f"unknown activation {name!r}")
    return fn(var)


def _apply_extra(var, layer_attr):
    if layer_attr is not None and getattr(layer_attr, "drop_rate", None):
        return F.dropout(var, dropout_prob=layer_attr.drop_rate)
    return var


def _fill_zeros_like(x):
    """Zeros shaped like ``x`` through the registered ``fill_zeros_like``
    rule.  The layers package has no such function (the JAX package's
    ``detection_output_layer`` calls one and raises ``AttributeError``);
    the op is appended directly, as the reference's layer would."""
    from ..layer_helper import LayerHelper
    helper = LayerHelper("fill_zeros_like", input=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": [x]},
                     outputs={"Out": [out]})
    out.desc.shape = x.shape
    return out


class _NodeScopedGenerator(_unique_mod.UniqueNameGenerator):
    """Name generator scoped to one layer node: every name is prefixed with
    the node's (globally unique, construction-time) name.  This keeps
    parameter names IDENTICAL across re-parses of the same layer graph —
    the v1 convention of stable per-layer parameter names (_layer.w0)."""

    def __init__(self, prefix):
        super().__init__()
        self.prefix = prefix

    def __call__(self, key):
        return f"{self.prefix}.{super().__call__(key)}"


def parse_network(*outputs) -> List:
    """Lower a v1 layer graph into the current default Program.

    Analog of config_parser.parse_config: topologically builds every node
    reachable from ``outputs`` exactly once, returning the fluid Variables
    for the requested outputs (order preserved).
    """
    outs = []
    for o in outputs:
        outs.extend(_as_list(o))
    built: Dict[int, object] = {}

    def build(node: LayerOutput):
        key = id(node)
        if key in built:
            return built[key]
        parents = [build(p) for p in node.parents]
        with _unique_mod.guard(_NodeScopedGenerator(node.name)):
            var = node._build(parents)
        built[key] = var
        return var

    return [build(o) for o in outs]


# ---------------------------------------------------------------------------
# input
# ---------------------------------------------------------------------------

def data_layer(name, size, height=None, width=None, type=None,
               layer_attr=None):
    """reference layers.py data_layer: declares a network input.

    ``type`` is a data_type spec (v2.data_type); sequence specs set
    lod_level=1 so the DataFeeder produces padded batch + length vector
    (the static-shape analog of LoD).
    """
    spec = type
    dtype = getattr(spec, "dtype", "float32")
    lod_level = 1 if getattr(spec, "seq_type", 0) else 0
    if (lod_level and size > 1 and str(dtype).startswith("float")
            and not (height and width)):
        # dense_vector_sequence: runtime layout is [B, T, size]; declare
        # the symbolic time axis so downstream shape inference (fc weight
        # widths etc.) reads the feature dim at index -1
        def build_seq(_):
            return F.data(name=name, shape=[-1, size], dtype=dtype,
                          lod_level=lod_level)
        return LayerOutput(name, "data", [], size=size, build=build_seq,
                           extra={"spec": spec})
    if height and width:
        channels = max(1, size // (height * width))
        shape = [channels, height, width]
        extra = {"channels": channels, "height": height, "width": width,
                 "spec": spec}
    else:
        shape = [size]
        extra = {"spec": spec}

    def build(_):
        return F.data(name=name, shape=shape, dtype=dtype,
                      lod_level=lod_level)

    return LayerOutput(name, "data", [], size=size, build=build, extra=extra)


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def fc_layer(input, size, act=None, name=None, param_attr=None,
             bias_attr=None, layer_attr=None):
    act = act or TanhActivation()       # v1 default act is tanh
    name = name or _uniq("fc")
    inputs = _as_list(input)

    def build(parents):
        outs = []
        for v in parents:
            nfd = 2 if v.lod_level else 1
            outs.append(F.fc(input=v, size=size, num_flatten_dims=nfd,
                             param_attr=ParameterAttribute.to_attr(param_attr),
                             bias_attr=ParameterAttribute.to_attr(bias_attr)
                             if bias_attr is not None else None))
        out = outs[0]
        for o in outs[1:]:
            out = F.elementwise_add(out, o)
        out = _apply_act(out, act)
        return _apply_extra(out, layer_attr)

    return LayerOutput(name, "fc", inputs, size=size, build=build)


def embedding_layer(input, size, name=None, param_attr=None, layer_attr=None):
    name = name or _uniq("embedding")
    vocab = input.size

    def build(parents):
        return F.embedding(
            input=parents[0], size=[vocab, size],
            param_attr=ParameterAttribute.to_attr(param_attr))

    return LayerOutput(name, "embedding", [input], size=size, build=build)


# ---------------------------------------------------------------------------
# recurrent
# ---------------------------------------------------------------------------

def lstmemory(input, name=None, size=None, reverse=False, act=None,
              gate_act=None, state_act=None, bias_attr=None, param_attr=None,
              layer_attr=None):
    """v1 lstmemory: input must be the pre-projected gate sequence of width
    4*hidden (reference contract: LstmLayer.cpp expects a mixed/fc in front).
    """
    hidden = size or (input.size // 4)
    name = name or _uniq("lstmemory")

    def build(parents):
        h, _c = F.dynamic_lstm(
            input=parents[0], size=4 * hidden, is_reverse=reverse,
            gate_activation=to_act_name(gate_act) or "sigmoid",
            cell_activation=to_act_name(state_act) or "tanh",
            candidate_activation=to_act_name(act) or "tanh",
            param_attr=ParameterAttribute.to_attr(param_attr),
            bias_attr=ParameterAttribute.to_attr(bias_attr)
            if bias_attr is not None else None)
        return _apply_extra(h, layer_attr)

    return LayerOutput(name, "lstmemory", [input], size=hidden, build=build)


def grumemory(input, name=None, size=None, reverse=False, act=None,
              gate_act=None, bias_attr=None, param_attr=None,
              layer_attr=None):
    """v1 grumemory: input width is 3*hidden."""
    hidden = size or (input.size // 3)
    name = name or _uniq("grumemory")

    def build(parents):
        h = F.dynamic_gru(
            input=parents[0], size=hidden, is_reverse=reverse,
            gate_activation=to_act_name(gate_act) or "sigmoid",
            candidate_activation=to_act_name(act) or "tanh",
            param_attr=ParameterAttribute.to_attr(param_attr),
            bias_attr=ParameterAttribute.to_attr(bias_attr)
            if bias_attr is not None else None)
        return _apply_extra(h, layer_attr)

    return LayerOutput(name, "grumemory", [input], size=hidden, build=build)


# ---------------------------------------------------------------------------
# conv / pool / norm (image)
# ---------------------------------------------------------------------------

def _img_meta(node):
    e = node.extra
    if "channels" not in e:
        raise ValueError(
            f"layer {node.name} has no image metadata; give data_layer "
            f"height/width or set num_channels explicitly")
    return e["channels"], e["height"], e["width"]


def _out_hw(h, w, k, s, p):
    return (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1


def img_conv_layer(input, filter_size, num_filters, name=None,
                   num_channels=None, act=None, groups=1, stride=1,
                   padding=0, bias_attr=None, param_attr=None,
                   shared_biases=True, layer_attr=None, trans=False):
    act = act or TanhActivation()
    name = name or _uniq("conv")
    c, h, w = (num_channels, None, None) if num_channels else (None,) * 3
    if c is None:
        c, h, w = _img_meta(input)
    elif input.extra.get("height"):
        h, w = input.extra["height"], input.extra["width"]
    oh, ow = _out_hw(h, w, filter_size, stride, padding)
    size = num_filters * oh * ow

    def build(parents):
        v = parents[0]
        if v.shape and len(v.shape) == 1:
            v = F.reshape(v, [-1, c, h, w])
        out = F.conv2d(input=v, num_filters=num_filters,
                       filter_size=filter_size, stride=stride,
                       padding=padding, groups=groups,
                       act=to_act_name(act),
                       param_attr=ParameterAttribute.to_attr(param_attr),
                       bias_attr=ParameterAttribute.to_attr(bias_attr)
                       if bias_attr is not None else None)
        return _apply_extra(out, layer_attr)

    return LayerOutput(name, "conv", [input], size=size, build=build,
                       extra={"channels": num_filters, "height": oh,
                              "width": ow})


def img_pool_layer(input, pool_size, name=None, num_channels=None,
                   pool_type=None, stride=1, padding=0, layer_attr=None,
                   ceil_mode=True):
    name = name or _uniq("pool")
    ptype = to_pool_name(pool_type, default="max")
    if ptype == "average":
        ptype = "avg"
    c, h, w = _img_meta(input)
    oh, ow = _out_hw(h, w, pool_size, stride, padding)
    size = c * oh * ow

    def build(parents):
        return F.pool2d(input=parents[0], pool_size=pool_size,
                        pool_type=ptype, pool_stride=stride,
                        pool_padding=padding, ceil_mode=ceil_mode)

    return LayerOutput(name, "pool", [input], size=size, build=build,
                       extra={"channels": c, "height": oh, "width": ow})


def batch_norm_layer(input, act=None, name=None, num_channels=None,
                     bias_attr=None, param_attr=None, layer_attr=None,
                     use_global_stats=None, moving_average_fraction=0.9):
    name = name or _uniq("batch_norm")

    def build(parents):
        return F.batch_norm(
            input=parents[0], act=to_act_name(act),
            momentum=moving_average_fraction,
            is_test=bool(use_global_stats),
            param_attr=ParameterAttribute.to_attr(param_attr))

    return LayerOutput(name, "batch_norm", [input], size=input.size,
                       build=build, extra=dict(input.extra))


def img_cmrnorm_layer(input, size, scale=0.0128, power=0.75, name=None,
                      num_channels=None, layer_attr=None):
    """v1 cross-map response norm (AlexNet LRN; gserver CMRProjectionNormLayer)."""
    name = name or _uniq("cmrnorm")

    def build(parents):
        return F.lrn(input=parents[0], n=size, k=1.0, alpha=scale, beta=power)

    return LayerOutput(name, "norm", [input], size=input.size, build=build,
                       extra=dict(input.extra))


# ---------------------------------------------------------------------------
# sequence reductions / shaping
# ---------------------------------------------------------------------------

def pooling_layer(input, pooling_type=None, name=None, bias_attr=None,
                  agg_level=None, layer_attr=None):
    name = name or _uniq("seq_pool")
    ptype = to_pool_name(pooling_type, default="sum")

    def build(parents):
        return F.sequence_pool(input=parents[0], pool_type=ptype)

    return LayerOutput(name, "seq_pool", [input], size=input.size,
                       build=build)


def last_seq(input, name=None, agg_level=None, stride=-1, layer_attr=None):
    name = name or _uniq("last_seq")

    def build(parents):
        return F.sequence_last_step(parents[0])

    return LayerOutput(name, "last_seq", [input], size=input.size,
                       build=build)


def first_seq(input, name=None, agg_level=None, layer_attr=None):
    name = name or _uniq("first_seq")

    def build(parents):
        return F.sequence_first_step(parents[0])

    return LayerOutput(name, "first_seq", [input], size=input.size,
                       build=build)


def expand_layer(input, expand_as, name=None, bias_attr=None,
                 expand_level=None, layer_attr=None):
    name = name or _uniq("expand")

    def build(parents):
        return F.sequence_expand(x=parents[0], y=parents[1])

    return LayerOutput(name, "expand", [input, expand_as], size=input.size,
                       build=build)


def concat_layer(input, act=None, name=None, layer_attr=None,
                 bias_attr=None):
    name = name or _uniq("concat")
    inputs = _as_list(input)
    size = sum(i.size for i in inputs if i.size)

    def build(parents):
        axis = -1
        out = F.concat(parents, axis=axis)
        out = _apply_act(out, act)
        return _apply_extra(out, layer_attr)

    return LayerOutput(name, "concat", inputs, size=size, build=build)


def seq_concat_layer(a, b, act=None, name=None, layer_attr=None,
                     bias_attr=None):
    """Concatenate two sequences time-wise (reference SequenceConcatLayer)."""
    name = name or _uniq("seq_concat")

    def build(parents):
        return F.sequence_concat(parents)

    return LayerOutput(name, "seq_concat", [a, b], size=a.size, build=build)


def addto_layer(input, act=None, name=None, bias_attr=None,
                layer_attr=None):
    name = name or _uniq("addto")
    inputs = _as_list(input)

    def build(parents):
        out = parents[0]
        for v in parents[1:]:
            out = F.elementwise_add(out, v)
        out = _apply_act(out, act)
        return _apply_extra(out, layer_attr)

    return LayerOutput(name, "addto", inputs, size=inputs[0].size,
                       build=build)


def dropout_layer(input, dropout_rate, name=None):
    name = name or _uniq("dropout")

    def build(parents):
        return F.dropout(parents[0], dropout_prob=dropout_rate)

    return LayerOutput(name, "dropout", [input], size=input.size,
                       build=build)


# ---------------------------------------------------------------------------
# elementwise math
# ---------------------------------------------------------------------------

def cos_sim(a, b, scale=1, size=1, name=None, layer_attr=None):
    name = name or _uniq("cos_sim")

    def build(parents):
        x = F.l2_normalize(parents[0], axis=-1)
        y = F.l2_normalize(parents[1], axis=-1)
        dot = F.reduce_sum(F.elementwise_mul(x, y), dim=-1, keep_dim=True)
        return F.scale(dot, scale=float(scale))

    return LayerOutput(name, "cos_sim", [a, b], size=size, build=build)


def trans_layer(input, name=None, layer_attr=None):
    name = name or _uniq("trans")

    def build(parents):
        return F.transpose(parents[0], perm=[1, 0])

    return LayerOutput(name, "trans", [input], size=input.size, build=build)


def slope_intercept_layer(input, name=None, slope=1.0, intercept=0.0,
                          layer_attr=None):
    name = name or _uniq("slope_intercept")

    def build(parents):
        return F.scale(parents[0], scale=float(slope),
                       bias=float(intercept))

    return LayerOutput(name, "slope_intercept", [input], size=input.size,
                       build=build)


def scaling_layer(input, weight, name=None, layer_attr=None):
    """Row-wise scale: weight is a size-1 layer per row (ScalingLayer)."""
    name = name or _uniq("scaling")

    def build(parents):
        return F.elementwise_mul(parents[1], parents[0], axis=0)

    return LayerOutput(name, "scaling", [weight, input], size=input.size,
                       build=build)


def power_layer(input, weight, name=None, layer_attr=None):
    name = name or _uniq("power")

    def build(parents):
        w, v = parents
        return F.elementwise_pow(v, w, axis=0)

    return LayerOutput(name, "power", [weight, input], size=input.size,
                       build=build)


def interpolation_layer(input, weight, name=None, layer_attr=None):
    """out = w*x + (1-w)*y (InterpolationLayer)."""
    name = name or _uniq("interpolation")
    x, y = _as_list(input)

    def build(parents):
        w, xv, yv = parents
        wx = F.elementwise_mul(xv, w, axis=0)
        wy = F.elementwise_mul(yv, F.scale(w, scale=-1.0, bias=1.0), axis=0)
        return F.elementwise_add(wx, wy)

    return LayerOutput(name, "interpolation", [weight, x, y], size=x.size,
                       build=build)


# ---------------------------------------------------------------------------
# costs
# ---------------------------------------------------------------------------

def classification_cost(input, label, weight=None, name=None,
                        evaluator=None, layer_attr=None):
    """v1 classification_cost = softmax output + cross-entropy, meaned."""
    name = name or _uniq("cost")

    def build(parents):
        pred, lab = parents[0], parents[1]
        ce = F.cross_entropy(input=pred, label=lab)
        return F.mean(ce)

    return LayerOutput(name, "cost", [input, label], size=1, build=build)


def cross_entropy(input, label, name=None, coeff=1.0, weight=None,
                  layer_attr=None):
    name = name or _uniq("cross_entropy")

    def build(parents):
        ce = F.cross_entropy(input=parents[0], label=parents[1])
        out = F.mean(ce)
        if coeff != 1.0:
            out = F.scale(out, scale=float(coeff))
        return out

    return LayerOutput(name, "cross_entropy", [input, label], size=1,
                       build=build)


cross_entropy_cost = cross_entropy


def mse_cost(input, label, weight=None, name=None, coeff=1.0,
             layer_attr=None):
    name = name or _uniq("mse_cost")

    def build(parents):
        se = F.square_error_cost(input=parents[0], label=parents[1])
        out = F.mean(se)
        if coeff != 1.0:
            out = F.scale(out, scale=float(coeff))
        return out

    return LayerOutput(name, "mse", [input, label], size=1, build=build)


regression_cost = mse_cost
square_error_cost = mse_cost


def sum_cost(input, name=None, layer_attr=None):
    name = name or _uniq("sum_cost")

    def build(parents):
        return F.reduce_sum(parents[0])

    return LayerOutput(name, "sum_cost", [input], size=1, build=build)


# ---------------------------------------------------------------------------
# structured prediction
# ---------------------------------------------------------------------------

def crf_layer(input, label, size=None, weight=None, param_attr=None,
              name=None, coeff=1.0, layer_attr=None):
    name = name or _uniq("crf")
    nlabel = size or input.size

    def build(parents):
        ll = F.linear_chain_crf(
            input=parents[0], label=parents[1],
            param_attr=ParameterAttribute.to_attr(param_attr))
        return F.mean(ll)

    return LayerOutput(name, "crf", [input, label], size=1, build=build)


def crf_decoding_layer(input, size=None, label=None, param_attr=None,
                       name=None, layer_attr=None):
    name = name or _uniq("crf_decoding")
    parents = [input] + ([label] if label is not None else [])

    def build(built):
        return F.crf_decoding(
            input=built[0],
            param_attr=ParameterAttribute.to_attr(param_attr),
            label=built[1] if len(built) > 1 else None)

    return LayerOutput(name, "crf_decoding", parents, size=input.size,
                       build=build)


def ctc_layer(input, label, size=None, name=None, norm_by_times=False,
              layer_attr=None):
    name = name or _uniq("ctc")

    def build(parents):
        loss = F.warpctc(input=parents[0], label=parents[1],
                         norm_by_times=norm_by_times)
        return F.mean(loss)

    return LayerOutput(name, "ctc", [input, label], size=1, build=build)


def warp_ctc_layer(input, label, size=None, name=None, blank=0,
                   norm_by_times=False, layer_attr=None):
    """Distinct warp-ctc contract (reference layers.py:5669): exposes the
    `blank` label id and `norm_by_times`, which plain ctc_layer fixes at
    blank=0/off.  Lowers to the same fluid warpctc op (optax CTC core) —
    the reference's separate warp-ctc BACKEND is a build detail; the
    layer-level contract (size = classes+1, configurable blank, per-time
    normalization) is what this wrapper preserves."""
    name = name or _uniq("warp_ctc")
    if size is not None and input.size and size != input.size:
        raise ValueError(
            f"warp_ctc_layer size={size} must equal the input dimension "
            f"(categories + 1 = {input.size})")

    def build(parents):
        loss = F.warpctc(input=parents[0], label=parents[1], blank=blank,
                         norm_by_times=norm_by_times)
        return F.mean(loss)

    return LayerOutput(name, "warp_ctc", [input, label], size=1,
                       build=build)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

def max_id_layer(input, name=None, layer_attr=None):
    name = name or _uniq("max_id")

    def build(parents):
        return F.argmax(parents[0], axis=-1)

    return LayerOutput(name, "max_id", [input], size=1, build=build)


maxid_layer = max_id_layer


def softmax_layer(input, name=None, layer_attr=None):
    name = name or _uniq("softmax")

    def build(parents):
        return F.softmax(parents[0])

    return LayerOutput(name, "softmax", [input], size=input.size,
                       build=build)


def get_output_layer(input, arg_name=None, name=None, layer_attr=None):
    """v1 get_output_layer: select one of a layer's named outputs (e.g. the
    cell state of lstm_step_layer via arg_name="state"); identity for
    single-output layers.  The returned node carries ``name``, so a
    ``memory(name=...)`` can link to it (the reference convention in
    lstmemory_unit)."""
    name = name or _uniq("get_output")
    aux = (input.extra or {}).get("aux", {})
    if arg_name and arg_name in aux:
        chosen = aux[arg_name]
        node = LayerOutput(name, "get_output", [chosen], size=chosen.size,
                           build=lambda parents: parents[0])
        return node

    def build(parents):
        return parents[0]

    return LayerOutput(name, "get_output", [input], size=input.size,
                       build=build)


# ---------------------------------------------------------------------------
# mixed layer + projections (subset): v1's mixed_layer sums projections
# ---------------------------------------------------------------------------

class _Projection(object):
    def __init__(self, input, build, size):
        self.input = input
        self.build = build
        self.size = size


def full_matrix_projection(input, size=0, param_attr=None):
    def build(v):
        return F.fc(input=v, size=size,
                    num_flatten_dims=2 if v.lod_level else 1,
                    param_attr=ParameterAttribute.to_attr(param_attr),
                    bias_attr=False)
    return _Projection(input, build, size)


def identity_projection(input, offset=None, size=None):
    def build(v):
        if offset:
            width = size or (input.size - offset)
            last = len(v.shape) - 1 if v.shape else 1
            return F.slice(v, axes=[last], starts=[offset],
                           ends=[offset + width])
        return v
    return _Projection(input, build, size or input.size)


def table_projection(input, size=0, param_attr=None):
    def build(v):
        return F.embedding(input=v, size=[input.size, size],
                           param_attr=ParameterAttribute.to_attr(param_attr))
    return _Projection(input, build, size)


class _MixedLayer(LayerOutput):
    """mixed_layer node; also usable as ``with mixed_layer(...) as m:
    m += projection`` (the v1 context-manager idiom) — parents stay
    mutable until parse_network builds the graph."""

    def __init__(self, name, size, act, bias_attr, layer_attr):
        super().__init__(name, "mixed", [], size=size, build=self._do_build)
        self._projs = []
        self._spans = []
        self._act = act
        self._bias_attr = bias_attr
        self._layer_attr = layer_attr

    def _add(self, p):
        ins = p.inputs if isinstance(p, _Operator) else [p.input]
        self._spans.append((len(self.parents), len(self.parents) + len(ins)))
        self.parents.extend(ins)
        self._projs.append(p)
        if not self.size:
            self.size = p.size
        return self

    __iadd__ = _add

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _do_build(self, built):
        outs = []
        for p, (a, b) in zip(self._projs, self._spans):
            outs.append(p.build(*built[a:b]) if isinstance(p, _Operator)
                        else p.build(built[a]))
        out = outs[0]
        for o in outs[1:]:
            out = F.elementwise_add(out, o)
        if self._bias_attr is not None and self._bias_attr is not False:
            bvec = F.create_parameter(
                [self.size],
                attr=ParameterAttribute.to_attr(self._bias_attr),
                is_bias=True)
            out = F.elementwise_add(out, bvec)
        out = _apply_act(out, self._act)
        return _apply_extra(out, self._layer_attr)


def mixed_layer(size=0, input=None, name=None, act=None, bias_attr=None,
                layer_attr=None):
    """v1 mixed_layer: sum of projections and operators (+bias, +act).
    With ``input=None`` it returns a context-manager node to ``+=``
    projections into."""
    node = _MixedLayer(name or _uniq("mixed"), size, act, bias_attr,
                       layer_attr)
    for p in _as_list(input):
        node._add(p)
    return node


# ---------------------------------------------------------------------------
# recurrent_group (subset): step function over a sequence input
# ---------------------------------------------------------------------------

class StaticInput(object):
    """Non-sequence input broadcast to every step (reference StaticInput)."""

    def __init__(self, input, is_seq=False, size=None):
        self.input = input
        self.is_seq = is_seq
        self.size = size or input.size


class BaseGeneratedInput(object):
    """Marker base for generation-mode inputs (reference layers.py)."""

    def __init__(self):
        self.bos_id = None
        self.eos_id = None


class GeneratedInput(BaseGeneratedInput):
    """The previously generated word fed back through an embedding table
    (reference GeneratedInput: size = dict size, embedding_name = the
    shared target-embedding parameter, embedding_size = word vector
    dim)."""

    def __init__(self, size, embedding_name, embedding_size):
        super().__init__()
        self.size = size
        self.embedding_name = embedding_name
        self.embedding_size = embedding_size


class _Memory(LayerOutput):
    """Placeholder for the step function's recurrent state."""

    def __init__(self, name, size, boot_layer=None):
        super().__init__(name or _uniq("memory"), "memory", [], size=size)
        self.boot_layer = boot_layer


def memory(name=None, size=None, boot_layer=None, **kwargs):
    return _Memory(name, size, boot_layer)


def recurrent_group(step, input, name=None, reverse=False):
    """v1 recurrent_group — run ``step`` over each timestep of the sequence
    inputs (reference RecurrentGradientMachine.h:32).

    Lowered through the framework's scan-based DynamicRNN rather than a
    per-timestep interpreter: the step graph is traced once and becomes the
    body of the DynamicRNN.  Two step styles are accepted:

    - fluid style: ``step`` receives fluid Variables and returns one
      (memories via DynamicRNN must be handled by the caller's layers);
    - v1 style: ``step`` receives LayerOutput nodes and composes v1 layers
      (mixed_layer, lstm_step_layer, ...) with ``memory(name=X)`` linking
      to the step's layer named X — exactly the reference convention.
    """
    from ..layers.control_flow import DynamicRNN

    name = name or _uniq("recurrent_group")
    ins = _as_list(input)
    seq_nodes = [i for i in ins if not isinstance(i, StaticInput)]
    static_nodes = [i.input for i in ins if isinstance(i, StaticInput)]

    # Run the step eagerly on bound placeholders: v1 layer functions build
    # a pure LayerOutput graph (no program ops yet), so this is side-effect
    # free and lets us discover memories + their boot layers up front.
    bound = []
    for i in ins:
        node = i.input if isinstance(i, StaticInput) else i
        b = LayerOutput(node.name + "@step", "step_input", [],
                        size=(i.size if isinstance(i, StaticInput)
                              else node.size))
        b._bound_slot = len(bound)
        b._bound_static = isinstance(i, StaticInput)
        bound.append(b)
    _CREATION_HOOK.append([])
    try:
        result = step(*bound)
        v1_style = isinstance(result, LayerOutput) or (
            isinstance(result, (list, tuple)) and result
            and isinstance(result[0], LayerOutput))
    except Exception:
        # a fluid-style step calls fluid layers on its args and chokes on
        # the LayerOutput placeholders — that IS the style signal
        result, v1_style = None, False
    finally:
        step_nodes = _CREATION_HOOK.pop()

    def _rev_in(seq_vars):
        return [F.sequence_reverse(v) for v in seq_vars] if reverse \
            else seq_vars

    def _rev_out(out):
        if not reverse:
            return out
        if isinstance(out, (list, tuple)):
            return [F.sequence_reverse(o) for o in out]
        return F.sequence_reverse(out)

    if not v1_style:
        # fluid-style step: rebuild at parse time on real variables
        def build(parents):
            seq_vars = _rev_in(parents[:len(seq_nodes)])
            static_vars = parents[len(seq_nodes):]
            drnn = DynamicRNN()
            with drnn.block():
                step_ins = [drnn.step_input(v) for v in seq_vars]
                statics = [drnn.static_input(v) for v in static_vars]
                args, si, st = [], iter(step_ins), iter(statics)
                for i in ins:
                    args.append(next(st) if isinstance(i, StaticInput)
                                else next(si))
                out = step(*args)
                drnn.output(out)
            return _rev_out(drnn())

        return LayerOutput(name, "recurrent_group",
                           seq_nodes + static_nodes, size=None, build=build)

    out_nodes = _as_list(result)

    # graph walk: memories, boot layers, leaf validation
    memories, seen = [], set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, _Memory):
            memories.append(n)
            if n.boot_layer is not None:
                return                      # boot built in the outer graph
            return
        for p in n.parents:
            walk(p)

    for o in out_nodes:
        walk(o)
    # nodes created inside the step but dangling off the output path (the
    # reference registers every layer globally; e.g. lstmemory_unit's
    # get_output_layer naming the cell for its memory link)
    for n in step_nodes:
        walk(n)
    boot_nodes = [m.boot_layer for m in memories if m.boot_layer is not None]
    parents_nodes = seq_nodes + static_nodes + boot_nodes

    def build(parents):
        seq_vars = _rev_in(parents[:len(seq_nodes)])
        static_vars = parents[len(seq_nodes):
                              len(seq_nodes) + len(static_nodes)]
        boot_vars = parents[len(seq_nodes) + len(static_nodes):]
        boot_of = {id(m): v for m, v in
                   zip([m for m in memories if m.boot_layer is not None],
                       boot_vars)}
        drnn = DynamicRNN()
        with drnn.block():
            seq_it = iter([drnn.step_input(v) for v in seq_vars])
            st_it = iter([drnn.static_input(v) for v in static_vars])
            bound_vars = []
            for i in ins:
                bound_vars.append(next(st_it) if isinstance(i, StaticInput)
                                  else next(seq_it))

            built, by_name, mem_vars = {}, {}, []

            def lbuild(n):
                key = id(n)
                if key in built:
                    return built[key]
                if isinstance(n, _Memory):
                    v = drnn.memory(init=boot_of.get(key),
                                    shape=None if key in boot_of
                                    else [n.size])
                    built[key] = v
                    mem_vars.append((n, v))
                    return v
                if hasattr(n, "_bound_slot"):
                    v = bound_vars[n._bound_slot]
                    built[key] = v
                    return v
                pv = [lbuild(p) for p in n.parents]
                with _unique_mod.guard(_NodeScopedGenerator(n.name)):
                    v = n._build(pv)
                built[key] = v
                by_name[n.name] = v
                return v

            outs = [lbuild(o) for o in out_nodes]
            mem_names_wanted = {m.name for m in memories}
            for n in step_nodes:
                if n.name in mem_names_wanted and n.name not in by_name:
                    lbuild(n)
            for m, mv in mem_vars:
                if m.name in by_name:
                    drnn.update_memory(mv, by_name[m.name])
                else:
                    raise ValueError(
                        f"memory(name={m.name!r}) has no same-named layer "
                        "in the step — the v1 recurrent link is by name")
            drnn.output(*outs)
        return _rev_out(drnn())

    return LayerOutput(name, "recurrent_group", parents_nodes,
                       size=out_nodes[0].size, build=build)


# ---------------------------------------------------------------------------
# step-level cells (LstmStepLayer / GruStepLayer parity) — used inside
# v1-style recurrent_group steps
# ---------------------------------------------------------------------------

def lstm_step_layer(input, state, size=None, act=None, gate_act=None,
                    state_act=None, bias_attr=None, name=None,
                    layer_attr=None):
    """One LSTM step on a pre-projected 4H gate input + cell-state memory.
    The hidden output is this node; the new cell state is exposed as
    ``get_output_layer(..., arg_name="state")`` (reference LstmStepLayer
    with two output args)."""
    name = name or _uniq("lstm_step")
    size = size or (state.size if state.size else input.size // 4)
    cell_holder = {}

    def build(parents):
        x4, c_prev = parents
        i, f, g, o = (F.slice(x4, axes=[1], starts=[k * size],
                              ends=[(k + 1) * size]) for k in range(4))
        i = _apply_act(i, gate_act or SigmoidActivation())
        f = _apply_act(f, gate_act or SigmoidActivation())
        g = _apply_act(g, act or TanhActivation())
        o = _apply_act(o, gate_act or SigmoidActivation())
        c = F.elementwise_add(F.elementwise_mul(f, c_prev),
                              F.elementwise_mul(i, g))
        h = F.elementwise_mul(
            o, _apply_act(c, state_act or TanhActivation()))
        cell_holder["c"] = c
        return h

    node = LayerOutput(name, "lstm_step", [input, state], size=size,
                       build=build)

    def build_cell(parents):
        if "c" not in cell_holder:
            raise ValueError("lstm_step cell requested before the step "
                             "node was built")
        return cell_holder["c"]

    cell = LayerOutput(name + "@cell", "lstm_step_cell", [node], size=size,
                       build=build_cell)
    node.extra["aux"] = {"state": cell}
    return node


def gru_step_layer(input, output_mem, size=None, act=None, name=None,
                   gate_act=None, bias_attr=None, param_attr=None,
                   layer_attr=None):
    """One GRU step on a pre-projected 3H input + hidden memory
    (GruStepLayer: the recurrent weight lives inside the step)."""
    name = name or _uniq("gru_step")
    size = size or input.size // 3

    def build(parents):
        x3, h_prev = parents
        from ..layers.misc import gru_unit as _gru_unit
        h, _r, _g = _gru_unit(
            input=x3, hidden=h_prev, size=3 * size,
            param_attr=ParameterAttribute.to_attr(param_attr),
            bias_attr=(False if bias_attr is False else
                       ParameterAttribute.to_attr(bias_attr)),
            activation=to_act_name(act) or "tanh",
            gate_activation=to_act_name(gate_act) or "sigmoid")
        return h

    return LayerOutput(name, "gru_step", [input, output_mem], size=size,
                       build=build)


gru_step_naive_layer = gru_step_layer


def recurrent_layer(input, act=None, bias_attr=None, param_attr=None,
                    name=None, reverse=False, layer_attr=None):
    """Plain full-matrix recurrence: out_t = act(in_t + W out_{t-1})
    (gserver RecurrentLayer)."""
    name = name or _uniq("recurrent")
    size = input.size

    def step(x):
        h = memory(name=name, size=size)
        proj = fc_layer(input=h, size=size, act=LinearActivation(),
                        param_attr=param_attr, bias_attr=bias_attr,
                        name=name + "@proj")
        s = addto_layer(input=[x, proj], act=act or TanhActivation(),
                        name=name)
        return s

    return recurrent_group(step, [input], name=name + "@group",
                           reverse=reverse)


# ---------------------------------------------------------------------------
# round-2 wrapper tail — the remaining *_layer surface of the reference DSL
# (trainer_config_helpers/layers.py).  Each is a thin lazy node over the
# fluid-style layers; sizes mirror LayerConfig.size semantics.
# ---------------------------------------------------------------------------

def _unary(kind, input, size=None, extra=None):
    """Shared one-parent node builder."""
    def deco(build):
        name = _uniq(kind)
        return LayerOutput(name, kind, [input],
                           size=size if size is not None else input.size,
                           build=build, extra=extra)
    return deco


def clip_layer(input, min, max, name=None):
    def build(parents):
        return F.clip(parents[0], min=float(min), max=float(max))
    return LayerOutput(name or _uniq("clip"), "clip", [input],
                       size=input.size, build=build)


def pad_layer(input, pad_c=None, pad_h=None, pad_w=None, name=None,
              layer_attr=None):
    """Pad along C/H/W of an image input (PadLayer)."""
    name = name or _uniq("pad")
    c, h, w = _img_meta(input)
    pc = pad_c or [0, 0]
    ph = pad_h or [0, 0]
    pw = pad_w or [0, 0]
    oc, oh, ow = c + sum(pc), h + sum(ph), w + sum(pw)

    def build(parents):
        v = parents[0]
        if v.shape and len(v.shape) == 2:
            v = F.reshape(v, [-1, c, h, w])
        return F.pad(v, paddings=[0, 0] + [pc[0], pc[1], ph[0], ph[1],
                                           pw[0], pw[1]])

    return LayerOutput(name, "pad", [input], size=oc * oh * ow, build=build,
                       extra={"channels": oc, "height": oh, "width": ow})


def crop_layer(input, offset, axis=2, shape=None, name=None,
               layer_attr=None):
    name = name or _uniq("crop")
    ins = _as_list(input)

    def build(parents):
        tgt_shape = shape
        if len(parents) > 1:
            return F.crop(parents[0], parents[1], offsets=offset)
        import numpy as _np
        ref = F.fill_constant(tgt_shape, "float32", 0.0)
        return F.crop(parents[0], ref, offsets=offset)

    return LayerOutput(name, "crop", ins, size=ins[0].size, build=build)


def maxout_layer(input, groups, num_channels=None, name=None,
                 layer_attr=None):
    name = name or _uniq("maxout")
    c, h, w = _img_meta(input)
    oc = c // groups

    def build(parents):
        v = parents[0]
        if v.shape and len(v.shape) == 2:
            v = F.reshape(v, [-1, c, h, w])
        return F.maxout(v, groups=groups)

    return LayerOutput(name, "maxout", [input], size=oc * h * w,
                       build=build,
                       extra={"channels": oc, "height": h, "width": w})


def prelu_layer(input, name=None, partial_sum=1, param_attr=None,
                layer_attr=None):
    name = name or _uniq("prelu")

    def build(parents):
        # reference PReluLayer: partial_sum=1 -> one alpha per element;
        # partial_sum=input.size -> one shared alpha; else per-channel
        if partial_sum == 1:
            mode = "element"
        elif input.size and partial_sum == input.size:
            mode = "all"
        else:
            mode = "channel"
        return F.prelu(parents[0], mode=mode,
                       param_attr=ParameterAttribute.to_attr(param_attr))

    return LayerOutput(name, "prelu", [input], size=input.size, build=build,
                       extra=dict(input.extra))


def multiplex_layer(input, name=None, layer_attr=None):
    """First input is the int index row-selector (MultiplexLayer)."""
    name = name or _uniq("multiplex")
    ins = _as_list(input)

    def build(parents):
        idx = F.cast(parents[0], "int32")
        return F.multiplex(inputs=parents[1:], index=idx)

    return LayerOutput(name, "multiplex", ins, size=ins[1].size, build=build)


def dot_prod_layer(input1, input2, name=None, layer_attr=None):
    name = name or _uniq("dot_prod")

    def build(parents):
        return F.reduce_sum(F.elementwise_mul(parents[0], parents[1]),
                            dim=-1, keep_dim=True)

    return LayerOutput(name, "dot_prod", [input1, input2], size=1,
                       build=build)


def out_prod_layer(input1, input2, name=None, layer_attr=None):
    """Row-wise outer product flattened (OuterProdLayer)."""
    name = name or _uniq("out_prod")
    size = input1.size * input2.size

    def build(parents):
        a, b = parents
        a3 = F.reshape(a, [-1, input1.size, 1])
        b3 = F.reshape(b, [-1, 1, input2.size])
        return F.reshape(F.matmul(a3, b3), [-1, size])

    return LayerOutput(name, "out_prod", [input1, input2], size=size,
                       build=build)


def l2_distance_layer(x, y, name=None, layer_attr=None):
    name = name or _uniq("l2_distance")

    def build(parents):
        d = F.elementwise_sub(parents[0], parents[1])
        return OPS.sqrt(F.reduce_sum(F.elementwise_mul(d, d), dim=-1,
                                     keep_dim=True))

    return LayerOutput(name, "l2_distance", [x, y], size=1, build=build)


def row_l2_norm_layer(input, name=None, layer_attr=None):
    name = name or _uniq("row_l2_norm")

    def build(parents):
        return F.l2_normalize(parents[0], axis=-1)

    return LayerOutput(name, "row_l2_norm", [input], size=input.size,
                       build=build)


def sum_to_one_norm_layer(input, name=None, layer_attr=None):
    name = name or _uniq("sum_to_one_norm")

    def build(parents):
        v = parents[0]
        s = F.reduce_sum(v, dim=-1, keep_dim=True)
        return F.elementwise_div(v, s)

    return LayerOutput(name, "sum_to_one_norm", [input], size=input.size,
                       build=build)


def scale_shift_layer(input, name=None, param_attr=None, bias_attr=None):
    """out = w*x + b with scalar learnable w, b (ScaleShiftLayer)."""
    name = name or _uniq("scale_shift")

    def build(parents):
        w = F.create_parameter([1], attr=ParameterAttribute.to_attr(
            param_attr))
        out = F.elementwise_mul(parents[0], w)
        if bias_attr is not False:
            b = F.create_parameter([1], attr=ParameterAttribute.to_attr(
                bias_attr), is_bias=True)
            out = F.elementwise_add(out, b)
        return out

    return LayerOutput(name, "scale_shift", [input], size=input.size,
                       build=build)


def resize_layer(input, size, name=None):
    """Reinterpret rows: [B, in] -> [B*in/size, size] (ResizeLayer)."""
    name = name or _uniq("resize")

    def build(parents):
        return F.reshape(parents[0], [-1, size])

    return LayerOutput(name, "resize", [input], size=size, build=build)


def rotate_layer(input, height, width, name=None, layer_attr=None):
    """90° CCW rotation of each [h, w] map (RotateLayer)."""
    name = name or _uniq("rotate")
    c = input.size // (height * width)

    def build(parents):
        v = F.reshape(parents[0], [-1, c, height, width])
        v = F.transpose(v, perm=[0, 1, 3, 2])
        v = F.reverse(v, axis=[2])
        return F.reshape(v, [-1, c * height * width])

    return LayerOutput(name, "rotate", [input], size=input.size,
                       build=build,
                       extra={"channels": c, "height": width,
                              "width": height})


def switch_order_layer(input, reshape_axis=None, name=None, layer_attr=None):
    """NCHW -> NHWC reorder (SwitchOrderLayer)."""
    name = name or _uniq("switch_order")
    c, h, w = _img_meta(input)

    def build(parents):
        v = parents[0]
        if v.shape and len(v.shape) == 2:
            v = F.reshape(v, [-1, c, h, w])
        return F.transpose(v, perm=[0, 2, 3, 1])

    return LayerOutput(name, "switch_order", [input], size=input.size,
                       build=build,
                       extra={"channels": c, "height": h, "width": w})


def repeat_layer(input, num_repeats, as_row_vector=True, act=None,
                 name=None, layer_attr=None):
    """Tile each row's features num_repeats times (FeatureMapExpandLayer)."""
    name = name or _uniq("repeat")

    def build(parents):
        v = parents[0]
        if as_row_vector:
            out = F.reshape(F.expand(F.reshape(v, [-1, 1, input.size]),
                                     expand_times=[1, num_repeats, 1]),
                            [-1, input.size * num_repeats])
        else:
            out = F.reshape(F.expand(F.reshape(v, [-1, input.size, 1]),
                                     expand_times=[1, 1, num_repeats]),
                            [-1, input.size * num_repeats])
        return _apply_act(out, act)

    return LayerOutput(name, "repeat", [input],
                       size=input.size * num_repeats, build=build)


def seq_reshape_layer(input, reshape_size, act=None, name=None,
                      layer_attr=None, bias_attr=None):
    name = name or _uniq("seq_reshape")

    def build(parents):
        out = F.sequence_reshape(parents[0], new_dim=reshape_size)
        return _apply_act(out, act)

    return LayerOutput(name, "seq_reshape", [input], size=reshape_size,
                       build=build)


def seq_slice_layer(input, starts, ends, name=None):
    name = name or _uniq("seq_slice")
    parents = [input] + [n for n in (starts, ends) if n is not None]

    def build(built):
        v = built[0]
        off = built[1] if starts is not None else None
        length = built[2] if ends is not None and starts is not None else (
            built[1] if ends is not None else None)
        return F.sequence_slice(v, offset=off, length=length)

    return LayerOutput(name, "seq_slice", parents, size=input.size,
                       build=build)


def sub_seq_layer(input, offsets, sizes, act=None, bias_attr=None,
                  name=None):
    name = name or _uniq("sub_seq")

    def build(parents):
        out = F.sequence_slice(parents[0], offset=parents[1],
                               length=parents[2])
        return _apply_act(out, act)

    return LayerOutput(name, "sub_seq", [input, offsets, sizes],
                       size=input.size, build=build)


def sub_nested_seq_layer(input, selected_indices, name=None):
    """Trim a nested sequence by selected sub-sequence indices (reference
    layers.py:7045, SubNestedSequenceLayer — beam-training helper).

    Padded-representation mapping: the v1 stack carries sequences as
    padded [B, T, ...] rows + @SEQ_LEN, so a NESTED sequence is the batch
    of its sub-sequences (one row per sub-sequence).  Selecting
    sub-sequences = gathering rows by `selected_indices`; the gather op
    rule carries each row's @SEQ_LEN along, so the output is the trimmed
    nested sequence in the same representation."""
    name = name or _uniq("sub_nested_seq")

    def build(parents):
        idx = parents[1]
        if (idx.shape and len(idx.shape) > 1):
            idx = F.reshape(idx, shape=[-1])
        return F.gather(parents[0], idx)

    return LayerOutput(name, "sub_nested_seq", [input, selected_indices],
                       size=input.size, build=build)


def kmax_seq_score_layer(input, name=None, beam_size=1):
    """Top-k scores over each sequence (KmaxSeqScoreLayer)."""
    name = name or _uniq("kmax_seq_score")

    def build(parents):
        v = parents[0]                     # [B, T, 1] per-step scores
        scores = F.squeeze(v, axes=[2])
        _vals, idx = F.topk(scores, k=beam_size)
        return idx

    return LayerOutput(name, "kmax_seq_score", [input], size=beam_size,
                       build=build)


def bilinear_interp_layer(input, out_size_x=None, out_size_y=None,
                          name=None, layer_attr=None):
    name = name or _uniq("bilinear_interp")
    c, h, w = _img_meta(input)

    def build(parents):
        v = parents[0]
        if v.shape and len(v.shape) == 2:
            v = F.reshape(v, [-1, c, h, w])
        return F.bilinear_interp(v, out_h=out_size_y, out_w=out_size_x)

    return LayerOutput(name, "bilinear_interp", [input],
                       size=c * out_size_x * out_size_y, build=build,
                       extra={"channels": c, "height": out_size_y,
                              "width": out_size_x})


def upsample_layer(input, name=None, scale=None, scale_y=None, upsample_size=None,
                   upsample_size_y=None, pad_out_x=False, pad_out_y=False):
    name = name or _uniq("upsample")
    c, h, w = _img_meta(input)
    oh = upsample_size_y or h * (scale_y or scale)
    ow = upsample_size or w * scale

    def build(parents):
        v = parents[0]
        if v.shape and len(v.shape) == 2:
            v = F.reshape(v, [-1, c, h, w])
        return F.bilinear_interp(v, out_h=oh, out_w=ow)

    return LayerOutput(name, "upsample", [input], size=c * oh * ow,
                       build=build,
                       extra={"channels": c, "height": oh, "width": ow})


def sampling_id_layer(input, name=None, layer_attr=None):
    name = name or _uniq("sampling_id")

    def build(parents):
        return F.sampling_id(parents[0])

    return LayerOutput(name, "sampling_id", [input], size=1, build=build)


def eos_layer(input, eos_id, name=None, layer_attr=None):
    """1 where the id equals eos_id (EosIdCheckLayer)."""
    name = name or _uniq("eos")

    def build(parents):
        ids = F.cast(parents[0], "int64")
        eos = F.fill_constant([1], "int64", eos_id)
        return F.cast(F.equal(ids, eos), "float32")

    return LayerOutput(name, "eos", [input], size=1, build=build)


def printer_layer(input, format=None, name=None):
    name = name or _uniq("printer")
    ins = _as_list(input)

    def build(parents):
        for v in parents:
            F.Print(v, message=format or name)
        return parents[0]

    return LayerOutput(name, "printer", ins, size=ins[0].size, build=build)


def linear_comb_layer(weights, vectors, size=None, name=None,
                      layer_attr=None):
    """Weighted combination of sub-vectors (LinearCombinationLayer):
    vectors rows are [size*k], weights rows [k]; out rows [size]."""
    name = name or _uniq("linear_comb")
    k = weights.size
    size = size or vectors.size // k

    def build(parents):
        w, v = parents
        v3 = F.reshape(v, [-1, k, size])
        w3 = F.reshape(w, [-1, 1, k])
        return F.reshape(F.matmul(w3, v3), [-1, size])

    return LayerOutput(name, "linear_comb", [weights, vectors], size=size,
                       build=build)


def tensor_layer(a, b, size, act=None, name=None, param_attr=None,
                 bias_attr=None, layer_attr=None):
    """out_k = a^T W_k b (TensorLayer = bilinear tensor product)."""
    name = name or _uniq("tensor")

    def build(parents):
        x, y = parents
        out = F.bilinear_tensor_product(
            x, y, size=size,
            param_attr=ParameterAttribute.to_attr(param_attr),
            bias_attr=False if bias_attr is False else
            ParameterAttribute.to_attr(bias_attr))
        return _apply_act(out, act)

    return LayerOutput(name, "tensor", [a, b], size=size, build=build)


def gated_unit_layer(input, size, act=None, name=None, gate_attr=None,
                     gate_param_attr=None, gate_bias_attr=None,
                     inproj_attr=None, inproj_param_attr=None,
                     inproj_bias_attr=None, layer_attr=None):
    """GLU: act(Wx) * sigmoid(Vx) (GatedRecurrentUnit-style gate)."""
    name = name or _uniq("gated_unit")

    def build(parents):
        v = parents[0]
        proj = F.fc(input=v, size=size,
                    param_attr=ParameterAttribute.to_attr(inproj_param_attr))
        proj = _apply_act(proj, act or TanhActivation())
        gate = F.fc(input=v, size=size,
                    param_attr=ParameterAttribute.to_attr(gate_param_attr))
        gate = OPS.sigmoid(gate)
        return F.elementwise_mul(proj, gate)

    return LayerOutput(name, "gated_unit", [input], size=size, build=build)


def factorization_machine(input, factor_size, act=None, name=None,
                          param_attr=None, layer_attr=None):
    """FM second-order term: 0.5 * sum((xV)^2 - (x^2)(V^2))
    (FactorizationMachineLayer)."""
    name = name or _uniq("fm")

    def build(parents):
        x = parents[0]
        v = F.create_parameter([input.size, factor_size],
                               attr=ParameterAttribute.to_attr(param_attr))
        xv = F.matmul(x, v)                      # [B, factor]
        x2 = F.elementwise_mul(x, x)
        v2 = F.elementwise_mul(v, v)
        x2v2 = F.matmul(x2, v2)
        out = F.scale(F.reduce_sum(
            F.elementwise_sub(F.elementwise_mul(xv, xv), x2v2),
            dim=-1, keep_dim=True), scale=0.5)
        return _apply_act(out, act)

    return LayerOutput(name, "fm", [input], size=1, build=build)


def selective_fc_layer(input, size, select=None, act=None, name=None,
                       pass_generation=False, has_selected_colums=True,
                       mul_ratio=0.02, param_attr=None, bias_attr=None,
                       layer_attr=None):
    """Full fc fallback: column selection is a serving-time optimization in
    the reference (SelectiveFullyConnectedLayer); results are identical."""
    name = name or _uniq("selective_fc")
    node = fc_layer(input=input, size=size, act=act, param_attr=param_attr,
                    bias_attr=bias_attr, name=name)
    return node


def conv_shift_layer(a, b, name=None, layer_attr=None):
    name = name or _uniq("conv_shift")

    def build(parents):
        return F.conv_shift(parents[0], parents[1])

    return LayerOutput(name, "conv_shift", [a, b], size=a.size, build=build)


def row_conv_layer(input, context_len, act=None, name=None, param_attr=None,
                   layer_attr=None):
    name = name or _uniq("row_conv")

    def build(parents):
        out = F.row_conv(parents[0], future_context_size=context_len - 1,
                         param_attr=ParameterAttribute.to_attr(param_attr))
        return _apply_act(out, act)

    return LayerOutput(name, "row_conv", [input], size=input.size,
                       build=build)


def block_expand_layer(input, block_x=0, block_y=0, stride_x=1, stride_y=1,
                       padding_x=0, padding_y=0, num_channels=None,
                       name=None, layer_attr=None):
    """conv patches -> sequence (BlockExpandLayer = im2sequence)."""
    name = name or _uniq("block_expand")
    c = num_channels or _img_meta(input)[0]
    size = c * block_x * block_y

    def build(parents):
        v = parents[0]
        if v.shape and len(v.shape) == 2:
            cc, h, w = _img_meta(input)
            v = F.reshape(v, [-1, cc, h, w])
        return F.im2sequence(v, filter_size=[block_y, block_x],
                             stride=[stride_y, stride_x],
                             padding=[padding_y, padding_x, padding_y,
                                      padding_x])

    return LayerOutput(name, "block_expand", [input], size=size,
                       build=build)


def spp_layer(input, name=None, num_channels=None, pool_type=None,
              pyramid_height=None, layer_attr=None):
    name = name or _uniq("spp")
    c = num_channels or _img_meta(input)[0]
    ptype = to_pool_name(pool_type, default="max")
    size = c * sum((2 ** i) ** 2 for i in range(pyramid_height))

    def build(parents):
        v = parents[0]
        if v.shape and len(v.shape) == 2:
            cc, h, w = _img_meta(input)
            v = F.reshape(v, [-1, cc, h, w])
        return F.spp(v, pyramid_height=pyramid_height,
                     pool_type="avg" if ptype == "average" else ptype)

    return LayerOutput(name, "spp", [input], size=size, build=build)


def roi_pool_layer(input, rois, pooled_width, pooled_height, spatial_scale,
                   num_channels=None, name=None):
    name = name or _uniq("roi_pool")
    c = num_channels or _img_meta(input)[0]
    size = c * pooled_width * pooled_height

    def build(parents):
        v = parents[0]
        if v.shape and len(v.shape) == 2:
            cc, h, w = _img_meta(input)
            v = F.reshape(v, [-1, cc, h, w])
        return F.roi_pool(v, parents[1], pooled_height=pooled_height,
                          pooled_width=pooled_width,
                          spatial_scale=spatial_scale)

    return LayerOutput(name, "roi_pool", [input, rois], size=size,
                       build=build)


def img_conv3d_layer(input, filter_size, num_filters, name=None,
                     num_channels=None, act=None, groups=1, stride=1,
                     padding=0, bias_attr=None, param_attr=None,
                     shared_biases=True, layer_attr=None, trans=False):
    name = name or _uniq("conv3d")

    def build(parents):
        return F.conv3d(parents[0], num_filters=num_filters,
                        filter_size=filter_size, stride=stride,
                        padding=padding, groups=groups,
                        act=to_act_name(act),
                        param_attr=ParameterAttribute.to_attr(param_attr),
                        bias_attr=ParameterAttribute.to_attr(bias_attr)
                        if bias_attr is not None else None)

    return LayerOutput(name, "conv3d", [input], size=num_filters,
                       build=build)


def img_pool3d_layer(input, pool_size, name=None, num_channels=None,
                     pool_type=None, stride=1, padding=0, layer_attr=None,
                     pool_size_y=None, stride_y=None, padding_y=None,
                     pool_size_z=None, stride_z=None, padding_z=None,
                     ceil_mode=True):
    name = name or _uniq("pool3d")
    ptype = to_pool_name(pool_type, default="max")

    def build(parents):
        return F.pool3d(parents[0], pool_size=pool_size,
                        pool_type="avg" if ptype == "average" else ptype,
                        pool_stride=stride, pool_padding=padding)

    return LayerOutput(name, "pool3d", [input], size=input.size,
                       build=build)


# ---------------------------------------------------------------------------
# cost tail
# ---------------------------------------------------------------------------

def rank_cost(left, right, label, weight=None, name=None, coeff=1.0,
              layer_attr=None):
    name = name or _uniq("rank_cost")

    def build(parents):
        out = F.mean(F.rank_loss(label=parents[2], left=parents[0],
                                 right=parents[1]))
        return F.scale(out, scale=float(coeff)) if coeff != 1.0 else out

    return LayerOutput(name, "rank_cost", [left, right, label], size=1,
                       build=build)


def lambda_cost(input, score, name=None, NDCG_num=5, max_sort_size=-1,
                layer_attr=None):
    """LambdaRank listwise cost (LambdaCost): pairwise logistic weighted by
    |ΔNDCG| within each sequence."""
    name = name or _uniq("lambda_cost")

    def build(parents):
        s, y = parents[0], parents[1]            # scores, relevance [B, T]
        sd = F.elementwise_sub(F.reshape(s, [0, -1, 1]),
                               F.reshape(s, [0, 1, -1]))
        yd = F.elementwise_sub(F.reshape(y, [0, -1, 1]),
                               F.reshape(y, [0, 1, -1]))
        pref = F.cast(OPS.sign(yd), "float32")
        pair = OPS.softplus(F.scale(F.elementwise_mul(pref, sd),
                                    scale=-1.0))
        gain = OPS.abs(yd)                       # |Δrelevance| ≈ |ΔNDCG| gain
        return F.mean(F.elementwise_mul(pair, gain))

    return LayerOutput(name, "lambda_cost", [input, score], size=1,
                       build=build)


def huber_regression_cost(input, label, name=None, delta=1.0, coeff=1.0,
                          layer_attr=None):
    name = name or _uniq("huber_regression")

    def build(parents):
        out = F.mean(F.huber_loss(parents[0], parents[1], delta=delta))
        return F.scale(out, scale=float(coeff)) if coeff != 1.0 else out

    return LayerOutput(name, "huber_regression", [input, label], size=1,
                       build=build)


def huber_classification_cost(input, label, name=None, coeff=1.0,
                              layer_attr=None):
    """Modified-huber on ±1 labels (HuberTwoClassification)."""
    name = name or _uniq("huber_classification")

    def build(parents):
        pred, lab = parents
        y = F.scale(F.cast(lab, "float32"), scale=2.0, bias=-1.0)  # {0,1}→±1
        z = F.elementwise_mul(pred, y)
        sq = OPS.square(F.clip(F.scale(z, scale=-1.0, bias=1.0),
                               min=0.0, max=1e30))
        lin = F.scale(z, scale=-4.0)
        out = F.mean(_modified_huber(z, sq, lin))
        return F.scale(out, scale=float(coeff)) if coeff != 1.0 else out

    return LayerOutput(name, "huber_classification", [input, label], size=1,
                       build=build)


def _modified_huber(z, sq, lin):
    # z >= -1: max(0, 1-z)^2 ; else: -4z
    cond = F.cast(F.less_than(F.scale(z, scale=-1.0), F.fill_constant(
        [1], "float32", 1.0)), "float32")        # 1 where z > -1
    return F.elementwise_add(F.elementwise_mul(sq, cond),
                             F.elementwise_mul(lin, F.scale(
                                 cond, scale=-1.0, bias=1.0)))


def smooth_l1_cost(input, label, name=None, coeff=1.0, layer_attr=None):
    name = name or _uniq("smooth_l1")

    def build(parents):
        out = F.mean(F.smooth_l1(parents[0], parents[1]))
        return F.scale(out, scale=float(coeff)) if coeff != 1.0 else out

    return LayerOutput(name, "smooth_l1", [input, label], size=1,
                       build=build)


def multi_binary_label_cross_entropy(input, label, name=None, coeff=1.0,
                                     layer_attr=None):
    """Element-wise binary CE on probability inputs (sigmoid outputs)."""
    name = name or _uniq("multi_binary_ce")

    def build(parents):
        p, y = parents
        p = F.clip(p, min=1e-7, max=1.0 - 1e-7)
        y = F.cast(y, "float32")
        ce = F.scale(F.elementwise_add(
            F.elementwise_mul(y, OPS.log(p)),
            F.elementwise_mul(F.scale(y, scale=-1.0, bias=1.0),
                              OPS.log(F.scale(p, scale=-1.0, bias=1.0)))),
            scale=-1.0)
        out = F.mean(F.reduce_sum(ce, dim=-1))
        return F.scale(out, scale=float(coeff)) if coeff != 1.0 else out

    return LayerOutput(name, "multi_binary_ce", [input, label], size=1,
                       build=build)


def cross_entropy_with_selfnorm(input, label, name=None, coeff=1.0,
                                softmax_selfnorm_alpha=0.1,
                                layer_attr=None):
    """CE + alpha*log(Z)^2 on logit inputs (SelfNormCostLayer)."""
    name = name or _uniq("ce_selfnorm")

    def build(parents):
        logits, lab = parents
        p = F.softmax(logits)
        ce = F.mean(F.cross_entropy(input=p, label=lab))
        logz = OPS.log(F.reduce_sum(OPS.exp(logits), dim=-1, keep_dim=True))
        out = F.elementwise_add(ce, F.scale(F.mean(OPS.square(logz)),
                                            scale=softmax_selfnorm_alpha))
        return F.scale(out, scale=float(coeff)) if coeff != 1.0 else out

    return LayerOutput(name, "ce_selfnorm", [input, label], size=1,
                       build=build)


def nce_layer(input, label, num_classes=None, act=None, param_attr=None,
              weight=None, num_neg_samples=10, neg_distribution=None,
              bias_attr=None, name=None, layer_attr=None):
    name = name or _uniq("nce")
    ins = _as_list(input)

    def build(parents):
        v = parents[0] if len(parents) == 2 else F.concat(parents[:-1],
                                                          axis=-1)
        return F.nce(input=v, label=parents[-1],
                     num_total_classes=num_classes,
                     num_neg_samples=num_neg_samples,
                     param_attr=ParameterAttribute.to_attr(param_attr),
                     bias_attr=ParameterAttribute.to_attr(bias_attr)
                     if bias_attr is not None else None)

    return LayerOutput(name, "nce", ins + [label], size=1, build=build)


def hsigmoid(input, label, num_classes=None, name=None, bias_attr=None,
             param_attr=None, layer_attr=None):
    name = name or _uniq("hsigmoid")
    ins = _as_list(input)

    def build(parents):
        v = parents[0] if len(parents) == 2 else F.concat(parents[:-1],
                                                          axis=-1)
        return F.mean(F.hsigmoid(
            v, parents[-1], num_classes=num_classes,
            param_attr=ParameterAttribute.to_attr(param_attr),
            bias_attr=False if bias_attr is False else
            ParameterAttribute.to_attr(bias_attr)))

    return LayerOutput(name, "hsigmoid", ins + [label], size=1, build=build)


# ---------------------------------------------------------------------------
# detection tail
# ---------------------------------------------------------------------------

def priorbox_layer(input, image, aspect_ratio, variance, min_size,
                   max_size=[], name=None):
    name = name or _uniq("priorbox")

    holder = {}

    def build(parents):
        boxes, vars_ = F.prior_box(
            parents[0], parents[1], min_sizes=list(min_size),
            max_sizes=list(max_size) or None,
            aspect_ratios=list(aspect_ratio), variance=list(variance))
        # [H, W, P, 4] -> flat [M, 4], the layout the coder/NMS consume
        holder["variances"] = F.reshape(vars_, [-1, 4])
        return F.reshape(boxes, [-1, 4])

    node = LayerOutput(name, "priorbox", [input, image], size=4,
                       build=build)

    def build_var(parents):
        if "variances" not in holder:
            raise ValueError("priorbox variances requested before the "
                             "priorbox node was built")
        return holder["variances"]

    var_node = LayerOutput(name + "@variances", "priorbox_var", [node],
                           size=4, build=build_var)
    node.extra["aux"] = {"variances": var_node}
    return node


def cross_channel_norm_layer(input, name=None, param_attr=None):
    """L2 norm across channels with a learned per-channel scale
    (CrossChannelNormLayer, the SSD conv4_3 norm)."""
    name = name or _uniq("cross_channel_norm")
    c, h, w = _img_meta(input)

    def build(parents):
        v = parents[0]
        if v.shape and len(v.shape) == 2:
            v = F.reshape(v, [-1, c, h, w])
        normed = F.l2_normalize(v, axis=1)
        scale = F.create_parameter(
            [c], attr=ParameterAttribute.to_attr(param_attr))
        return F.elementwise_mul(normed, F.reshape(scale, [1, c, 1, 1]))

    return LayerOutput(name, "cross_channel_norm", [input], size=input.size,
                       build=build, extra=dict(input.extra))


def multibox_loss_layer(input_loc, input_conf, priorbox, label, num_classes,
                        overlap_threshold=0.5, neg_pos_ratio=3.0,
                        neg_overlap=0.5, background_id=0, name=None):
    name = name or _uniq("multibox_loss")
    locs = _as_list(input_loc)
    confs = _as_list(input_conf)

    pb_var = (priorbox.extra or {}).get("aux", {}).get("variances")
    extra_parents = [pb_var] if pb_var is not None else []

    def build(parents):
        nl = len(locs)
        loc = parents[0] if nl == 1 else F.concat(parents[:nl], axis=1)
        conf = (parents[nl] if len(confs) == 1
                else F.concat(parents[nl:nl + len(confs)], axis=1))
        pb = parents[nl + len(confs)]
        gt_box = parents[nl + len(confs) + 1]
        gt_label = parents[nl + len(confs) + 2]
        pbv = parents[-1] if pb_var is not None else None
        return F.mean(F.ssd_loss(
            loc, conf, gt_box, gt_label, pb, prior_box_var=pbv,
            overlap_threshold=overlap_threshold,
            neg_pos_ratio=neg_pos_ratio,
            background_label=background_id))

    # v1 passes one `label` carrying boxes+labels; here the node's label
    # input must be the gt box layer and carry the labels via extra
    # ("aux": {"labels": node}) or be a 2-tuple (gt_box, gt_label)
    if isinstance(label, (list, tuple)) and len(label) == 2:
        gt_nodes = list(label)
    else:
        aux = (label.extra or {}).get("aux", {})
        gt_nodes = [label, aux.get("labels", label)]
    return LayerOutput(name, "multibox_loss",
                       locs + confs + [priorbox] + gt_nodes + extra_parents,
                       size=1, build=build)


def detection_output_layer(input_loc, input_conf, priorbox, num_classes,
                           nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                           confidence_threshold=0.01, background_id=0,
                           name=None):
    name = name or _uniq("detection_output")
    locs = _as_list(input_loc)
    confs = _as_list(input_conf)

    pb_var = (priorbox.extra or {}).get("aux", {}).get("variances")

    def build(parents):
        nl = len(locs)
        loc = parents[0] if nl == 1 else F.concat(parents[:nl], axis=1)
        conf = (parents[nl] if len(confs) == 1
                else F.concat(parents[nl:nl + len(confs)], axis=1))
        pb = parents[nl + len(confs)]
        if pb_var is not None:
            pbv = parents[-1]
        else:
            # default SSD variances when the prior box has none attached
            pbv = F.elementwise_add(_fill_zeros_like(pb),
                                    F.fill_constant([4], "float32", 0.1))
        return F.detection_output(
            loc, conf, pb, pbv, nms_threshold=nms_threshold,
            nms_top_k=nms_top_k, keep_top_k=keep_top_k,
            score_threshold=confidence_threshold,
            background_label=background_id)

    parents_all = locs + confs + [priorbox] + (
        [pb_var] if pb_var is not None else [])
    return LayerOutput(name, "detection_output", parents_all,
                       size=7, build=build)


# ---------------------------------------------------------------------------
# projection / operator tail for mixed_layer
# ---------------------------------------------------------------------------

def dotmul_projection(input, param_attr=None):
    """out = x .* w with a learned weight vector (DotMulProjection)."""
    def build(v):
        w = F.create_parameter([input.size],
                               attr=ParameterAttribute.to_attr(param_attr))
        return F.elementwise_mul(v, w)
    return _Projection(input, build, input.size)


def scaling_projection(input, param_attr=None):
    """out = w * x with ONE learned scalar (ScalingProjection)."""
    def build(v):
        w = F.create_parameter([1],
                               attr=ParameterAttribute.to_attr(param_attr))
        return F.elementwise_mul(v, w)
    return _Projection(input, build, input.size)


def trans_full_matrix_projection(input, size=0, param_attr=None):
    """out = x W^T (TransposedFullMatrixProjection)."""
    def build(v):
        w = F.create_parameter([size, input.size],
                               attr=ParameterAttribute.to_attr(param_attr))
        return F.matmul(v, w, transpose_y=True)
    return _Projection(input, build, size)


def slice_projection(input, slices):
    """Concatenate [begin, end) feature slices (SliceProjection)."""
    size = sum(e - b for b, e in slices)

    def build(v):
        last = len(v.shape) - 1 if v.shape else 1
        parts = [F.slice(v, axes=[last], starts=[b], ends=[e])
                 for b, e in slices]
        return parts[0] if len(parts) == 1 else F.concat(parts, axis=-1)
    return _Projection(input, build, size)


def context_projection(input, context_len, context_start=None,
                       padding_attr=False):
    """Concat a [start, start+len) window of neighbor steps per position
    (ContextProjection — the weightless core of sequence_conv)."""
    start = context_start if context_start is not None \
        else -(context_len // 2)
    size = input.size * context_len

    def build(v):
        # v: [B, T, D] padded sequence; metadata shapes may be symbolic,
        # so window bounds use negative ends (numpy semantics)
        parts = []
        for i in range(context_len):
            off = start + i
            if off < 0:
                shifted = F.pad(v, paddings=[0, 0, -off, 0, 0, 0])
                shifted = F.slice(shifted, axes=[1], starts=[0],
                                  ends=[off])
            elif off > 0:
                shifted = F.pad(v, paddings=[0, 0, 0, off, 0, 0])
                shifted = F.slice(shifted, axes=[1], starts=[off],
                                  ends=[10 ** 9])
            else:
                shifted = v
            parts.append(shifted)
        return F.concat(parts, axis=-1)
    return _Projection(input, build, size)


def conv_projection(input, filter_size, num_filters, num_channels=None,
                    stride=1, padding=0, groups=1, param_attr=None,
                    trans=False):
    """Learned conv as a projection (ConvProjection)."""
    c, h, w = _img_meta(input)

    def build(v):
        if v.shape and len(v.shape) == 2:
            v = F.reshape(v, [-1, c, h, w])
        return (F.conv2d_transpose if trans else F.conv2d)(
            v, num_filters=num_filters, filter_size=filter_size,
            stride=stride, padding=padding,
            param_attr=ParameterAttribute.to_attr(param_attr))
    oh, ow = _out_hw(h, w, filter_size, stride, padding)
    return _Projection(input, build, num_filters * oh * ow)


class _Operator(object):
    """Two-input mixed_layer element (reference Operator: no parameters)."""

    def __init__(self, inputs, build, size):
        self.inputs = list(inputs)
        self.build = build
        self.size = size


def dotmul_operator(a=None, b=None, scale=1.0):
    def build(va, vb):
        out = F.elementwise_mul(va, vb)
        return F.scale(out, scale=float(scale)) if scale != 1.0 else out
    return _Operator([a, b], build, a.size)


def conv_operator(img, filter, filter_size, num_filters, num_channels=None,
                  stride=1, padding=0, filter_size_y=None, stride_y=None,
                  padding_y=None):
    """Convolve the image input with a DYNAMIC filter computed by another
    layer (ConvOperator); the filter layer supplies one shared kernel."""
    c, h, w = _img_meta(img) if img.extra.get("channels") else (
        num_channels, None, None)
    ky = filter_size_y or filter_size
    oh, ow = _out_hw(h, w, filter_size, stride, padding)

    def build(vi, vf):
        from ..layer_helper import LayerHelper
        if vi.shape and len(vi.shape) == 2:
            vi = F.reshape(vi, [-1, c, h, w])
        filt = F.reshape(vf, [num_filters, c, ky, filter_size])
        helper = LayerHelper("conv2d", input=vi)
        out = helper.create_variable_for_type_inference(vi.dtype)
        helper.append_op(type="conv2d",
                         inputs={"Input": [vi], "Filter": [filt]},
                         outputs={"Output": [out]},
                         attrs={"strides": [stride, stride],
                                "paddings": [padding, padding],
                                "dilations": [1, 1], "groups": 1})
        return out
    return _Operator([img, filter], build, num_filters * oh * ow)


def layer_support(*attrs):
    """API-parity decorator (reference layer_support wraps layers to check
    ExtraLayerAttribute support); attribute checking is a no-op here."""
    def deco(fn):
        return fn
    return deco


def beam_search(step, input, bos_id, eos_id, beam_size, max_length=500,
                name=None, num_results_per_sample=None):
    """v1 generation-mode recurrent_group (reference layers.py:4485 /
    RecurrentGradientMachine::beamSearch :309), ADAPTED onto the fluid
    beam machinery: the v1 ``step`` (memory() + v1 layers, GeneratedInput
    feeding back the last word through a shared embedding) is traced the
    same way recurrent_group traces it, then lowered into a StaticRNN
    whose body runs the step graph once per generation step and the
    layers.beam_search / beam_search_decode ops do the pruning + backtrace
    (models/seq2seq.py is_generating is the same pattern hand-written).

    Returns the generated word-id sequences ([B*beam, max_len] padded ids
    with @SEQ_LEN, best beam first per sample); the per-beam scores ride
    in ``extra['aux']['scores']``."""
    name = name or _uniq("beam_search")
    if num_results_per_sample is None:
        num_results_per_sample = beam_size
    ins = _as_list(input)
    gen_idx = [i for i, n in enumerate(ins)
               if isinstance(n, BaseGeneratedInput)]
    assert len(gen_idx) == 1, "beam_search needs exactly one GeneratedInput"
    gipt = ins[gen_idx[0]]
    gipt.bos_id, gipt.eos_id = bos_id, eos_id
    static_ins = [n for n in ins if isinstance(n, StaticInput)]
    assert len(static_ins) + 1 == len(ins), (
        "beam_search inputs must be StaticInput/GeneratedInput only")

    # trace the step exactly like recurrent_group: bound placeholders for
    # every input; memories + boot layers discovered from the result graph
    bound = []
    for n in ins:
        if isinstance(n, BaseGeneratedInput):
            b = LayerOutput(_uniq("gen_word") + "@step", "step_input", [],
                            size=n.embedding_size)
        else:
            b = LayerOutput(n.input.name + "@step", "step_input", [],
                            size=n.size)
        b._bound_slot = len(bound)
        bound.append(b)
    _CREATION_HOOK.append([])
    try:
        result = step(*bound)
    finally:
        step_nodes = _CREATION_HOOK.pop()
    out_node = _as_list(result)[0]          # per-step word distribution

    memories, seen = [], set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, _Memory):
            memories.append(n)
            return
        for p in n.parents:
            walk(p)

    walk(out_node)
    for n in step_nodes:
        walk(n)
    boot_nodes = [m.boot_layer for m in memories
                  if m.boot_layer is not None]
    parents_nodes = [s.input for s in static_ins] + boot_nodes

    def build(parents):
        static_vars = parents[:len(static_ins)]
        boot_vars = parents[len(static_ins):]
        boot_of = {id(m): v for m, v in
                   zip([m for m in memories if m.boot_layer is not None],
                       boot_vars)}
        # beam expansion: every per-sample tensor becomes [B*beam, ...]
        statics = [F.repeat_batch(v, beam_size) for v in static_vars]
        ref = statics[0] if statics else None
        boots = {k: F.repeat_batch(v, beam_size)
                 for k, v in boot_of.items()}
        if ref is None:
            if not boots:
                raise ValueError(
                    "beam_search needs at least one StaticInput or one "
                    "memory(boot_layer=...) to establish the batch size "
                    "(zero-boot memories alone carry no batch dimension)")
            ref = next(iter(boots.values()))
        tok_init = F.fill_constant_batch_size_like(
            input=ref, value=float(bos_id), shape=[-1, 1], dtype="int64")
        fin_init = F.fill_constant_batch_size_like(
            input=ref, value=0.0, shape=[-1, 1], dtype="float32")
        score_init = F.beam_init_scores(ref, beam_size)
        steps = F.fill_constant_batch_size_like(
            input=ref, value=0.0, shape=[-1, max_length], dtype="float32")

        rnn = F.StaticRNN()
        with rnn.block():
            rnn.step_input(steps)                  # drives max_length
            tok = rnn.memory(init=tok_init)
            score = rnn.memory(init=score_init)
            fin = rnn.memory(init=fin_init)
            static_step = [rnn.static_input(v) for v in statics]
            mem_vars = {}
            for m in memories:
                if id(m) in boots:
                    mem_vars[id(m)] = rnn.memory(init=boots[id(m)])
                else:
                    mem_vars[id(m)] = rnn.memory(
                        init=F.fill_constant_batch_size_like(
                            input=ref, value=0.0, shape=[-1, m.size],
                            dtype="float32"))
            emb = F.embedding(input=tok,
                              size=[gipt.size, gipt.embedding_size],
                              param_attr=gipt.embedding_name)

            built, by_name = {}, {}
            st_iter = iter(static_step)
            bound_vars = []
            for n in ins:
                bound_vars.append(emb if isinstance(n, BaseGeneratedInput)
                                  else next(st_iter))

            def lbuild(n):
                key = id(n)
                if key in built:
                    return built[key]
                if isinstance(n, _Memory):
                    v = mem_vars[key]
                    built[key] = v
                    return v
                if hasattr(n, "_bound_slot"):
                    v = bound_vars[n._bound_slot]
                    built[key] = v
                    return v
                pv = [lbuild(p) for p in n.parents]
                with _unique_mod.guard(_NodeScopedGenerator(n.name)):
                    v = n._build(pv)
                built[key] = v
                by_name[n.name] = v
                return v

            probs = lbuild(out_node)
            for n in step_nodes:
                if n.name in {m.name for m in memories} \
                        and n.name not in by_name:
                    lbuild(n)
            ids, scores, parents_idx, finished = F.beam_search(
                score, probs, fin, beam_size, end_id=eos_id)
            rnn.update_memory(tok, ids)
            rnn.update_memory(score, scores)
            rnn.update_memory(fin, finished)
            for m in memories:
                if m.name not in by_name:
                    raise ValueError(
                        f"memory(name={m.name!r}) has no same-named "
                        "layer in the beam_search step")
                new_m = F.gather(by_name[m.name], parents_idx)
                rnn.update_memory(mem_vars[id(m)], new_m)
            rnn.output(ids, F.cast(parents_idx, "int32"), scores)

        ids_seq, parents_seq, scores_seq = rnn()
        final_scores = F.sequence_pool(scores_seq, "last")
        sent_ids, sent_scores = F.beam_search_decode(
            ids_seq, parents_seq, final_scores, beam_size, eos_id,
            num_results=num_results_per_sample)
        aux_holder["scores"] = sent_scores
        return sent_ids

    aux_holder = {}
    node = LayerOutput(name, "beam_search", parents_nodes, size=1,
                       build=build)
    scores_node = LayerOutput(
        name + "@scores", "beam_search_scores", [node], size=1,
        build=lambda parents: aux_holder["scores"])
    node.extra["aux"] = {"scores": scores_node}
    return node


class BeamInput(object):
    """One beam expansion for cross_entropy_over_beam (reference
    layers.py:6441): candidate_scores (nested sequence of scalar scores),
    selected_candidates (kmax_seq_score_layer output, -1 padded), and
    gold (the ground-truth candidate's index in its sub-sequence)."""

    def __init__(self, candidate_scores, selected_candidates, gold):
        assert isinstance(candidate_scores, LayerOutput)
        assert candidate_scores.size == 1
        assert isinstance(selected_candidates, LayerOutput)
        assert isinstance(gold, LayerOutput)
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


def cross_entropy_over_beam(input, name=None):
    """Learning-to-search beam-training cost (reference layers.py:6465 +
    gserver CrossEntropyOverBeam.cpp).  Takes BeamInput triples — one per
    search-step expansion — and computes cross entropy over the expanded
    candidate paths with all candidates in the beam as the normalization
    factor; if the gold falls off the beam at step t, the cost is taken
    over the beam at step t with the gold appended as an extra path.
    Lowers to this framework's `cross_entropy_over_beam` fluid op
    (ops/beam_ops.py — host-side path construction, custom VJP), matching
    the reference's CPU-pinned layer."""
    if isinstance(input, BeamInput):
        input = [input]
    assert input and all(isinstance(b, BeamInput) for b in input), (
        "input for cross_entropy_over_beam should be BeamInput objects")
    name = name or _uniq("cross_entropy_over_beam")
    parents = []
    for b in input:
        parents += [b.candidate_scores, b.selected_candidates, b.gold]

    def build(built):
        from ..layer_helper import LayerHelper
        scores = built[0::3]
        ids = built[1::3]
        golds = built[2::3]
        helper = LayerHelper("cross_entropy_over_beam", input=scores[0])
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(
            type="cross_entropy_over_beam",
            inputs={"Scores": list(scores), "Ids": list(ids),
                    "Gold": list(golds)},
            outputs={"Out": [out]})
        out.desc.shape = [golds[0].shape[0]
                          if golds[0].shape else -1, 1]
        return F.mean(out)

    return LayerOutput(name, "cross_entropy_over_beam", parents, size=1,
                       build=build)


def scale_sub_region_layer(input, indices, value, name=None):
    """Multiply `value` over a per-sample CHW sub-box (reference layers.py
    scale_sub_region_layer; indices rows are 1-based
    [C_Start, C_End, H_Start, H_End, W_Start, W_End])."""
    assert isinstance(value, float), "value must be a real value"
    name = name or _uniq("scale_sub_region")

    def build(built):
        from ..layer_helper import LayerHelper
        x, idx = built
        meta = input.extra or {}
        shape = x.shape
        if len(shape) == 2 and meta.get("height"):
            x = F.reshape(x, [-1, meta["channels"], meta["height"],
                              meta["width"]])
        helper = LayerHelper("scale_sub_region", input=x)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type="scale_sub_region",
                         inputs={"X": [x], "Indices": [idx]},
                         outputs={"Out": [out]},
                         attrs={"value": float(value)})
        out.desc.shape = x.shape
        if len(shape) == 2 and meta.get("height"):
            out = F.reshape(out, [-1, shape[1]])
        return out

    return LayerOutput(name, "scale_sub_region", [input, indices],
                       size=input.size, build=build,
                       extra=dict(input.extra or {}))
