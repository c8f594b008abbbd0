"""Detection layers (counterpart of ``paddle_tpu/layers/detection.py``):
prior_box, iou_similarity, box_coder, bipartite_match, target_assign,
multiclass_nms, detection_output, detection_map, ssd_loss and
multi_box_head, building the same program JSON as the JAX layers.

Two contracts are the JAX package's and stay so: ``ssd_loss`` is the
loss of ONE image (``location`` ``[M, 4]``, ``confidence`` ``[1, M, C]``
to match ``target_assign``'s ``[1, M, 1]`` labels; a batch is built as
one ``ssd_loss`` per ``layers.split`` slice) and it takes
``neg_pos_ratio``, ``mining_type`` and ``normalize`` without using them
(no hard-negative mining: the confidence loss covers every prior);
``multiclass_nms`` takes ``normalized`` and ``nms_eta`` without using
them.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper
from . import nn as _nn


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=False, clip=False, steps=None,
              offset=0.5, name=None):
    """Prior boxes of one feature map: (Boxes, Variances), [H, W, P, 4]."""
    helper = LayerHelper("prior_box", input=input, name=name)
    boxes = helper.create_variable_for_type_inference("float32")
    variances = helper.create_variable_for_type_inference("float32")
    steps = steps or [0.0, 0.0]
    helper.append_op(type="prior_box",
                     inputs={"Input": [input], "Image": [image]},
                     outputs={"Boxes": [boxes], "Variances": [variances]},
                     attrs={"min_sizes": list(min_sizes),
                            "max_sizes": list(max_sizes or []),
                            "aspect_ratios": list(aspect_ratios or [1.0]),
                            "variances": list(variance
                                              or [0.1, 0.1, 0.2, 0.2]),
                            "flip": flip, "clip": clip,
                            "step_w": steps[0], "step_h": steps[1],
                            "offset": offset})
    return boxes, variances


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", input=x, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    if x.shape and y.shape:
        out.desc.shape = (x.shape[0], y.shape[0])
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              name=None):
    helper = LayerHelper("box_coder", input=prior_box, name=name)
    out = helper.create_variable_for_type_inference(prior_box.dtype)
    helper.append_op(type="box_coder",
                     inputs={"PriorBox": [prior_box],
                             "PriorBoxVar": [prior_box_var],
                             "TargetBox": [target_box]},
                     outputs={"OutputBox": [out]},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized})
    return out


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=0.5, name=None):
    helper = LayerHelper("bipartite_match", input=dist_matrix, name=name)
    match_indices = helper.create_variable_for_type_inference("int32")
    match_dist = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="bipartite_match",
                     inputs={"DistMat": [dist_matrix]},
                     outputs={"ColToRowMatchIndices": [match_indices],
                              "ColToRowMatchDist": [match_dist]},
                     attrs={"match_type": match_type,
                            "dist_threshold": dist_threshold})
    return match_indices, match_dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", input=input, name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_weight = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="target_assign",
                     inputs={"X": [input],
                             "MatchIndices": [matched_indices]},
                     outputs={"Out": [out], "OutWeight": [out_weight]},
                     attrs={"mismatch_value": mismatch_value})
    return out, out_weight


def multiclass_nms(bboxes, scores, background_label=0, score_threshold=0.01,
                   nms_top_k=64, nms_threshold=0.3, keep_top_k=20,
                   normalized=True, nms_eta=1.0, name=None):
    helper = LayerHelper("multiclass_nms", input=bboxes, name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    helper.append_op(type="multiclass_nms",
                     inputs={"BBoxes": [bboxes], "Scores": [scores]},
                     outputs={"Out": [out]},
                     attrs={"background_label": background_label,
                            "score_threshold": score_threshold,
                            "nms_top_k": nms_top_k,
                            "nms_threshold": nms_threshold,
                            "keep_top_k": keep_top_k})
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=64,
                     keep_top_k=20, score_threshold=0.01, nms_eta=1.0):
    """Decode the predicted offsets ``loc`` against the priors, then
    multiclass NMS over ``scores`` [B, C, M]."""
    decoded = box_coder(prior_box=prior_box, prior_box_var=prior_box_var,
                        target_box=loc, code_type="decode_center_size")
    return multiclass_nms(bboxes=decoded, scores=scores,
                          background_label=background_label,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, nms_threshold=nms_threshold,
                          keep_top_k=keep_top_k)


def detection_map(detect_res, gt_boxes, gt_labels, class_num=None,
                  background_label=0, overlap_threshold=0.5,
                  evaluate_difficult=True, ap_version="11point"):
    """The batch's 11-point mAP; with ``gt_labels`` None, ``gt_boxes``
    rows are [label, box, (difficult)]."""
    helper = LayerHelper("detection_map", input=detect_res)
    map_out = helper.create_variable_for_type_inference("float32")
    pos_count = helper.create_variable_for_type_inference("int32")
    inputs = {"DetectRes": [detect_res], "GTBoxes": [gt_boxes]}
    if gt_labels is not None:
        inputs["GTLabels"] = [gt_labels]
    helper.append_op(type="detection_map",
                     inputs=inputs,
                     outputs={"MAP": [map_out],
                              "AccumPosCount": [pos_count]},
                     attrs={"overlap_threshold": overlap_threshold,
                            "background_label": background_label,
                            "evaluate_difficult": evaluate_difficult,
                            "ap_version": ap_version})
    map_out.desc.shape = (1,)
    return map_out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, loc_loss_weight=1.0, conf_loss_weight=1.0,
             mining_type="max_negative", normalize=True):
    """One image's SSD loss: match the gts to the priors, encode the
    regression targets, smooth-L1 + softmax cross-entropy (see the
    module docstring for the shapes and the unused arguments)."""
    helper = LayerHelper("ssd_loss", input=location)
    iou = iou_similarity(gt_box, prior_box)
    match_idx, _ = bipartite_match(iou, "per_prediction", overlap_threshold)
    gt_lab_t, _ = target_assign(gt_label, match_idx,
                                mismatch_value=background_label)
    enc = box_coder(prior_box=prior_box, prior_box_var=prior_box_var,
                    target_box=gt_box, code_type="encode_center_size")
    enc_t, loc_wt = _assign_encoded(helper, enc, match_idx)
    loc_diff = _nn.elementwise_sub(location, enc_t)
    loc_loss = _abs_smooth(helper, loc_diff)
    loc_loss = _nn.elementwise_mul(loc_loss, loc_wt, axis=0)

    conf_loss = _nn.softmax_with_cross_entropy(
        confidence, _cast_int(helper, gt_lab_t))
    return _nn.elementwise_add(
        _scale(helper, _reduce(helper, loc_loss), loc_loss_weight),
        _scale(helper, _reduce(helper, conf_loss), conf_loss_weight))


def _assign_encoded(helper, enc, match_idx):
    out = helper.create_variable_for_type_inference("float32")
    wt = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="gather_encoded_target",
                     inputs={"Encoded": [enc], "MatchIndices": [match_idx]},
                     outputs={"Out": [out], "OutWeight": [wt]})
    return out, wt


def _abs_smooth(helper, x):
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="abs_smooth_l1", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def _cast_int(helper, x):
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": "int64"})
    return out


def _scale(helper, x, s):
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(s)})
    return out


def _reduce(helper, x):
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="reduce_mean", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"reduce_all": True})
    return out


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, offset=0.5, flip=False,
                   clip=False, kernel_size=1, pad=0, stride=1):
    """Per feature map: a loc and a conf conv head and the prior boxes
    -> (locs, confs, boxes, variances), one entry a map."""
    if min_sizes is None:
        num_layer = len(inputs)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (num_layer - 2))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes

    locs, confs, boxes, vars_ = [], [], [], []
    for i, inp in enumerate(inputs):
        mins = (min_sizes[i] if isinstance(min_sizes[i], list)
                else [min_sizes[i]])
        maxs = (max_sizes[i] if isinstance(max_sizes[i], list)
                else [max_sizes[i]])
        ar = (aspect_ratios[i] if isinstance(aspect_ratios[i], list)
              else [aspect_ratios[i]])
        box, var = prior_box(inp, image, mins, maxs, ar, flip=flip,
                             clip=clip, offset=offset)
        num_priors = 0
        for _ in mins:
            num_priors += 1 + (1 if maxs else 0)
            num_priors += sum(2 if flip and abs(a - 1) > 1e-6 else
                              (1 if abs(a - 1) > 1e-6 else 0) for a in ar)
        loc = _nn.conv2d(inp, num_priors * 4, kernel_size, stride, pad)
        conf = _nn.conv2d(inp, num_priors * num_classes, kernel_size,
                          stride, pad)
        locs.append(loc)
        confs.append(conf)
        boxes.append(box)
        vars_.append(var)
    return locs, confs, boxes, vars_
