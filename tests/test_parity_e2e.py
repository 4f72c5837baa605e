"""Golden end-to-end RetinaNet decode parity.

An independent NumPy transcription of the reference's host decode
(detectron/lib/core/test_retinanet.py:104-204 im_detect_bbox: per-level
threshold -> argpartition top-N -> anchor shift + delta transform -> /scale ->
clip -> per-class greedy NMS -> global top DETECTIONS_PER_IM), including its
box numerics (boxes.py bbox_transform, legacy +1) and NMS (cython_nms.pyx),
run against sad_tpu's on-device `eval.inference.decode_detections` on shared
random head outputs. Any semantic drift in threshold/top-k/decode/NMS/merge
fails this test with a per-box comparison.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp

from sad_tpu.config import Config
from sad_tpu.config.config import merge_cfg_from_dict
from sad_tpu.data.anchors import retinanet_cell_anchors
from sad_tpu.eval.inference import decode_detections

# ----------------------------------------------------------------------- #
# NumPy transcriptions of the reference host numerics (independent of
# sad_tpu.ops — this is the oracle side)
# ----------------------------------------------------------------------- #

BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def _np_bbox_transform(boxes, deltas):
    """boxes.py:150-184 bbox_transform, weights (1,1,1,1)."""
    widths = boxes[:, 2] - boxes[:, 0] + 1.0
    heights = boxes[:, 3] - boxes[:, 1] + 1.0
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights
    dx, dy = deltas[:, 0], deltas[:, 1]
    dw = np.minimum(deltas[:, 2], BBOX_XFORM_CLIP)
    dh = np.minimum(deltas[:, 3], BBOX_XFORM_CLIP)
    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = np.exp(dw) * widths
    pred_h = np.exp(dh) * heights
    out = np.zeros_like(deltas)
    out[:, 0] = pred_ctr_x - 0.5 * pred_w
    out[:, 1] = pred_ctr_y - 0.5 * pred_h
    out[:, 2] = pred_ctr_x + 0.5 * pred_w - 1.0
    out[:, 3] = pred_ctr_y + 0.5 * pred_h - 1.0
    return out


def _np_greedy_nms(dets, thresh):
    """cython_nms.pyx greedy NMS (legacy +1 areas). dets: (N,5) x1y1x2y2s."""
    x1, y1, x2, y2, scores = dets.T
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1.0)
        h = np.maximum(0.0, yy2 - yy1 + 1.0)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return keep


def _reference_im_detections(
    cls_probs,  # {lvl: (A, C, H, W)}  (reference layout, post-reshape)
    box_preds,  # {lvl: (A, 4, H, W)}
    cell_anchors,  # {lvl: (A, 4)}
    num_classes,  # incl. background
    im_h,
    im_w,
    scale,
    inference_th,
    pre_nms_topn,
    nms_th,
    det_per_im,
):
    """test_retinanet.py:104-204, single image."""
    levels = sorted(cls_probs)
    k_max = max(levels)
    boxes_all = {c: [] for c in range(1, num_classes)}
    for lvl in levels:
        stride = 2.0 ** lvl
        cls_prob = cls_probs[lvl][None]  # (1, A, C, H, W)
        box_pred = box_preds[lvl][None]
        ravel = cls_prob.ravel()
        th = inference_th if lvl < k_max else 0.0
        candidate_inds = np.where(ravel > th)[0]
        if len(candidate_inds) == 0:
            continue
        topn = min(pre_nms_topn, len(candidate_inds))
        inds = np.argpartition(ravel[candidate_inds], -topn)[-topn:]
        inds = candidate_inds[inds]
        inds_5d = np.array(np.unravel_index(inds, cls_prob.shape)).transpose()
        classes = inds_5d[:, 2]
        anchor_ids, y, x = inds_5d[:, 1], inds_5d[:, 3], inds_5d[:, 4]
        scores = cls_prob[0, anchor_ids, classes, y, x]
        boxes = np.column_stack((x, y, x, y)).astype(np.float32) * stride
        boxes += cell_anchors[lvl][anchor_ids, :]
        deltas = box_pred[0, anchor_ids, :, y, x]
        pred = _np_bbox_transform(boxes, deltas) / scale
        pred[:, 0::2] = np.clip(pred[:, 0::2], 0, im_w - 1)  # clip_tiled_boxes
        pred[:, 1::2] = np.clip(pred[:, 1::2], 0, im_h - 1)
        bs = np.zeros((pred.shape[0], 5))
        bs[:, :4] = pred
        bs[:, 4] = scores
        for c in range(1, num_classes):
            sel = np.where(classes == c - 1)[0]
            if len(sel):
                boxes_all[c].extend(bs[sel])
    detections = []
    for c, blist in boxes_all.items():
        if not blist:
            continue
        cls_dets = np.vstack(blist).astype(np.float32)
        keep = _np_greedy_nms(cls_dets, nms_th)
        out = np.zeros((len(keep), 6))
        out[:, :5] = cls_dets[keep]
        out[:, 5] = c
        detections.append(out)
    detections = (
        np.vstack(detections) if detections else np.zeros((0, 6))
    )
    order = np.argsort(-detections[:, 4])
    return detections[order[:det_per_im]]


# ----------------------------------------------------------------------- #


def _decode_cfg():
    return merge_cfg_from_dict(
        Config(),
        {
            "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 5},
            "FPN": {
                "FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 5,
                "EXTRA_CONV_LEVELS": True, "COARSEST_STRIDE": 32,
            },
            "RETINANET": {
                "RETINANET_ON": True,
                "ASPECT_RATIOS": (1.0, 2.0),
                "SCALES_PER_OCTAVE": 2,
                # small so the top-N truncation path is exercised
                "PRE_NMS_TOP_N": 50,
                "INFERENCE_TH": 0.05,
            },
            "TEST": {"NMS": 0.5, "DETECTIONS_PER_IM": 20},
        },
    )


def _random_outputs(cfg, h, w, seed, sparse=True):
    """Random head outputs: mostly-subthreshold probs with a sprinkle of
    confident ones (realistic decode load), NHWC (our layout)."""
    rng = np.random.RandomState(seed)
    a = cfg.num_anchors_per_cell()
    c = cfg.MODEL.NUM_CLASSES - 1
    cls_prob, bbox_pred = {}, {}
    for lvl in cfg.fpn_levels():
        hl, wl = h // 2 ** lvl, w // 2 ** lvl
        p = rng.uniform(0.0, 0.04, (hl, wl, a * c)).astype(np.float32)
        if sparse:
            n_hot = max(3, hl * wl // 3)
            idx = rng.choice(p.size, n_hot, replace=False)
            p.ravel()[idx] = rng.uniform(0.05, 1.0, n_hot)
        else:
            p = rng.uniform(0.0, 1.0, p.shape).astype(np.float32)
        cls_prob[lvl] = p
        bbox_pred[lvl] = rng.randn(hl, wl, a * 4).astype(np.float32) * 0.4
    return cls_prob, bbox_pred


@pytest.mark.parametrize(
    "seed,sparse,exact_topk",
    [(0, True, True), (1, True, True), (2, False, True),
     # TEST.EXACT_TOPK=False asks approx_max_k for recall 0.99. On CPU it
     # lowers exactly, so the parity assertions still hold bit-for-bit; the
     # point is that the setting is compiled and executed by the suite.
     (0, True, False), (2, False, False)],
)
def test_decode_matches_reference_transcription(seed, sparse, exact_topk):
    cfg = _decode_cfg()
    if not exact_topk:
        cfg = merge_cfg_from_dict(cfg, {"TEST": {"EXACT_TOPK": False}})
    h = w = 64
    im_h, im_w, scale = 50, 61, 64.0 / 50.0
    cls_prob, bbox_pred = _random_outputs(cfg, h, w, seed, sparse)

    a = cfg.num_anchors_per_cell()
    c = cfg.MODEL.NUM_CLASSES - 1
    cells = {
        lvl: retinanet_cell_anchors(
            lvl, cfg.RETINANET.ANCHOR_SCALE, cfg.RETINANET.ASPECT_RATIOS,
            cfg.RETINANET.SCALES_PER_OCTAVE,
        )
        for lvl in cfg.fpn_levels()
    }
    # reference layout: (A, C, H, W) from NHWC (H, W, A*C)
    ref_probs = {
        lvl: p.reshape(p.shape[0], p.shape[1], a, c).transpose(2, 3, 0, 1)
        for lvl, p in cls_prob.items()
    }
    ref_boxes = {
        lvl: b.reshape(b.shape[0], b.shape[1], a, 4).transpose(2, 3, 0, 1)
        for lvl, b in bbox_pred.items()
    }
    golden = _reference_im_detections(
        ref_probs, ref_boxes, cells, cfg.MODEL.NUM_CLASSES, im_h, im_w, scale,
        cfg.RETINANET.INFERENCE_TH, cfg.RETINANET.PRE_NMS_TOP_N,
        cfg.TEST.NMS, cfg.TEST.DETECTIONS_PER_IM,
    )

    outputs = {
        "cls_prob": {lvl: jnp.asarray(p)[None] for lvl, p in cls_prob.items()},
        "bbox_pred": {lvl: jnp.asarray(b)[None] for lvl, b in bbox_pred.items()},
    }
    dec = decode_detections(
        cfg, outputs,
        jnp.asarray([[im_h, im_w]], jnp.float32),
        jnp.asarray([scale], jnp.float32),
    )
    valid = np.asarray(dec["valid"][0])
    ours = np.concatenate(
        [
            np.asarray(dec["boxes"][0])[valid],
            np.asarray(dec["scores"][0])[valid, None],
            np.asarray(dec["classes"][0])[valid, None].astype(np.float64),
        ],
        axis=1,
    )

    assert ours.shape[0] == golden.shape[0], (
        f"detection count: ours {ours.shape[0]} vs reference {golden.shape[0]}"
    )
    # both are globally score-sorted; compare row by row
    g_order = np.argsort(-golden[:, 4], kind="stable")
    o_order = np.argsort(-ours[:, 4], kind="stable")
    g, o = golden[g_order], ours[o_order]
    np.testing.assert_allclose(o[:, 4], g[:, 4], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(o[:, 5], g[:, 5])
    np.testing.assert_allclose(o[:, :4], g[:, :4], rtol=1e-4, atol=1e-3)


def test_decode_softmax_background_drop():
    """SOFTMAX head: the background column must be dropped before decode
    (test_retinanet.py:123-124)."""
    cfg = merge_cfg_from_dict(_decode_cfg(), {"RETINANET": {"SOFTMAX": True}})
    h = w = 32
    rng = np.random.RandomState(3)
    a = cfg.num_anchors_per_cell()
    C = cfg.MODEL.NUM_CLASSES  # incl. bg column
    outputs = {"cls_prob": {}, "bbox_pred": {}}
    for lvl in cfg.fpn_levels():
        hl, wl = max(1, h // 2 ** lvl), max(1, w // 2 ** lvl)
        logits = rng.randn(hl, wl, a, C).astype(np.float32)
        p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        outputs["cls_prob"][lvl] = jnp.asarray(
            p.reshape(hl, wl, a * C)
        )[None]
        outputs["bbox_pred"][lvl] = jnp.asarray(
            rng.randn(hl, wl, a * 4).astype(np.float32) * 0.2
        )[None]
    dec = decode_detections(
        cfg, outputs,
        jnp.asarray([[30, 30]], jnp.float32),
        jnp.asarray([1.0], jnp.float32),
    )
    classes = np.asarray(dec["classes"][0])[np.asarray(dec["valid"][0])]
    assert classes.min() >= 1 and classes.max() <= C - 1
