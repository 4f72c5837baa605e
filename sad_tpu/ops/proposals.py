"""RPN proposal ops — on-device, static shapes.

Capability-equivalent to the reference's Python-in-graph CPU ops
(detectron/lib/ops/generate_proposals.py,
collect_and_distribute_fpn_rpn_proposals.py, generate_proposal_labels.py and
lib/roi_data/fast_rcnn.py sampling), redesigned for static shapes: every step is a
fixed-shape tensor program (top-k + masked NMS + masked sampling) instead of
host numpy with dynamic row counts. Invalid slots are carried as explicit
masks.

Proposal boxes use the legacy +1 pixel conventions throughout, matching
boxes.py / generate_proposals.py numerics.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import topk
from .box_transforms import bbox_transform, clip_boxes
from .nms import NEG_INF


def proposal_candidates(
    scores: jnp.ndarray,  # (H, W, A) objectness (post-sigmoid)
    deltas: jnp.ndarray,  # (H, W, A, 4)
    anchors: jnp.ndarray,  # (H, W, A, 4)
    im_hw: jnp.ndarray,  # (2,) image extent for clipping
    pre_nms_top_n: int,
    min_size: float = 0.0,
    exact_topk: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Everything before the proposal NMS (ref: generate_proposals.py
    top-k + decode + clip + small-box filter). Returns
    (boxes (k, 4), top_scores (k,), masked_scores (k,) with NEG_INF on
    filtered candidates).

    exact_topk=False (cfg.RPN.EXACT_TOPK, the proposal analogue of
    TEST.EXACT_TOPK) asks ops.topk.top_k for recall 0.99 instead of the
    exact top-k multiset."""
    flat_scores = scores.reshape(-1)
    k = min(pre_nms_top_n, flat_scores.shape[0])
    top_scores, inds = topk.top_k(flat_scores, k, exact=exact_topk)
    top_anchors = anchors.reshape(-1, 4)[inds]
    top_deltas = deltas.reshape(-1, 4)[inds]

    boxes = bbox_transform(top_anchors, top_deltas)
    boxes = clip_boxes(boxes, im_hw[0], im_hw[1])

    # filter_boxes (generate_proposals.py:171-183). The reference scales
    # min_size by im_scale (it is in ORIGINAL-image pixels) and also drops
    # boxes whose center falls outside the image — vacuous after clipping.
    # Every reference YAML leaves RPN_MIN_SIZE at 0 (both forms no-op);
    # a nonzero caller must pass min_size pre-scaled to the network frame.
    ws = boxes[:, 2] - boxes[:, 0] + 1.0
    hs = boxes[:, 3] - boxes[:, 1] + 1.0
    keep = (ws > min_size) & (hs > min_size)
    masked = jnp.where(keep, top_scores, NEG_INF)
    return boxes, top_scores, masked


def generate_proposals(
    scores: jnp.ndarray,  # (H, W, A) objectness (post-sigmoid)
    deltas: jnp.ndarray,  # (H, W, A, 4)
    anchors: jnp.ndarray,  # (H, W, A, 4)
    im_hw: jnp.ndarray,  # (2,) image extent for clipping
    pre_nms_top_n: int,
    post_nms_top_n: int,
    nms_thresh: float,
    min_size: float = 0.0,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One level, one image (ref: generate_proposals.py:56-183).

    Returns (boxes (post_n, 4), scores (post_n,), valid (post_n,))."""
    boxes, top_scores, masked = proposal_candidates(
        scores, deltas, anchors, im_hw, pre_nms_top_n, min_size
    )

    from .nms import greedy_nms

    idx, valid = greedy_nms(
        boxes[None], masked[None], nms_thresh, post_nms_top_n
    )
    idx, valid = idx[0], valid[0]
    return boxes[idx], jnp.where(valid, top_scores[idx], 0.0), valid


def nms_levels_batched(
    prop_levels,  # [(level, boxes (B,k,4), top_scores (B,k), masked (B,k))]
    nms_thresh: float,
    post_nms_top_n: int,
) -> Tuple[Dict[int, jnp.ndarray], Dict[int, jnp.ndarray], Dict[int, jnp.ndarray]]:
    """Greedy NMS for every (level x image) problem in ONE call
    (ops/nms.greedy_nms), identical per-problem results. Per-level k may
    differ; shorter levels are padded with NEG_INF candidates that can
    never be picked or suppress anything.

    Returns ({lvl: boxes (B, post_n, 4)}, {lvl: scores}, {lvl: valid})."""
    from .nms import greedy_nms

    b = prop_levels[0][1].shape[0]
    kmax = max(bx.shape[1] for _, bx, _, _ in prop_levels)

    def padk(x, fill):
        pad = kmax - x.shape[1]
        if pad == 0:
            return x
        widths = ((0, 0), (0, pad)) + ((0, 0),) * (x.ndim - 2)
        return jnp.pad(x, widths, constant_values=fill)

    all_boxes = jnp.concatenate([padk(bx, 0.0) for _, bx, _, _ in prop_levels])
    all_top = jnp.concatenate([padk(ts, 0.0) for _, _, ts, _ in prop_levels])
    all_masked = jnp.concatenate(
        [padk(ms, float(NEG_INF)) for _, _, _, ms in prop_levels]
    )
    keep_idx, keep_valid = greedy_nms(
        all_boxes, all_masked, nms_thresh, post_nms_top_n
    )
    kept_boxes = jnp.take_along_axis(all_boxes, keep_idx[..., None], axis=1)
    kept_scores = jnp.where(
        keep_valid, jnp.take_along_axis(all_top, keep_idx, axis=1), 0.0
    )
    lv_b = {lvl: kept_boxes[j * b:(j + 1) * b]
            for j, (lvl, *_r) in enumerate(prop_levels)}
    lv_s = {lvl: kept_scores[j * b:(j + 1) * b]
            for j, (lvl, *_r) in enumerate(prop_levels)}
    lv_v = {lvl: keep_valid[j * b:(j + 1) * b]
            for j, (lvl, *_r) in enumerate(prop_levels)}
    return lv_b, lv_s, lv_v


def map_rois_to_fpn_levels(
    boxes: jnp.ndarray,  # (R, 4)
    k_min: int,
    k_max: int,
    canonical_scale: int = 224,
    canonical_level: int = 4,
) -> jnp.ndarray:
    """FPN paper eqn 1 (ref: lib/modeling/FPN.py map_rois_to_fpn_levels):
    target level k = floor(k0 + log2(sqrt(area)/s0)), clipped."""
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    s = jnp.sqrt(jnp.maximum(w * h, 1e-6))
    k = jnp.floor(canonical_level + jnp.log2(s / canonical_scale + 1e-8))
    return jnp.clip(k, k_min, k_max).astype(jnp.int32)


def collect_and_distribute_fpn_proposals(
    level_boxes: Dict[int, jnp.ndarray],  # per RPN level (post_n, 4)
    level_scores: Dict[int, jnp.ndarray],
    level_valid: Dict[int, jnp.ndarray],
    post_nms_top_n: int,
    roi_min_level: int,
    roi_max_level: int,
    canonical_scale: int = 224,
    canonical_level: int = 4,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Union the per-level proposals, keep the global top-k by score, and
    compute each roi's target RoI-pooling level
    (ref: collect_and_distribute_fpn_rpn_proposals.py).

    Returns (boxes (K, 4), scores (K,), valid (K,), roi_levels (K,))."""
    boxes = jnp.concatenate([level_boxes[l] for l in sorted(level_boxes)])
    scores = jnp.concatenate([level_scores[l] for l in sorted(level_scores)])
    valid = jnp.concatenate([level_valid[l] for l in sorted(level_valid)])
    masked = jnp.where(valid, scores, NEG_INF)
    k = min(post_nms_top_n, masked.shape[0])
    top_scores, inds = jax.lax.top_k(masked, k)
    out_boxes = boxes[inds]
    out_valid = top_scores > NEG_INF
    levels = map_rois_to_fpn_levels(
        out_boxes, roi_min_level, roi_max_level, canonical_scale, canonical_level
    )
    return out_boxes, jnp.where(out_valid, top_scores, 0.0), out_valid, levels


def multilevel_roi_align(
    features: Dict[int, jnp.ndarray],  # {level: (B, H_l, W_l, C)}
    rois: jnp.ndarray,  # (R, 5) [batch, x1, y1, x2, y2]
    roi_levels: jnp.ndarray,  # (R,)
    valid: jnp.ndarray,  # (R,)
    resolution: int,
    sampling_ratio: int = 2,
    slots_per_im: int = 0,
) -> jnp.ndarray:
    """RoIAlign each roi from its FPN level (ref: RoIFeatureTransform +
    BatchPermutation shuffle, detector.py:240-305). Static-shape strategy:
    run roi_align on every level for all R rois and select per roi — rois
    stay in their original order, so the reference's restore-permutation is
    unnecessary. Returns (R, res, res, C). No gradient flows to the roi
    coordinates: the reference treats proposals as data."""
    return dense_multilevel_roi_align(
        features, jax.lax.stop_gradient(rois), roi_levels, valid,
        resolution, sampling_ratio, slots_per_im,
    )


def dense_multilevel_roi_align(
    features: Dict[int, jnp.ndarray],
    rois: jnp.ndarray,
    roi_levels: jnp.ndarray,
    valid: jnp.ndarray,
    resolution: int,
    sampling_ratio: int = 2,
    slots_per_im: int = 0,
) -> jnp.ndarray:
    """The all-levels tent-matmul form. slots_per_im: see
    ops.detectron_ops.roi_align."""
    from .detectron_ops import roi_align

    outs = []
    lvls = sorted(features)
    for lvl in lvls:
        outs.append(
            roi_align(
                features[lvl], rois, 1.0 / (2 ** lvl), resolution,
                sampling_ratio, slots_per_im=slots_per_im,
            )
        )
    stacked = jnp.stack(outs)  # (L, R, res, res, C)
    sel = jnp.argmax(
        (jnp.asarray(lvls)[:, None] == roi_levels[None, :]).astype(jnp.int32),
        axis=0,
    )
    picked = jnp.take_along_axis(
        stacked, sel[None, :, None, None, None], axis=0
    )[0]
    return picked * valid[:, None, None, None].astype(picked.dtype)


def sampled_fg_cap(batch_size_per_im: int, fg_fraction: float) -> int:
    """Leading-slot fg capacity of sample_proposal_labels' output ordering.

    The sampler sorts kept-fg rois into the leading slots (priority
    2+u > bg 1+u > demoted fg 0.5) and caps fg at this count, so the first
    `sampled_fg_cap(...)` slots per image provably contain every fg roi.
    Aux heads (mask/keypoint) slice exactly this prefix — any change to the
    rounding here changes both the sampler and the slices in lockstep.
    """
    return int(round(fg_fraction * batch_size_per_im))


def sample_proposal_labels(
    rng: jax.Array,
    proposals: jnp.ndarray,  # (P, 4) from RPN (one image)
    proposal_valid: jnp.ndarray,  # (P,)
    gt_boxes: jnp.ndarray,  # (G, 4) padded with zeros
    gt_classes: jnp.ndarray,  # (G,) 0 = padding
    batch_size_per_im: int,
    fg_fraction: float,
    fg_thresh: float,
    bg_thresh_hi: float,
    bg_thresh_lo: float,
    num_classes: int,
    bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
) -> Dict[str, jnp.ndarray]:
    """Sample fg/bg RoIs and build Fast R-CNN training targets
    (ref: lib/roi_data/fast_rcnn.py _sample_rois via
    generate_proposal_labels.py), static-shape:

    - gt boxes are appended to the proposal set (Detectron trains on
      proposals union gt),
    - fg: IoU >= fg_thresh; bg: IoU in [lo, hi); sampled to a fixed
      batch_size_per_im with random priorities instead of np.random.choice,
    - returns fixed-size arrays with 'label' 0 for bg and -1-masked slots
      carrying zero weights.
    """
    from .box_transforms import bbox_overlaps, bbox_transform_inv

    all_boxes = jnp.concatenate([proposals, gt_boxes], axis=0)
    all_valid = jnp.concatenate(
        [proposal_valid, gt_classes > 0], axis=0
    )
    p = all_boxes.shape[0]

    iou = bbox_overlaps(all_boxes, gt_boxes)  # (P+G, G)
    gt_is_real = (gt_classes > 0)[None, :]
    iou = jnp.where(gt_is_real, iou, -1.0)
    max_iou = iou.max(axis=1)
    argmax_gt = iou.argmax(axis=1)

    is_fg = (max_iou >= fg_thresh) & all_valid
    is_bg = (max_iou < bg_thresh_hi) & (max_iou >= bg_thresh_lo) & all_valid

    fg_cap = sampled_fg_cap(batch_size_per_im, fg_fraction)
    # random priorities: fg first (capped), then bg, then invalid
    r1, r2 = jax.random.split(rng)
    pri = jnp.where(is_fg, 2.0 + jax.random.uniform(r1, (p,)), 0.0)
    pri = jnp.where(is_bg, 1.0 + jax.random.uniform(r2, (p,)), pri)
    # cap fg count at fg_cap: demote the lowest-priority extra fg to just
    # above bg range so bg fills the rest
    fg_rank = jnp.argsort(jnp.argsort(jnp.where(is_fg, -pri, jnp.inf)))
    pri = jnp.where(is_fg & (fg_rank >= fg_cap), 0.5, pri)

    order = jnp.argsort(-pri)
    sel = order[:batch_size_per_im]
    sel_pri = pri[sel]
    sel_valid = sel_pri > 0.5  # kept fg/bg (demoted fg and invalid dropped)

    sel_boxes = all_boxes[sel]
    sel_fg = is_fg[sel] & (fg_rank[sel] < fg_cap)
    labels = jnp.where(sel_fg, gt_classes[argmax_gt[sel]], 0)
    labels = jnp.where(sel_valid, labels, 0)

    targets = bbox_transform_inv(
        sel_boxes, gt_boxes[argmax_gt[sel]], bbox_reg_weights
    )
    # class-specific 4C target layout with inside/outside weights
    # (roi_data/fast_rcnn.py _expand_bbox_targets)
    cls_idx = jnp.maximum(labels, 0)
    one_hot = jax.nn.one_hot(cls_idx, num_classes, dtype=jnp.float32)
    w = (one_hot * sel_fg[:, None].astype(jnp.float32))[:, :, None]
    dense_targets = (w * targets[:, None, :]).reshape(
        batch_size_per_im, 4 * num_classes
    )
    weights = jnp.broadcast_to(w, w.shape[:2] + (4,)).reshape(
        batch_size_per_im, 4 * num_classes
    )
    return {
        "rois": sel_boxes,
        "matched_gt": argmax_gt[sel],
        "labels": jnp.where(sel_valid, labels, -1),  # -1 = pad slot (ignored)
        "bbox_targets": dense_targets,
        "bbox_inside_weights": weights,
        "bbox_outside_weights": weights,
        "valid": sel_valid,
        "is_fg": sel_fg,
    }
