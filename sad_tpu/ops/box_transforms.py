"""Box coordinate transforms and IoU — jnp versions usable inside jit.

Replicates the reference's box numerics (detectron/lib/utils/boxes.py) with
the legacy "+1" pixel-extent convention, which the anchor/target/decode math
all assume. Works on jnp or numpy inputs (pure jnp ops).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

# Matches cfg.BBOX_XFORM_CLIP = log(1000/16) (config.py:926).
# math.log (not jnp.log): a module-level jnp call would initialize the JAX
# backend at import time, which breaks hermetic CPU-mesh dry runs.
BBOX_XFORM_CLIP = math.log(1000.0 / 16.0)


def bbox_transform(
    boxes: jnp.ndarray,  # (N, 4) x1,y1,x2,y2 anchor/proposal boxes
    deltas: jnp.ndarray,  # (N, 4) dx,dy,dw,dh
    weights=(1.0, 1.0, 1.0, 1.0),
    clip: float = BBOX_XFORM_CLIP,
) -> jnp.ndarray:
    """Apply regression deltas to boxes (ref: boxes.py bbox_transform)."""
    boxes = boxes.astype(jnp.float32)
    deltas = deltas.astype(jnp.float32)
    widths = boxes[..., 2] - boxes[..., 0] + 1.0
    heights = boxes[..., 3] - boxes[..., 1] + 1.0
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = jnp.minimum(deltas[..., 2] / ww, clip)
    dh = jnp.minimum(deltas[..., 3] / wh, clip)

    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = jnp.exp(dw) * widths
    pred_h = jnp.exp(dh) * heights

    # The trailing "-1" on x2/y2 is correct (legacy pixel convention).
    return jnp.stack(
        [
            pred_ctr_x - 0.5 * pred_w,
            pred_ctr_y - 0.5 * pred_h,
            pred_ctr_x + 0.5 * pred_w - 1.0,
            pred_ctr_y + 0.5 * pred_h - 1.0,
        ],
        axis=-1,
    )


def bbox_transform_inv(
    ex_rois: jnp.ndarray, gt_rois: jnp.ndarray, weights=(1.0, 1.0, 1.0, 1.0)
) -> jnp.ndarray:
    """Regression targets from example boxes to gt boxes
    (ref: boxes.py bbox_transform_inv)."""
    ex_rois = ex_rois.astype(jnp.float32)
    gt_rois = gt_rois.astype(jnp.float32)
    ex_w = ex_rois[..., 2] - ex_rois[..., 0] + 1.0
    ex_h = ex_rois[..., 3] - ex_rois[..., 1] + 1.0
    ex_cx = ex_rois[..., 0] + 0.5 * ex_w
    ex_cy = ex_rois[..., 1] + 0.5 * ex_h

    gt_w = gt_rois[..., 2] - gt_rois[..., 0] + 1.0
    gt_h = gt_rois[..., 3] - gt_rois[..., 1] + 1.0
    gt_cx = gt_rois[..., 0] + 0.5 * gt_w
    gt_cy = gt_rois[..., 1] + 0.5 * gt_h

    wx, wy, ww, wh = weights
    return jnp.stack(
        [
            wx * (gt_cx - ex_cx) / ex_w,
            wy * (gt_cy - ex_cy) / ex_h,
            ww * jnp.log(gt_w / ex_w),
            wh * jnp.log(gt_h / ex_h),
        ],
        axis=-1,
    )


def clip_boxes(boxes: jnp.ndarray, height, width) -> jnp.ndarray:
    """Clip (..., 4) boxes to [0, size-1] (ref: boxes.py clip_tiled_boxes)."""
    x1 = jnp.clip(boxes[..., 0], 0.0, width - 1.0)
    y1 = jnp.clip(boxes[..., 1], 0.0, height - 1.0)
    x2 = jnp.clip(boxes[..., 2], 0.0, width - 1.0)
    y2 = jnp.clip(boxes[..., 3], 0.0, height - 1.0)
    return jnp.stack([x1, y1, x2, y2], axis=-1)


def bbox_overlaps(boxes: jnp.ndarray, query_boxes: jnp.ndarray) -> jnp.ndarray:
    """Pairwise IoU matrix (N, K) with the legacy "+1" area convention.

    Ref: lib/utils/cython_bbox.pyx bbox_overlaps — the anchor-labeling hot
    loop; here a dense vectorized form suitable for both numpy and jax.numpy.
    """
    boxes = boxes.astype(jnp.float32)
    query_boxes = query_boxes.astype(jnp.float32)
    b_area = (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0)
    q_area = (query_boxes[:, 2] - query_boxes[:, 0] + 1.0) * (
        query_boxes[:, 3] - query_boxes[:, 1] + 1.0
    )
    iw = (
        jnp.minimum(boxes[:, None, 2], query_boxes[None, :, 2])
        - jnp.maximum(boxes[:, None, 0], query_boxes[None, :, 0])
        + 1.0
    )
    ih = (
        jnp.minimum(boxes[:, None, 3], query_boxes[None, :, 3])
        - jnp.maximum(boxes[:, None, 1], query_boxes[None, :, 1])
        + 1.0
    )
    iw = jnp.maximum(iw, 0.0)
    ih = jnp.maximum(ih, 0.0)
    inter = iw * ih
    union = b_area[:, None] + q_area[None, :] - inter
    return jnp.where(union > 0, inter / union, 0.0)
