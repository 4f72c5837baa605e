"""Mask R-CNN and Keypoint R-CNN training losses + on-device targets.

Capability-equivalent to detectron/lib/roi_data/mask_rcnn.py /
keypoint_rcnn.py + mask_rcnn_heads.py / keypoint_rcnn_heads.py losses,
Redesigned: the reference rasterizes polygon targets per sampled RoI on
the host (it samples RoIs on the host too); here RoIs are sampled on device,
so targets are extracted on device by RoIAlign-cropping precomputed gt
instance-mask rasters (the host loader rasterizes each gt polygon once per
image at a fixed stride — sad_tpu.utils.segms) and thresholding at 0.5. This
is the same crop-and-resize the reference applies to polygons, in tensor
form.

Losses preserved:
- mask: sigmoid cross-entropy over the gt-class mask channel at fg RoIs,
  averaged over fg mask elements (mask_rcnn_heads.py add_mask_rcnn_losses:
  SigmoidCrossEntropyLoss * WEIGHT_LOSS_MASK),
- keypoints: softmax cross-entropy over the heatmap per visible keypoint,
  normalized by the number of visible keypoints when
  NORMALIZE_BY_VISIBLE_KEYPOINTS (keypoint_rcnn_heads.py SoftmaxWithLoss
  on kps_score with spatial labels).

Deliberate static-shape redesign of the keypoint roi selection: the
reference draws a SEPARATE keypoint-fg sample — up to fg_rois_per_image
rois with overlap >= FG_THRESH that contain >= 1 visible keypoint, chosen
from the full candidate pool (roi_data/keypoint_rcnn.py
add_keypoint_rcnn_blobs:37-62). Here the keypoint head runs on the box
head's fg slots; rois (or individual keypoints) without a visible,
inside-the-roi keypoint simply carry zero weight in the loss
(heat_valid), and the per-group minibatch-validity gate plays the
reference's finalize_keypoint_minibatch role. Same supervision semantics,
no dynamic second sampling pass.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from sad_tpu.config import Config
from sad_tpu.ops.detectron_ops import roi_align

FLT_MIN = 1.1754944e-38


def mask_targets_on_device(
    gt_mask_rasters: jnp.ndarray,  # (G, Hm, Wm) float {0,1}, stride `s`
    rois: jnp.ndarray,  # (R, 4) in network-input coords
    matched_gt: jnp.ndarray,  # (R,) index into G
    resolution: int,
    mask_stride: float,
) -> jnp.ndarray:
    """Crop each roi's matched gt raster to (R, res, res) binary targets."""
    g, hm, wm = gt_mask_rasters.shape
    feats = gt_mask_rasters.transpose(1, 2, 0)[None]  # (1, Hm, Wm, G)
    r = rois.shape[0]
    rois5 = jnp.concatenate(
        [jnp.zeros((r, 1), jnp.float32), rois.astype(jnp.float32)], axis=1
    )
    crops = roi_align(feats, rois5, 1.0 / mask_stride, resolution, 2)
    picked = jnp.take_along_axis(
        crops, matched_gt[:, None, None, None], axis=-1
    )[..., 0]
    return (picked >= 0.5).astype(jnp.float32)


def mask_loss(
    cfg: Config,
    mask_logits: jnp.ndarray,  # (R, M, M, C) per-class logits
    mask_targets: jnp.ndarray,  # (R, M, M) binary
    roi_labels: jnp.ndarray,  # (R,) class of each roi (0 bg)
    is_fg: jnp.ndarray,  # (R,)
    n_groups: int,
) -> jnp.ndarray:
    """Sigmoid CE on the gt-class channel at fg rois, mean over fg elements.

    The reference computes a per-GPU mean scaled by 1/NUM_GPUS and allreduce
    SUMS the gradients (mask_rcnn_heads.py add_mask_rcnn_losses x
    detector.py GetLossScale), so the effective total is the AVERAGE of the
    per-GPU means. Rows here are n_groups consecutive per-"GPU" blocks, so
    we reproduce that exactly: per-group weighted means, averaged.
    """
    if cfg.MRCNN.CLS_SPECIFIC_MASK:
        sel = jnp.take_along_axis(
            mask_logits, jnp.maximum(roi_labels, 0)[:, None, None, None], axis=-1
        )[..., 0]
    else:
        sel = mask_logits[..., 0]
    x = sel.astype(jnp.float32)
    t = mask_targets
    ge = (x >= 0).astype(jnp.float32)
    ce = -x * (t - ge) + jnp.log(1.0 + jnp.exp(x - 2.0 * x * ge))
    w = is_fg.astype(jnp.float32)[:, None, None]
    sum_g = jnp.sum((ce * w).reshape(n_groups, -1), axis=1, dtype=jnp.float32)
    count_g = jnp.maximum(
        jnp.sum(w.reshape(n_groups, -1), axis=1) * sel.shape[1] * sel.shape[2],
        1.0,
    )
    return (
        cfg.MRCNN.WEIGHT_LOSS_MASK * jnp.sum(sum_g / count_g) / n_groups
    )


def keypoint_targets_on_device(
    gt_keypoints: jnp.ndarray,  # (G, K, 3) [x, y, visibility]
    rois: jnp.ndarray,  # (R, 4)
    matched_gt: jnp.ndarray,  # (R,)
    heatmap_size: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-roi heatmap index labels (R, K) + valid flags (R, K)
    (ref: keypoint_rcnn.py keypoints_to_heatmap_labels)."""
    kp = gt_keypoints[matched_gt]  # (R, K, 3)
    x1, y1, x2, y2 = rois[:, 0], rois[:, 1], rois[:, 2], rois[:, 3]
    w = jnp.maximum(x2 - x1, 1.0)
    h = jnp.maximum(y2 - y1, 1.0)
    sx = heatmap_size / w
    sy = heatmap_size / h
    px = jnp.floor((kp[..., 0] - x1[:, None]) * sx[:, None]).astype(jnp.int32)
    py = jnp.floor((kp[..., 1] - y1[:, None]) * sy[:, None]).astype(jnp.int32)
    inside = (
        (px >= 0) & (px < heatmap_size) & (py >= 0) & (py < heatmap_size)
    )
    visible = (kp[..., 2] > 0) & inside
    px = jnp.clip(px, 0, heatmap_size - 1)
    py = jnp.clip(py, 0, heatmap_size - 1)
    return py * heatmap_size + px, visible


def keypoint_loss(
    cfg: Config,
    kps_logits: jnp.ndarray,  # (R, S, S, K) heatmap logits
    heat_labels: jnp.ndarray,  # (R, K) flat heatmap indices
    heat_valid: jnp.ndarray,  # (R, K)
    is_fg: jnp.ndarray,  # (R,)
    n_groups: int,
    n_images: int = 0,
) -> jnp.ndarray:
    """Softmax CE over the heatmap per visible keypoint.

    Reference semantics (keypoint_rcnn_heads.py:110-149 x GetLossScale):
    per-GPU SoftmaxWithLoss with 0/1 weights = weighted mean over that
    GPU's visible keypoints, scaled 1/NUM_GPUS, gradients allreduce-SUMMED
    -> effective total = average of per-GPU terms. Rows here are n_groups
    consecutive per-"GPU" blocks; n_images is the total image count (so
    images-per-group = n_images // n_groups).

    NORMALIZE_BY_VISIBLE off: the reference multiplies each GPU's
    visible-mean loss by num_visible/(IMS*BATCH_SIZE_PER_IM*FG_FRACTION*K)
    (keypoint_rcnn.py:105-110) — i.e. a FIXED per-GPU denominator of
    expected-max-fg-keypoints, independent of how many roi rows reach this
    head (the head may run on the leading fg_cap slots only).
    """
    r, s, _, k = kps_logits.shape
    flat = kps_logits.reshape(r, s * s, k).transpose(0, 2, 1)  # (R, K, S*S)
    logp = jax.nn.log_softmax(flat.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, heat_labels[..., None], axis=-1)[..., 0]
    w = (heat_valid & is_fg[:, None]).astype(jnp.float32)
    sum_g = jnp.sum((nll * w).reshape(n_groups, -1), axis=1, dtype=jnp.float32)
    nvis_g = jnp.sum(w.reshape(n_groups, -1), axis=1)
    if cfg.KRCNN.NORMALIZE_BY_VISIBLE_KEYPOINTS:
        per_group = sum_g / jnp.maximum(nvis_g, 1.0)
    else:
        if not n_images:
            raise ValueError(
                "keypoint_loss with NORMALIZE_BY_VISIBLE_KEYPOINTS=False "
                "needs n_images (the fixed denominator is per-image, not "
                "per-roi-row)"
            )
        ims = n_images // n_groups
        per_group = sum_g / jnp.float32(
            ims * cfg.TRAIN.BATCH_SIZE_PER_IM * cfg.TRAIN.FG_FRACTION * k
        )
    # minibatch-validity gate (keypoint_rcnn.py:94-103
    # finalize_keypoint_minibatch): a group with too few visible keypoints
    # contributes no keypoint loss. On-device predicate instead of the
    # reference's host-side blob zeroing (static shapes).
    gate = nvis_g > cfg.KRCNN.MIN_KEYPOINT_COUNT_FOR_VALID_MINIBATCH
    per_group = jnp.where(gate, per_group, 0.0)
    return cfg.KRCNN.LOSS_WEIGHT * jnp.sum(per_group) / n_groups
