"""On-device NMS with static shapes.

Replaces the reference's host Cython greedy NMS (lib/utils/cython_nms.pyx,
called from boxes.py:314-318) with a fixed-iteration form: at
each of ``max_out`` steps, pick the highest-scoring unsuppressed box and
suppress everything over the IoU threshold against it. This yields exactly
the greedy-NMS keep sequence, truncated to ``max_out`` — which is all the
RetinaNet decode path needs (top DETECTIONS_PER_IM=100 overall,
test_retinanet.py:174-194).

Class-wise NMS (the reference loops classes, test_retinanet.py:177-185) is
done in one shot with the standard coordinate-offset trick: boxes of
different classes are translated far apart so they can never suppress each
other — mathematically identical to per-class NMS followed by a global
score-ordered merge.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# np scalar, not jnp: module-level jnp would initialize the device
# backend at import time (breaks hermetic CPU-mesh dryruns).
NEG_INF = np.float32(-1e30)


def _iou_one_vs_all(box: jnp.ndarray, boxes: jnp.ndarray) -> jnp.ndarray:
    """IoU of one (4,) box against (K, 4) boxes, legacy +1 convention
    (matching cython_nms.pyx)."""
    area1 = (box[2] - box[0] + 1.0) * (box[3] - box[1] + 1.0)
    areas = (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0)
    iw = jnp.maximum(
        jnp.minimum(box[2], boxes[:, 2]) - jnp.maximum(box[0], boxes[:, 0]) + 1.0,
        0.0,
    )
    ih = jnp.maximum(
        jnp.minimum(box[3], boxes[:, 3]) - jnp.maximum(box[1], boxes[:, 1]) + 1.0,
        0.0,
    )
    inter = iw * ih
    return inter / (area1 + areas - inter)


def nms_fixed(
    boxes: jnp.ndarray,  # (K, 4)
    scores: jnp.ndarray,  # (K,); invalid candidates should carry -inf scores
    iou_threshold: float,
    max_out: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy NMS returning (indices (max_out,), valid (max_out,) bool)."""
    boxes = boxes.astype(jnp.float32)
    scores = scores.astype(jnp.float32)
    k = boxes.shape[0]

    def body(i, state):
        live_scores, out_idx, out_valid = state
        pick = jnp.argmax(live_scores)
        pick_score = live_scores[pick]
        valid = pick_score > NEG_INF
        iou = _iou_one_vs_all(boxes[pick], boxes)
        # Suppress overlaps (incl. the picked box itself, IoU=1) — but only
        # if this pick was valid, else leave state untouched.
        suppress = valid & (iou > iou_threshold)
        live_scores = jnp.where(suppress, NEG_INF, live_scores)
        # Also always retire the picked index to guarantee progress.
        live_scores = jnp.where(
            valid, live_scores.at[pick].set(NEG_INF), live_scores
        )
        out_idx = out_idx.at[i].set(jnp.where(valid, pick, 0))
        out_valid = out_valid.at[i].set(valid)
        return live_scores, out_idx, out_valid

    init = (
        scores,
        jnp.zeros((max_out,), jnp.int32),
        jnp.zeros((max_out,), bool),
    )
    _, out_idx, out_valid = jax.lax.fori_loop(0, max_out, body, init)
    return out_idx, out_valid


def greedy_nms(
    boxes: jnp.ndarray,  # (N, K, 4)
    masked_scores: jnp.ndarray,  # (N, K); invalid carry NEG_INF
    iou_threshold: float,
    max_out: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy NMS over N independent problems; per problem the keep
    sequence of nms_fixed.

    Compiled for a GPU, problems whose padded candidate count fits one
    kernel program (``uses_kernel``) run in the Pallas kernel of
    ops/pallas_nms.py, one program per problem. Larger problems, and every
    other platform, run nms_fixed under vmap."""
    def plain(b, s):
        return jax.vmap(
            lambda bb, ss: nms_fixed(bb, ss, iou_threshold, max_out)
        )(b, s)

    if not uses_kernel(boxes.shape[1]):
        return plain(boxes, masked_scores)
    from .pallas_nms import nms_pallas

    return jax.lax.platform_dependent(
        boxes, masked_scores,
        default=plain,
        cuda=lambda b, s: nms_pallas(b, s, iou_threshold, max_out),
    )


def uses_kernel(num_candidates: int) -> bool:
    """Whether greedy_nms runs the GPU kernel for K candidates."""
    from .pallas_nms import MAX_K, next_pow2

    return next_pow2(num_candidates) <= MAX_K


def batched_nms(
    boxes: jnp.ndarray,  # (K, 4)
    scores: jnp.ndarray,  # (K,)
    classes: jnp.ndarray,  # (K,) int32
    valid: jnp.ndarray,  # (K,) bool candidate validity
    iou_threshold: float,
    max_out: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Class-wise NMS via coordinate offsets; returns (indices, valid)."""
    idx, keep = batched_nms_multi(
        boxes[None], scores[None], classes[None], valid[None],
        iou_threshold, max_out,
    )
    return idx[0], keep[0]


def batched_nms_multi(
    boxes: jnp.ndarray,  # (N, K, 4)
    scores: jnp.ndarray,  # (N, K)
    classes: jnp.ndarray,  # (N, K) int32
    valid: jnp.ndarray,  # (N, K) bool
    iou_threshold: float,
    max_out: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Class-wise NMS over N independent problems at once (one kernel
    program per problem on a GPU); per problem the result of batched_nms."""
    span = (
        jnp.max(
            jnp.where(valid, boxes[..., 2:4].max(axis=-1), 0.0),
            axis=1, keepdims=True,
        )
        + 1.0
    )  # (N, 1) per-problem offset span
    shifted = boxes + (classes.astype(jnp.float32) * span)[..., None]
    masked = jnp.where(valid, scores, NEG_INF)
    return greedy_nms(shifted, masked, iou_threshold, max_out)


def soft_nms(
    boxes: jnp.ndarray,
    scores: jnp.ndarray,
    sigma: float = 0.5,
    overlap_thresh: float = 0.3,
    score_thresh: float = 0.001,
    method: str = "linear",
    max_out: int = 100,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Soft-NMS (ref: cython_nms.pyx soft_nms, boxes.py:321-331).

    Returns (indices (max_out,), rescored (max_out,), valid (max_out,)).
    """
    boxes = boxes.astype(jnp.float32)
    cur_scores = scores.astype(jnp.float32)

    def body(i, state):
        cur, out_idx, out_score, out_valid = state
        pick = jnp.argmax(cur)
        pick_score = cur[pick]
        valid = pick_score > score_thresh
        iou = _iou_one_vs_all(boxes[pick], boxes)
        if method == "linear":
            weight = jnp.where(iou > overlap_thresh, 1.0 - iou, 1.0)
        elif method == "gaussian":
            weight = jnp.exp(-(iou * iou) / sigma)
        else:  # 'hard' == classic NMS
            weight = jnp.where(iou > overlap_thresh, 0.0, 1.0)
        cur = jnp.where(valid, cur * weight, cur)
        cur = jnp.where(valid, cur.at[pick].set(NEG_INF), cur)
        out_idx = out_idx.at[i].set(jnp.where(valid, pick, 0))
        out_score = out_score.at[i].set(jnp.where(valid, pick_score, 0.0))
        out_valid = out_valid.at[i].set(valid)
        return cur, out_idx, out_score, out_valid

    init = (
        cur_scores,
        jnp.zeros((max_out,), jnp.int32),
        jnp.zeros((max_out,), jnp.float32),
        jnp.zeros((max_out,), bool),
    )
    _, out_idx, out_score, out_valid = jax.lax.fori_loop(0, max_out, body, init)
    return out_idx, out_score, out_valid
