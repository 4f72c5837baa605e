"""Keypoint utilities (ref: detectron/lib/utils/keypoints.py).

COCO 17-keypoint metadata, horizontal-flip index mapping, and heatmap ->
keypoint decoding for inference (heatmaps_to_keypoints)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from sad_tpu.utils.env import optional_module

COCO_KEYPOINTS = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]


def get_keypoints() -> Tuple[List[str], dict]:
    """Names + flip map (ref: keypoints.py get_keypoints)."""
    flip_map = {}
    for name in COCO_KEYPOINTS:
        if name.startswith("left_"):
            flip_map[name] = "right_" + name[5:]
            flip_map["right_" + name[5:]] = name
    return COCO_KEYPOINTS, flip_map


def flip_idx_for_names(names: List[str]) -> np.ndarray:
    """Index permutation applying the left/right swap for an arbitrary
    keypoint-name list (pairs matched by left_/right_ prefix — the same
    correspondence the reference hard-codes for COCO in
    keypoints.py:53-62 and applies at roidb flip time via
    flip_keypoints, keypoints.py:71-86)."""
    idx = np.arange(len(names))
    lookup = {n: i for i, n in enumerate(names)}
    for i, n in enumerate(names):
        if n.startswith("left_") and ("right_" + n[5:]) in lookup:
            j = lookup["right_" + n[5:]]
            idx[i], idx[j] = j, i
    return idx


def flip_keypoint_channels() -> np.ndarray:
    """Index permutation applying the left/right swap (COCO 17)."""
    return flip_idx_for_names(COCO_KEYPOINTS)


def _cubic_weights(frac: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys bicubic kernel weights at taps -1..2 for per-pixel fraction
    `frac` (cv2 INTER_CUBIC uses a=-0.75). Returns (N, 4); rows sum to 1."""
    d = np.abs(frac[:, None] - np.arange(-1, 3)[None, :])
    near = (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1
    far = a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a
    return np.where(d <= 1, near, np.where(d < 2, far, 0.0))


def _resize_bicubic(m: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """cv2.resize(..., INTER_CUBIC) semantics on an (S, S, K) float map:
    half-pixel sampling grid, Keys a=-0.75 kernel, clamped borders.
    Delegates to real cv2 when importable (verified equal within float
    tolerance, tests/test_aux_surface.py); numpy path = fallback/oracle."""
    cv2 = optional_module("cv2")  # fast C path; the numpy kernel is the oracle
    if cv2 is not None:
        out = cv2.resize(
            np.ascontiguousarray(m), (out_w, out_h),
            interpolation=cv2.INTER_CUBIC,
        )
        if out.ndim == 2:  # cv2 drops a size-1 channel dim
            out = out[:, :, None]
        return out
    in_h, in_w = m.shape[:2]

    def axis(out_n, in_n):
        src = (np.arange(out_n) + 0.5) * in_n / out_n - 0.5
        i0 = np.floor(src).astype(np.int64)
        w = _cubic_weights(src - i0).astype(np.float32)
        idx = np.clip(i0[:, None] + np.arange(-1, 3)[None, :], 0, in_n - 1)
        return idx, w

    iy, wy = axis(out_h, in_h)
    ix, wx = axis(out_w, in_w)
    # accumulate per tap: peak memory one (out, in, K) plane instead of a
    # 4x-taps intermediate (matters for large-roi keypoint decodes)
    k = m.shape[2]
    tmp = np.zeros((out_h, in_w, k), np.float32)
    for t in range(4):
        tmp += m[iy[:, t]] * wy[:, t, None, None]
    out = np.zeros((out_h, out_w, k), np.float32)
    for t in range(4):
        out += tmp[:, ix[:, t]] * wx[None, :, t, None]
    return out


def heatmaps_to_keypoints(
    heatmaps: np.ndarray,  # (R, S, S, K) logits
    rois: np.ndarray,  # (R, 4) xyxy in image coords
    min_size: float = 0.0,  # cfg.KRCNN.INFERENCE_MIN_SIZE
) -> np.ndarray:
    """Decode per-roi heatmaps to keypoint (x, y, logit, prob) rows
    (ref: keypoints.py heatmaps_to_keypoints:103-158). The heatmap is
    bicubic-UPSAMPLED to the roi's pixel extent (ceil(w) x ceil(h), floored
    at INFERENCE_MIN_SIZE) before the per-channel argmax — pixel-precise
    locations, not heatmap-cell centers. prob comes from a softmax over the
    RESIZED map (scores_to_probs). Interpolation matches cv2 INTER_CUBIC
    (Keys a=-0.75, half-pixel grid, clamped borders). Returns (R, 4, K)."""
    r, s, _, k = heatmaps.shape
    out = np.zeros((r, 4, k), np.float32)
    offset_x = rois[:, 0]
    offset_y = rois[:, 1]
    widths = np.maximum(rois[:, 2] - rois[:, 0], 1.0)
    heights = np.maximum(rois[:, 3] - rois[:, 1], 1.0)
    widths_ceil = np.ceil(widths)
    heights_ceil = np.ceil(heights)
    for i in range(r):
        if min_size > 0:
            w = int(max(widths_ceil[i], min_size))
            h = int(max(heights_ceil[i], min_size))
        else:
            w = int(widths_ceil[i])
            h = int(heights_ceil[i])
        width_correction = widths[i] / w
        height_correction = heights[i] / h
        roi_map = _resize_bicubic(
            np.asarray(heatmaps[i], np.float32), h, w
        )  # (h, w, K)
        flat = roi_map.reshape(-1, k)
        pos = flat.argmax(axis=0)
        py, px = np.divmod(pos, w)
        e = np.exp(flat - flat.max(axis=0, keepdims=True))
        prob = (e / e.sum(axis=0, keepdims=True))[pos, np.arange(k)]
        out[i, 0] = (px + 0.5) * width_correction + offset_x[i]
        out[i, 1] = (py + 0.5) * height_correction + offset_y[i]
        out[i, 2] = flat[pos, np.arange(k)]
        out[i, 3] = prob
    return out


# COCO 17-keypoint OKS sigmas (ref: keypoints.py compute_oks)
_OKS_SIGMAS = np.array(
    [.26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
     .87, .87, .89, .89], np.float64
) / 10.0


def compute_oks(
    src_keypoints: np.ndarray,  # (4, K) decoded rows [x, y, logit, prob]
    src_roi: np.ndarray,  # (4,)
    dst_keypoints: np.ndarray,  # (N, 4, K)
    dst_roi: np.ndarray,  # (N, 4)
) -> np.ndarray:
    """OKS of each dst prediction wrt src (ref: keypoints.py compute_oks:
    src-roi area, all keypoints counted, mean of exp terms)."""
    k = src_keypoints.shape[1]
    sig = _OKS_SIGMAS if k == 17 else np.full(k, 0.05)
    vars_ = (sig * 2) ** 2
    src_area = (
        (src_roi[2] - src_roi[0] + 1) * (src_roi[3] - src_roi[1] + 1)
    )
    dx = dst_keypoints[:, 0, :] - src_keypoints[0, :]
    dy = dst_keypoints[:, 1, :] - src_keypoints[1, :]
    e = (dx ** 2 + dy ** 2) / vars_ / (src_area + np.spacing(1)) / 2
    return np.sum(np.exp(-e), axis=1) / e.shape[1]


def nms_oks(
    kp_predictions: np.ndarray,  # (N, 4, K) heatmaps_to_keypoints rows
    rois: np.ndarray,  # (N, 4)
    thresh: float,
) -> list:
    """Greedy NMS on keypoint predictions ranked by mean logit
    (ref: keypoints.py nms_oks; test.py keypoint_results applies it with
    thresh=0.3 when KRCNN.NMS_OKS)."""
    scores = np.mean(kp_predictions[:, 2, :], axis=1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        ovr = compute_oks(
            kp_predictions[i], rois[i], kp_predictions[order[1:]],
            rois[order[1:]],
        )
        inds = np.where(ovr <= thresh)[0]
        order = order[inds + 1]
    return keep
