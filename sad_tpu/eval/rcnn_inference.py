"""Fast/Faster R-CNN box inference decode — batched, on device.

Capability-equivalent to detectron/lib/core/test.py im_detect_bbox +
box_results_with_nms_and_limit (test.py:52-193): softmax class scores,
per-class delta decode with MODEL.BBOX_REG_WEIGHTS, score threshold,
class-wise NMS (or soft-NMS on host), global top DETECTIONS_PER_IM.
"""

from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp

from sad_tpu.config import Config
from sad_tpu.ops.box_transforms import bbox_transform, clip_boxes


def decode_rcnn_detections(
    cfg: Config,
    rois: jnp.ndarray,  # (B, R, 4) in network-input coords
    roi_valid: jnp.ndarray,  # (B, R)
    cls_prob: jnp.ndarray,  # (B, R, C)
    bbox_pred: jnp.ndarray,  # (B, R, 4C) or (B, R, 8) cls-agnostic
    im_hw: jnp.ndarray,  # (B, 2) original sizes
    im_scale: jnp.ndarray,  # (B,)
) -> Dict[str, jnp.ndarray]:
    """Returns (B, DETECTIONS_PER_IM) 'boxes'/'scores'/'classes'/'valid'."""
    num_classes = cls_prob.shape[-1]
    cls_agnostic = cfg.MODEL.CLS_AGNOSTIC_BBOX_REG

    def one_image(boxes, valid, probs, deltas, hw, scale):
        r = boxes.shape[0]
        fg = num_classes - 1
        # per (roi, fg class) candidates
        if cls_agnostic:
            d = jnp.broadcast_to(deltas[:, None, 4:8], (r, fg, 4))
        else:
            d = deltas.reshape(r, num_classes, 4)[:, 1:, :]
        b = jnp.broadcast_to(boxes[:, None, :], (r, fg, 4)).reshape(-1, 4)
        decoded = bbox_transform(
            b, d.reshape(-1, 4), cfg.MODEL.BBOX_REG_WEIGHTS
        )
        if not cfg.TEST.BBOX_REG:
            decoded = b
        decoded = decoded / scale
        h, w = hw[0], hw[1]
        decoded = clip_boxes(decoded, h, w)

        scores = probs[:, 1:].reshape(-1)
        classes = jnp.broadcast_to(
            jnp.arange(fg)[None, :], (r, fg)
        ).reshape(-1)
        cand_valid = (
            jnp.broadcast_to(valid[:, None], (r, fg)).reshape(-1)
            & (scores > cfg.TEST.SCORE_THRESH)
        )
        return decoded, scores, classes, cand_valid

    # one class-wise NMS call over the whole batch (identical per-image
    # results)
    from sad_tpu.ops.nms import batched_nms_multi

    boxes_b, scores_b, classes_b, valid_b = jax.vmap(one_image)(
        rois, roi_valid, cls_prob, bbox_pred, im_hw, im_scale
    )
    cand_k = cfg.TEST.NMS_CAND_TOPK
    if cand_k and cand_k < boxes_b.shape[1]:
        # exact top-k candidate cut before NMS (see TEST.NMS_CAND_TOPK):
        # invalid slots carry -inf scores, so whenever <= cand_k candidates
        # clear SCORE_THRESH the kept set is bit-identical to the full NMS
        from sad_tpu.ops.nms import NEG_INF
        from sad_tpu.ops.topk import top_k

        masked = jnp.where(valid_b, scores_b, NEG_INF)
        _, sel = top_k(masked, cand_k, exact=True)
        boxes_b = jnp.take_along_axis(boxes_b, sel[..., None], axis=1)
        scores_b = jnp.take_along_axis(scores_b, sel, axis=1)
        classes_b = jnp.take_along_axis(classes_b, sel, axis=1)
        valid_b = jnp.take_along_axis(valid_b, sel, axis=1)
    keep_idx, keep_valid = batched_nms_multi(
        boxes_b, scores_b, classes_b, valid_b,
        cfg.TEST.NMS, cfg.TEST.DETECTIONS_PER_IM,
    )
    kept_boxes = jnp.take_along_axis(boxes_b, keep_idx[..., None], axis=1)
    kept_scores = jnp.take_along_axis(scores_b, keep_idx, axis=1)
    kept_classes = jnp.take_along_axis(classes_b, keep_idx, axis=1)
    # invalid slots gather whatever candidate the kernel's idx-0 padding
    # points at — zero them so outputs are deterministic regardless of the
    # candidate ordering (consumers filter on 'valid' either way)
    kept_boxes = jnp.where(keep_valid[..., None], kept_boxes, 0.0)
    return {
        "boxes": kept_boxes,
        "scores": jnp.where(keep_valid, kept_scores, 0.0),
        "classes": jnp.where(keep_valid, kept_classes + 1, 0),
        "valid": keep_valid,
    }


def make_rcnn_inference_fn(cfg: Config, model) -> Callable:
    """Jitted Faster R-CNN end-to-end: images -> detections (+ optional
    mask/keypoint head outputs on the kept boxes).

    With MODEL.FASTER_RCNN False (pure Fast R-CNN: precomputed
    selective-search/RPN proposals, ref test.py im_detect_bbox `boxes`
    input), pass `proposals` (B, P, 4) in network-input coords and
    `prop_valid` (B, P); the RPN is skipped and the box head runs on the
    given boxes."""

    precomputed = (
        not cfg.MODEL.FASTER_RCNN and cfg.MODEL.TYPE == "generalized_rcnn"
    )

    def infer(params, images, im_hw, im_scale, content_hw=None,
              proposals=None, prop_valid=None):
        from .inference import device_normalize

        images = device_normalize(cfg, images, content_hw)
        if precomputed:
            if proposals is None or prop_valid is None:
                raise ValueError(
                    "MODEL.FASTER_RCNN=False (pure Fast R-CNN) needs "
                    "precomputed proposals — pass proposals/prop_valid "
                    "(set TEST.PROPOSAL_FILES)"
                )
            b, r = proposals.shape[:2]
            feats = model.apply({"params": params}, images, method="backbone")
            batch_col = jnp.repeat(
                jnp.arange(b, dtype=jnp.float32), r
            )[:, None]
            flat = jnp.concatenate(
                [batch_col, proposals.reshape(-1, 4)], axis=1
            )
            if cfg.FPN.FPN_ON:
                from sad_tpu.ops.proposals import (
                    map_rois_to_fpn_levels,
                    multilevel_roi_align,
                )

                lvls = jax.vmap(
                    lambda bx: map_rois_to_fpn_levels(
                        bx, cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
                        cfg.FPN.ROI_CANONICAL_SCALE,
                        cfg.FPN.ROI_CANONICAL_LEVEL,
                    )
                )(proposals)
                fd = {
                    l: feats[l]
                    for l in range(
                        cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL + 1
                    )
                    if l in feats
                }
                roi_feats = multilevel_roi_align(
                    fd, flat, lvls.reshape(-1), prop_valid.reshape(-1),
                    cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
                    cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO,
                    slots_per_im=r,  # flat is image-major by construction
                )
                cls_score, bbox_pred = model.apply(
                    {"params": params}, roi_feats,
                    method=lambda m, f: m.box_head(f),
                )
            else:
                cls_score, bbox_pred = model.apply(
                    {"params": params}, feats, flat, method="box_forward"
                )
            out = {
                "rois": proposals,
                "roi_valid": prop_valid,
                "cls_prob": jax.nn.softmax(
                    cls_score.reshape(b, r, -1), axis=-1
                ),
                "bbox_pred": bbox_pred.reshape(b, r, -1),
                "features": feats,
            }
        else:
            out = model.apply({"params": params}, images, im_hw)
        dets = decode_rcnn_detections(
            cfg,
            out["rois"],
            out["roi_valid"],
            out["cls_prob"],
            out["bbox_pred"],
            im_hw,
            im_scale,
        )
        if (cfg.MODEL.MASK_ON or cfg.MODEL.KEYPOINTS_ON) and not cfg.FPN.FPN_ON:
            # single-scale (C4) cascaded mask inference: re-run the res5
            # mask head on the kept boxes (ref: mask_rcnn_heads.py:173-196,
            # "inference is cascaded")
            b, k = dets["boxes"].shape[:2]
            net_boxes = dets["boxes"] * im_scale[:, None, None]
            batch_col = jnp.repeat(
                jnp.arange(b, dtype=jnp.float32), k
            )[:, None]
            flat = jnp.concatenate([batch_col, net_boxes.reshape(-1, 4)], axis=1)
            if cfg.MODEL.MASK_ON:
                logits = model.apply(
                    {"params": params}, out["features"], flat,
                    method="mask_heads",
                )
                dets["mask_prob"] = jax.nn.sigmoid(logits).reshape(
                    (b, k) + logits.shape[1:]
                )
            return dets
        if cfg.MODEL.MASK_ON or cfg.MODEL.KEYPOINTS_ON:
            from sad_tpu.ops.proposals import (
                map_rois_to_fpn_levels,
                multilevel_roi_align,
            )

            b, k = dets["boxes"].shape[:2]
            # kept boxes back to network-input coords for RoIAlign
            net_boxes = dets["boxes"] * im_scale[:, None, None]
            lvls = jax.vmap(
                lambda bx: map_rois_to_fpn_levels(
                    bx, cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
                    cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL,
                )
            )(net_boxes)
            batch_col = jnp.repeat(
                jnp.arange(b, dtype=jnp.float32), k
            )[:, None]
            flat = jnp.concatenate([batch_col, net_boxes.reshape(-1, 4)], axis=1)
            feats = {
                l: out["features"][l]
                for l in range(cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL + 1)
                if l in out["features"]
            }
            if cfg.MODEL.MASK_ON:
                mf = multilevel_roi_align(
                    feats, flat, lvls.reshape(-1), dets["valid"].reshape(-1),
                    cfg.MRCNN.ROI_XFORM_RESOLUTION,
                    cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO,
                    slots_per_im=k,  # flat is image-major by construction
                )
                logits = model.apply(
                    {"params": params}, mf, method="mask_heads"
                )
                dets["mask_prob"] = jax.nn.sigmoid(logits).reshape(
                    (b, k) + logits.shape[1:]
                )
            if cfg.MODEL.KEYPOINTS_ON:
                kf = multilevel_roi_align(
                    feats, flat, lvls.reshape(-1), dets["valid"].reshape(-1),
                    cfg.KRCNN.ROI_XFORM_RESOLUTION,
                    cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO,
                    slots_per_im=k,  # flat is image-major by construction
                )
                hm = model.apply({"params": params}, kf, method="keypoint_heads")
                dets["kps_heatmaps"] = hm.reshape((b, k) + hm.shape[1:])
        return dets

    return jax.jit(infer)


def make_aux_on_boxes_fn(cfg: Config, model) -> Callable:
    """Jitted mask/keypoint heads on FIXED boxes — the cascaded
    im_detect_mask / im_detect_keypoints passes that mask/keypoint TTA
    re-runs on transformed images (ref: test.py:410-478, 582-665).

    aux(params, images, net_boxes (B,K,4 network-input coords), valid (B,K))
    -> {'mask_prob': (B,K,m,m,C)?, 'kps_heatmaps': (B,K,m,m,J)?}
    """

    def aux(params, images, net_boxes, valid, content_hw=None):
        from .inference import device_normalize

        images = device_normalize(cfg, images, content_hw)
        b, k = net_boxes.shape[:2]
        batch_col = jnp.repeat(jnp.arange(b, dtype=jnp.float32), k)[:, None]
        flat = jnp.concatenate([batch_col, net_boxes.reshape(-1, 4)], axis=1)
        out = {}
        feats = model.apply({"params": params}, images, method="backbone")
        if cfg.FPN.FPN_ON:
            from sad_tpu.ops.proposals import (
                map_rois_to_fpn_levels,
                multilevel_roi_align,
            )

            lvls = jax.vmap(
                lambda bx: map_rois_to_fpn_levels(
                    bx, cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
                    cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL,
                )
            )(net_boxes).reshape(-1)
            fd = {
                l: feats[l]
                for l in range(cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL + 1)
                if l in feats
            }
            if cfg.MODEL.MASK_ON:
                mf = multilevel_roi_align(
                    fd, flat, lvls, valid.reshape(-1),
                    cfg.MRCNN.ROI_XFORM_RESOLUTION,
                    cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO,
                    slots_per_im=k,  # flat is image-major by construction
                )
                logits = model.apply(
                    {"params": params}, mf, method="mask_heads"
                )
                out["mask_prob"] = jax.nn.sigmoid(logits).reshape(
                    (b, k) + logits.shape[1:]
                )
            if cfg.MODEL.KEYPOINTS_ON:
                kf = multilevel_roi_align(
                    fd, flat, lvls, valid.reshape(-1),
                    cfg.KRCNN.ROI_XFORM_RESOLUTION,
                    cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO,
                    slots_per_im=k,  # flat is image-major by construction
                )
                hm = model.apply(
                    {"params": params}, kf, method="keypoint_heads"
                )
                out["kps_heatmaps"] = hm.reshape((b, k) + hm.shape[1:])
        elif cfg.MODEL.MASK_ON:
            logits = model.apply(
                {"params": params}, feats, flat, method="mask_heads"
            )
            out["mask_prob"] = jax.nn.sigmoid(logits).reshape(
                (b, k) + logits.shape[1:]
            )
        return out

    return jax.jit(aux)
