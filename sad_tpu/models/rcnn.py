"""Faster/Mask/Keypoint R-CNN and RPN model family (inherited surface).

Capability-equivalent to detectron/lib/modeling/{rpn_heads, fast_rcnn_heads,
mask_rcnn_heads, keypoint_rcnn_heads}.py and the generalized_rcnn builder
(model_builder.py:74-92), redesigned: proposals are generated on device
with static shapes (sad_tpu.ops.proposals) and every RoI stage is a fixed-R
batched tensor program; there is no graph surgery, Python net ops, or
CollectAndDistribute blob shuffling.

Module names mirror reference blob names (conv_rpn_fpn2 shared across levels,
rpn_cls_logits_fpn2, fc6/fc7, cls_score, bbox_pred, _[mask]_fcn1..4,
conv5_mask, mask_fcn_logits, conv_fcn1.., kps_score_*) so the checkpoint
converter applies unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import nn
from sad_tpu.config import Config

from .arch import arch_from_config
from .fpn import FPNRetinaNetBackbone, upsample_nearest_2x
from .resnet import _conv


class RPNHead(nn.Module):
    """FPN RPN head: one 3x3 conv + objectness/delta 1x1s, weights shared
    across levels (ref: rpn_heads.py add_fpn_rpn_outputs; shared via
    ConvShared like the RetinaNet towers)."""

    dim: int
    num_anchors: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, features: Dict[int, jnp.ndarray]):
        gauss = nn.initializers.normal(stddev=0.01)
        zero = nn.initializers.zeros
        k_min = min(features)
        conv = _conv(
            f"conv_rpn_fpn{k_min}", self.dim, 3, 1, use_bias=True,
            dtype=self.dtype, kernel_init=gauss, bias_init=zero,
        )
        cls = _conv(
            f"rpn_cls_logits_fpn{k_min}", self.num_anchors, 1, 1,
            use_bias=True, dtype=self.dtype, kernel_init=gauss, bias_init=zero,
        )
        bbox = _conv(
            f"rpn_bbox_pred_fpn{k_min}", 4 * self.num_anchors, 1, 1,
            use_bias=True, dtype=self.dtype, kernel_init=gauss, bias_init=zero,
        )
        logits, deltas = {}, {}
        for lvl, x in features.items():
            h = nn.relu(conv(x))
            logits[lvl] = cls(h).astype(jnp.float32)
            deltas[lvl] = bbox(h).astype(jnp.float32)
        return logits, deltas


class FastRCNNBoxHead(nn.Module):
    """2-FC box head + cls/bbox outputs (ref: fast_rcnn_heads.py
    add_roi_2mlp_head + add_fast_rcnn_outputs)."""

    mlp_dim: int
    num_classes: int
    cls_agnostic_bbox: bool = False
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, roi_feats: jnp.ndarray):  # (R, res, res, C)
        r = roi_feats.shape[0]
        x = roi_feats.reshape(r, -1).astype(self.dtype)
        x = nn.relu(nn.Dense(self.mlp_dim, dtype=self.dtype,
                             param_dtype=jnp.float32, name="fc6")(x))
        x = nn.relu(nn.Dense(self.mlp_dim, dtype=self.dtype,
                             param_dtype=jnp.float32, name="fc7")(x))
        cls_score = nn.Dense(
            self.num_classes, dtype=self.dtype, param_dtype=jnp.float32,
            kernel_init=nn.initializers.normal(0.01), name="cls_score",
        )(x).astype(jnp.float32)
        bbox_dim = 8 if self.cls_agnostic_bbox else 4 * self.num_classes
        bbox_pred = nn.Dense(
            bbox_dim, dtype=self.dtype, param_dtype=jnp.float32,
            kernel_init=nn.initializers.normal(0.001), name="bbox_pred",
        )(x).astype(jnp.float32)
        return cls_score, bbox_pred


class MaskHead(nn.Module):
    """Mask head family (ref: mask_rcnn_heads.py):
    - num_convs=4 -> mask_rcnn_fcn_head_v1up4convs (4x conv 3x3),
    - num_convs=0 -> mask_rcnn_fcn_head_v1up (deconv only),
    then 2x deconv and either 1x1 per-class conv logits or, with
    use_fc_output, a dense layer emitting the mask grid
    (MRCNN.USE_FC_OUTPUT)."""

    dim: int
    num_classes: int
    cls_specific: bool = True
    num_convs: int = 4
    use_fc_output: bool = False
    resolution: int = 28
    conv_init: str = "GaussianFill"
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, roi_feats: jnp.ndarray):  # (R, res, res, C)
        x = roi_feats.astype(self.dtype)
        gauss = nn.initializers.normal(0.001)
        # MRCNN.CONV_INIT (mask_rcnn_heads.py:150/165/207: std 0.001 for
        # gauss; MSRAFill = Caffe2 filler_op.h normal sqrt(2/fan_out))
        if self.conv_init == "MSRAFill":
            conv_w = nn.initializers.variance_scaling(
                2.0, "fan_out", "normal"
            )
        elif self.conv_init == "GaussianFill":
            conv_w = gauss
        else:
            raise ValueError(f"Unknown MRCNN.CONV_INIT: {self.conv_init!r}")
        for i in range(self.num_convs):
            x = nn.relu(
                _conv(f"_[mask]_fcn{i + 1}", self.dim, 3, 1, use_bias=True,
                      dtype=self.dtype, kernel_init=conv_w)(x)
            )
        out_dim = self.num_classes if self.cls_specific else 1
        if self.use_fc_output:
            # FC output always uses gauss 0.001 (mask_rcnn_heads.py:52-60)
            r = x.shape[0]
            flat = x.reshape(r, -1)
            m = self.resolution
            out = nn.Dense(
                out_dim * m * m, dtype=self.dtype, param_dtype=jnp.float32,
                kernel_init=gauss, name="mask_fcn_logits",
            )(flat)
            return out.reshape(r, m, m, out_dim).astype(jnp.float32)
        x = nn.relu(
            nn.ConvTranspose(
                self.dim, (2, 2), strides=(2, 2), dtype=self.dtype,
                param_dtype=jnp.float32, kernel_init=conv_w,
                name="conv5_mask",
            )(x)
        )
        # class-agnostic logits keep GaussianFill: fan-in fills "can be too
        # large in this case and cause divergence" (mask_rcnn_heads.py:63-66)
        logits_w = conv_w if self.cls_specific else gauss
        return _conv(
            "mask_fcn_logits", out_dim, 1, 1, use_bias=True,
            dtype=self.dtype, kernel_init=logits_w,
        )(x).astype(jnp.float32)


class KeypointHead(nn.Module):
    """add_roi_pose_head_v1convX + deconv output (ref:
    keypoint_rcnn_heads.py): NUM_STACKED_CONVS x conv CONV_HEAD_KERNEL ->
    deconv 2x (-> optional 2x upsample) -> per-keypoint heatmap logits.

    conv_init mirrors KRCNN.CONV_INIT: 'GaussianFill' (std 0.01 convs /
    0.001 output, keypoint_rcnn_heads.py:210/83) or 'MSRAFill' (Caffe2
    filler_op.h:462-475: normal with std sqrt(2/fan_out),
    fan_out = out_channels * receptive field — jax variance_scaling
    (2.0, 'fan_out', 'normal'))."""

    dim: int
    num_keypoints: int
    num_convs: int = 8
    up_scale: int = 2
    use_deconv_output: bool = True
    conv_init: str = "GaussianFill"
    kernel: int = 3
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, roi_feats: jnp.ndarray):
        x = roi_feats.astype(self.dtype)
        if self.conv_init == "MSRAFill":
            conv_w = out_w = nn.initializers.variance_scaling(
                2.0, "fan_out", "normal"
            )
        elif self.conv_init == "GaussianFill":
            conv_w = nn.initializers.normal(0.01)
            out_w = nn.initializers.normal(0.001)
        else:
            raise ValueError(
                f"Unknown KRCNN.CONV_INIT: {self.conv_init!r}"
            )
        for i in range(self.num_convs):
            x = nn.relu(
                _conv(f"conv_fcn{i + 1}", self.dim, self.kernel, 1,
                      use_bias=True, dtype=self.dtype, kernel_init=conv_w)(x)
            )
        x = nn.ConvTranspose(
            self.num_keypoints, (4, 4), strides=(2, 2), dtype=self.dtype,
            param_dtype=jnp.float32, kernel_init=out_w,
            name="kps_score_lowres",
        )(x)
        if self.use_deconv_output and self.up_scale > 1:
            n, h, w, c = x.shape
            for _ in range(int(np.log2(self.up_scale))):
                x = upsample_nearest_2x(x)
        return x.astype(jnp.float32)


class GeneralizedRCNN(nn.Module):
    """FPN backbone + RPN + box/mask/keypoint RoI heads.

    __call__(images, im_hw) runs backbone + RPN + proposal generation +
    the box head (the Faster R-CNN inference path, model_builder.py:74-92).
    Mask/keypoint heads run via apply(..., method='mask_heads'/'keypoint
    _heads') on chosen rois, mirroring the reference's cascaded SuffixNet
    inference (utils/c2.py:51).
    """

    cfg_static: Any  # a Config (hashable frozen dataclass)

    def setup(self):
        cfg = self.cfg_static
        self.arch = arch_from_config(cfg)
        self.fpn = FPNRetinaNetBackbone(self.arch, name="fpn")
        na = len(cfg.FPN.RPN_ASPECT_RATIOS)
        self.rpn = RPNHead(
            self.arch.fpn_dim, na, dtype=jnp.dtype(self.arch.compute_dtype),
            name="rpn",
        )
        self.box_head = FastRCNNBoxHead(
            cfg.FAST_RCNN.MLP_HEAD_DIM,
            cfg.MODEL.NUM_CLASSES,
            cfg.MODEL.CLS_AGNOSTIC_BBOX_REG,
            dtype=jnp.dtype(self.arch.compute_dtype),
            name="box_head",
        )
        if cfg.MODEL.MASK_ON:
            head_name = cfg.MRCNN.ROI_MASK_HEAD
            n_convs = 4 if "4convs" in head_name else (
                2 if "2convs" in head_name else 0
            ) if "v1up" in head_name else 4
            self.mask_head = MaskHead(
                cfg.MRCNN.DIM_REDUCED, cfg.MODEL.NUM_CLASSES,
                cfg.MRCNN.CLS_SPECIFIC_MASK,
                num_convs=n_convs,
                use_fc_output=cfg.MRCNN.USE_FC_OUTPUT,
                resolution=cfg.MRCNN.RESOLUTION,
                conv_init=cfg.MRCNN.CONV_INIT,
                dtype=jnp.dtype(self.arch.compute_dtype), name="mask_head",
            )
        if cfg.MODEL.KEYPOINTS_ON:
            self.kps_head = KeypointHead(
                cfg.KRCNN.CONV_HEAD_DIM, cfg.KRCNN.NUM_KEYPOINTS,
                cfg.KRCNN.NUM_STACKED_CONVS, cfg.KRCNN.UP_SCALE,
                cfg.KRCNN.USE_DECONV_OUTPUT,
                conv_init=cfg.KRCNN.CONV_INIT,
                kernel=cfg.KRCNN.CONV_HEAD_KERNEL,
                dtype=jnp.dtype(self.arch.compute_dtype), name="kps_head",
            )

    def _rpn_levels(self, cfg) -> Tuple[int, ...]:
        return tuple(range(cfg.FPN.RPN_MIN_LEVEL, cfg.FPN.RPN_MAX_LEVEL + 1))

    def backbone(self, images):
        return self.fpn(images)

    def __call__(self, images: jnp.ndarray, im_hw: jnp.ndarray):
        """images (B, H, W, 3); im_hw (B, 2). Returns per-image proposals
        and box-head outputs with static shapes."""
        from sad_tpu.data.anchors import field_of_anchors
        from sad_tpu.ops.proposals import (
            collect_and_distribute_fpn_proposals,
            multilevel_roi_align,
            nms_levels_batched,
            proposal_candidates,
        )

        cfg = self.cfg_static
        feats = self.fpn(images)
        rpn_levels = self._rpn_levels(cfg)
        rpn_feats = {l: feats[l] for l in rpn_levels if l in feats}
        logits, deltas = self.rpn(rpn_feats)

        b = images.shape[0]
        na = len(cfg.FPN.RPN_ASPECT_RATIOS)

        # candidates per (level, image) under vmap; ONE greedy-NMS call
        # over all level x image problems
        # (ops/proposals.nms_levels_batched). PRE/POST_NMS_TOP_N are per
        # FPN level in the reference (collect step caps globally after).
        prop_levels = []
        for lvl in rpn_feats:
            h, w = rpn_feats[lvl].shape[1:3]
            stride = 2.0 ** lvl
            size = cfg.FPN.RPN_ANCHOR_START_SIZE * (
                2 ** (lvl - cfg.FPN.RPN_MIN_LEVEL)
            )
            cell = np.concatenate(
                [
                    # one size, all aspect ratios (rpn_heads.py FPN path)
                    _np_cell_anchors(stride, size, ar)
                    for ar in cfg.FPN.RPN_ASPECT_RATIOS
                ]
            )
            anchors = jnp.asarray(
                field_of_anchors(cell, stride, h, w), jnp.float32
            )
            scores = jax.nn.sigmoid(logits[lvl])
            d = deltas[lvl].reshape(b, h, w, na, 4)
            bx, ts, ms = jax.vmap(
                lambda s, dd, ihw, a=anchors: proposal_candidates(
                    s, dd, a, ihw,
                    cfg.TEST.RPN_PRE_NMS_TOP_N,
                    float(cfg.TEST.RPN_MIN_SIZE),
                    exact_topk=cfg.RPN.EXACT_TOPK,
                )
            )(scores, d, im_hw)
            prop_levels.append((lvl, bx, ts, ms))

        lv_b, lv_s, lv_v = nms_levels_batched(
            prop_levels, cfg.TEST.RPN_NMS_THRESH, cfg.TEST.RPN_POST_NMS_TOP_N
        )

        def per_image(lvb, lvs, lvv):
            return collect_and_distribute_fpn_proposals(
                lvb, lvs, lvv,
                cfg.TEST.RPN_POST_NMS_TOP_N,
                cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
                cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL,
            )

        boxes, scores, valid, roi_lvls = jax.vmap(per_image)(lv_b, lv_s, lv_v)

        # box head over all images' rois at once
        r = boxes.shape[1]
        batch_col = jnp.repeat(jnp.arange(b, dtype=jnp.float32), r)[:, None]
        flat_rois = jnp.concatenate([batch_col, boxes.reshape(-1, 4)], axis=1)
        roi_feats = multilevel_roi_align(
            {l: feats[l] for l in range(cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL + 1) if l in feats},
            flat_rois,
            roi_lvls.reshape(-1),
            valid.reshape(-1),
            cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
            cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO,
            slots_per_im=r,  # flat_rois is image-major by construction
        )
        cls_score, bbox_pred = self.box_head(roi_feats)
        return {
            "rois": boxes,  # (B, R, 4)
            "roi_scores": scores,
            "roi_valid": valid,
            "roi_levels": roi_lvls,
            "cls_score": cls_score.reshape(b, r, -1),
            "cls_prob": jax.nn.softmax(cls_score.reshape(b, r, -1), axis=-1),
            "bbox_pred": bbox_pred.reshape(b, r, -1),
            "features": feats,
        }

    def mask_heads(self, roi_feats: jnp.ndarray):
        return self.mask_head(roi_feats)

    def keypoint_heads(self, roi_feats: jnp.ndarray):
        return self.kps_head(roi_feats)

    def init_all(self, images: jnp.ndarray, im_hw: jnp.ndarray):
        """Initialization entry that touches every head (``__call__`` alone
        never runs the mask/keypoint heads, so their params would not exist).
        Use ``model.init(rng, images, im_hw, method='init_all')``."""
        cfg = self.cfg_static
        out = self(images, im_hw)
        if cfg.MODEL.MASK_ON:
            dummy = jnp.zeros(
                (1, cfg.MRCNN.ROI_XFORM_RESOLUTION,
                 cfg.MRCNN.ROI_XFORM_RESOLUTION, self.arch.fpn_dim),
                jnp.float32,
            )
            self.mask_head(dummy)
        if cfg.MODEL.KEYPOINTS_ON:
            dummy = jnp.zeros(
                (1, cfg.KRCNN.ROI_XFORM_RESOLUTION,
                 cfg.KRCNN.ROI_XFORM_RESOLUTION, self.arch.fpn_dim),
                jnp.float32,
            )
            self.kps_head(dummy)
        return out


def _np_cell_anchors(stride: float, size: float, aspect_ratio: float) -> np.ndarray:
    from sad_tpu.data.anchors import generate_cell_anchors

    return generate_cell_anchors(stride, (size,), (aspect_ratio,))
