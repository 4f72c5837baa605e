"""Single-scale (non-FPN) R-CNN family: VGG/C4 Faster R-CNN and R-FCN.

Capability-equivalent to the reference's non-FPN paths:
- add_single_scale_rpn_outputs (rpn_heads.py:55-123): one RPN head on the
  stride-16 feature with RPN.SIZES x RPN.ASPECT_RATIOS anchors,
- VGG16 fc6/fc7 RoI head (VGG16.py add_VGG16_roi_fc_head) and the generic
  box outputs,
- R-FCN (rfcn_heads.py): conv_new_1 + position-sensitive score/bbox maps,
  PSRoIPool, and average-vote over bins — built on
  sad_tpu.ops.detectron_ops.ps_roi_pool.
"""

from __future__ import annotations

from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


from . import nn
from .resnet import _conv
from .vgg import VGG16Body, VGGCNNM1024Body


class SingleScaleRPNHead(nn.Module):
    """RPN on one feature map (rpn_heads.py:55-123)."""

    dim: int
    num_anchors: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, feat: jnp.ndarray):
        gauss = nn.initializers.normal(stddev=0.01)
        h = nn.relu(
            _conv("conv_rpn", self.dim, 3, 1, use_bias=True,
                  dtype=self.dtype, kernel_init=gauss)(feat)
        )
        logits = _conv(
            "rpn_cls_logits", self.num_anchors, 1, 1, use_bias=True,
            dtype=self.dtype, kernel_init=gauss,
        )(h).astype(jnp.float32)
        deltas = _conv(
            "rpn_bbox_pred", 4 * self.num_anchors, 1, 1, use_bias=True,
            dtype=self.dtype, kernel_init=gauss,
        )(h).astype(jnp.float32)
        return logits, deltas


class RFCNHead(nn.Module):
    """Position-sensitive score maps + PSRoIPool voting (rfcn_heads.py)."""

    num_classes: int
    ps_grid: int = 7
    dim_reduce: int = 1024
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, feat: jnp.ndarray, rois5: jnp.ndarray):
        from sad_tpu.ops.detectron_ops import ps_roi_pool

        gauss = nn.initializers.normal(stddev=0.01)
        x = nn.relu(
            _conv("conv_new_1", self.dim_reduce, 1, 1, use_bias=True,
                  dtype=self.dtype, kernel_init=gauss)(feat)
        )
        k2 = self.ps_grid * self.ps_grid
        cls_maps = _conv(
            "rfcn_cls", k2 * self.num_classes, 1, 1, use_bias=True,
            dtype=self.dtype, kernel_init=gauss,
        )(x).astype(jnp.float32)
        bbox_maps = _conv(
            "rfcn_bbox", k2 * 8, 1, 1, use_bias=True,
            dtype=self.dtype, kernel_init=gauss,
        )(x).astype(jnp.float32)
        # PSRoIPool + vote (average over the ps grid)
        cls_pooled = ps_roi_pool(
            cls_maps, rois5, 1.0 / 16.0, self.ps_grid, self.num_classes
        )
        bbox_pooled = ps_roi_pool(
            bbox_maps, rois5, 1.0 / 16.0, self.ps_grid, 8
        )
        cls_score = cls_pooled.mean(axis=(1, 2))  # (R, C)
        bbox_pred = bbox_pooled.mean(axis=(1, 2))  # (R, 8) cls-agnostic
        return cls_score, bbox_pred


class ResNetRoIConv5Head(nn.Module):
    """res5 stage applied per RoI + average pool (ref: ResNet.py
    add_ResNet_roi_conv5_head): the C4 Faster R-CNN box head.

    With return_spatial=True the pre-pool (R, res/2, res/2, 2048) res5
    feature map is also returned — the v0upshare mask head reuses it at
    training time (ref: mask_rcnn_heads.py:173-213 SampleAs sharing)."""

    arch: Any
    resolution: int = 14
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, roi_feats: jnp.ndarray, return_spatial: bool = False):
        from .resnet import Bottleneck

        a = self.arch
        dims = a.stage_dims()
        dim_in = dims[2]  # res4 output
        dim_out = dims[3]
        inner = int(a.num_groups * a.width_per_group * a.channel_ratio) * 8
        stride_init = max(self.resolution // 7, 1)
        x = roi_feats.astype(self.dtype)
        for i in range(a.block_counts[-1] if len(a.block_counts) == 4 else 3):
            x = Bottleneck(
                prefix=f"res5_{i}",
                dim_in=dim_in if i == 0 else dim_out,
                dim_out=dim_out,
                dim_inner=inner,
                stride=stride_init if i == 0 else 1,
                groups=a.num_groups,
                dilation=1,
                stride_1x1=a.stride_1x1,
                dtype=self.dtype,
                fold=a.fold_affine,
            )(x)
        pooled = x.mean(axis=(1, 2))  # global average pool (res5_pool)
        if return_spatial:
            return pooled, x
        return pooled


class MaskV0UpOutput(nn.Module):
    """The v0up/v0upshare mask output stack on res5 RoI features:
    ConvTranspose 2x2/2 'conv5_mask' + relu, then the 1x1 per-class mask
    logits conv (ref: mask_rcnn_heads.py:46-90 add_mask_rcnn_outputs and
    173-240 v0upshare/v0up)."""

    dim_reduced: int
    num_classes: int
    cls_specific: bool = True
    conv_init: str = "GaussianFill"
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, res5_feats: jnp.ndarray):  # (R, r, r, 2048)
        gauss = nn.initializers.normal(0.001)
        if self.conv_init == "MSRAFill":
            conv_w = nn.initializers.variance_scaling(
                2.0, "fan_out", "normal"
            )
        elif self.conv_init == "GaussianFill":
            conv_w = gauss
        else:
            raise ValueError(f"Unknown MRCNN.CONV_INIT: {self.conv_init!r}")
        x = nn.relu(
            nn.ConvTranspose(
                self.dim_reduced, (2, 2), strides=(2, 2), dtype=self.dtype,
                param_dtype=jnp.float32, kernel_init=conv_w,
                name="conv5_mask",
            )(res5_feats.astype(self.dtype))
        )
        out_dim = self.num_classes if self.cls_specific else 1
        # class-agnostic logits keep GaussianFill (mask_rcnn_heads.py:63-66)
        logits_w = conv_w if self.cls_specific else gauss
        return _conv(
            "mask_fcn_logits", out_dim, 1, 1, use_bias=True,
            dtype=self.dtype, kernel_init=logits_w,
        )(x).astype(jnp.float32)


class SingleScaleRCNN(nn.Module):
    """Non-FPN Faster R-CNN / R-FCN at stride 16.

    MODEL.CONV_BODY selects the trunk ('VGG16...', 'VGG_CNN_M_1024...',
    else ResNet C4 via the FPN-free ResNetBody up to res4). MODEL.TYPE
    'rfcn' uses the position-sensitive head; otherwise an fc6/fc7 box head.
    """

    cfg_static: Any

    def setup(self):
        cfg = self.cfg_static
        body = cfg.MODEL.CONV_BODY
        dtype = jnp.dtype(cfg.COMPUTE_DTYPE)
        if "VGG_CNN_M_1024" in body:
            self.body = VGGCNNM1024Body(dtype=dtype, name="body")
        elif "VGG16" in body:
            self.body = VGG16Body(dtype=dtype, name="body")
        else:
            from .arch import arch_from_config
            from .resnet import ResNetBody

            self.body = ResNetBody(arch_from_config(cfg), name="body")
        self._num_anchors = len(cfg.RPN.SIZES) * len(cfg.RPN.ASPECT_RATIOS)
        self.rpn = SingleScaleRPNHead(512, self._num_anchors, dtype, name="rpn")
        if cfg.MODEL.TYPE == "rfcn":
            # ps grid 7x7 (ref default RFCN.PS_GRID_SIZE)
            self.rfcn = RFCNHead(
                cfg.MODEL.NUM_CLASSES, 7, dtype=dtype, name="rfcn",
            )
        elif "ResNet" in cfg.FAST_RCNN.ROI_BOX_HEAD:
            from .arch import arch_from_config

            self.res5_head = ResNetRoIConv5Head(
                arch_from_config(cfg), cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
                dtype=dtype, name="res5_head",
            )
            self.cls_score = nn.Dense(
                cfg.MODEL.NUM_CLASSES, dtype=dtype, param_dtype=jnp.float32,
                kernel_init=nn.initializers.normal(0.01), name="cls_score",
            )
            self.bbox_pred = nn.Dense(
                4 * cfg.MODEL.NUM_CLASSES, dtype=dtype, param_dtype=jnp.float32,
                kernel_init=nn.initializers.normal(0.001), name="bbox_pred",
            )
            if cfg.MODEL.MASK_ON:
                # C4 mask heads (ref: mask_rcnn_heads.py:173-240):
                # v0upshare reuses the box head's res5 weights/computation,
                # v0up owns a separate '_[mask]_res5' stage.
                self.mask_share_res5 = "v0upshare" in cfg.MRCNN.ROI_MASK_HEAD
                if self.mask_share_res5:
                    assert (
                        cfg.MRCNN.ROI_XFORM_RESOLUTION
                        == cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
                    ), "v0upshare requires matching box/mask RoI resolutions"
                else:
                    from .arch import arch_from_config

                    self.mask_res5 = ResNetRoIConv5Head(
                        arch_from_config(cfg), cfg.MRCNN.ROI_XFORM_RESOLUTION,
                        dtype=dtype, name="mask_res5",
                    )
                self.mask_out = MaskV0UpOutput(
                    cfg.MRCNN.DIM_REDUCED, cfg.MODEL.NUM_CLASSES,
                    cfg.MRCNN.CLS_SPECIFIC_MASK,
                    conv_init=cfg.MRCNN.CONV_INIT, dtype=dtype,
                    name="mask_out",
                )
        else:
            self.fc6 = nn.Dense(4096, dtype=dtype, param_dtype=jnp.float32,
                                name="fc6")
            self.fc7 = nn.Dense(4096, dtype=dtype, param_dtype=jnp.float32,
                                name="fc7")
            self.cls_score = nn.Dense(
                cfg.MODEL.NUM_CLASSES, dtype=dtype, param_dtype=jnp.float32,
                kernel_init=nn.initializers.normal(0.01), name="cls_score",
            )
            self.bbox_pred = nn.Dense(
                4 * cfg.MODEL.NUM_CLASSES, dtype=dtype, param_dtype=jnp.float32,
                kernel_init=nn.initializers.normal(0.001), name="bbox_pred",
            )

    def backbone(self, images):
        """Public trunk feature (stride RPN.STRIDE) for the train step."""
        return self._trunk(images)

    def rpn_forward(self, feat):
        return self.rpn(feat)

    def box_forward(self, feat, rois5, return_res5: bool = False):
        """RoI transform + box head -> (cls_score, bbox_pred).

        return_res5=True additionally returns the spatial res5 RoI features
        so the v0upshare mask head can reuse them (the reference shares the
        computation via SampleAs at training time; here we keep all sampled
        rois — static shapes — and the loss masks to fg)."""
        from sad_tpu.ops.detectron_ops import roi_align

        cfg = self.cfg_static
        if cfg.MODEL.TYPE == "rfcn":
            return self.rfcn(feat, rois5)
        pooled = roi_align(
            feat, rois5, 1.0 / float(cfg.RPN.STRIDE),
            cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
            cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO,
        )
        res5_spatial = None
        if hasattr(self, "res5_head"):
            if return_res5:
                x, res5_spatial = self.res5_head(pooled, return_spatial=True)
            else:
                x = self.res5_head(pooled)
        else:
            x = pooled.reshape(pooled.shape[0], -1)
            x = nn.relu(self.fc6(x))
            x = nn.relu(self.fc7(x))
        out = (
            self.cls_score(x).astype(jnp.float32),
            self.bbox_pred(x).astype(jnp.float32),
        )
        if return_res5:
            return out + (res5_spatial,)
        return out

    def mask_heads(self, feat, rois5):
        """Cascaded mask path (test time for both variants; train time for
        v0up): RoIAlign at MRCNN resolution -> res5 stage (the box head's
        for v0upshare, a dedicated one for v0up) -> deconv + logits
        (ref: mask_rcnn_heads.py:173-240)."""
        from sad_tpu.ops.detectron_ops import roi_align

        cfg = self.cfg_static
        pooled = roi_align(
            feat, rois5, 1.0 / float(cfg.RPN.STRIDE),
            cfg.MRCNN.ROI_XFORM_RESOLUTION,
            cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO,
        )
        res5 = self.res5_head if self.mask_share_res5 else self.mask_res5
        _, spatial = res5(pooled, return_spatial=True)
        return self.mask_out(spatial)

    def mask_from_res5(self, res5_spatial):
        """v0upshare training path: mask logits from the box branch's res5
        RoI features (shared computation, ref: mask_rcnn_heads.py:185-196)."""
        return self.mask_out(res5_spatial)

    def init_all(self, images: jnp.ndarray, im_hw: jnp.ndarray):
        """Forward pass touching every head (mask included) so init()
        materializes all params."""
        out = self.__call__(images, im_hw)
        if self.cfg_static.MODEL.MASK_ON and hasattr(self, "mask_out"):
            b, r = out["rois"].shape[:2]
            col = jnp.repeat(jnp.arange(b, dtype=jnp.float32), r)[:, None]
            rois5 = jnp.concatenate([col, out["rois"].reshape(-1, 4)], axis=1)
            out["mask_logits"] = self.mask_heads(out["features"], rois5)
        return out

    def _trunk(self, images):
        out = self.body(images)
        if isinstance(out, dict):  # ResNet C4: use res4 (stride 16)
            key = [k for k in out if k.startswith("res4")][0]
            return out[key]
        return out

    def __call__(self, images: jnp.ndarray, im_hw: jnp.ndarray):
        from sad_tpu.data.anchors import field_of_anchors, generate_cell_anchors
        from sad_tpu.ops.detectron_ops import roi_align
        from sad_tpu.ops.proposals import (
            nms_levels_batched,
            proposal_candidates,
        )

        cfg = self.cfg_static
        feat = self._trunk(images)
        logits, deltas = self.rpn(feat)
        b, h, w = feat.shape[:3]
        stride = float(cfg.RPN.STRIDE)
        cell = np.concatenate(
            [
                generate_cell_anchors(stride, (s,), (ar,))
                for s in cfg.RPN.SIZES
                for ar in cfg.RPN.ASPECT_RATIOS
            ]
        )
        anchors = jnp.asarray(field_of_anchors(cell, stride, h, w), jnp.float32)
        na = self._num_anchors

        # candidates per image under vmap; ONE greedy-NMS call for all
        # images (ops/proposals.nms_levels_batched)
        bx, ts, ms = jax.vmap(
            lambda s, dd, ihw: proposal_candidates(
                jax.nn.sigmoid(s), dd.reshape(h, w, na, 4), anchors, ihw,
                cfg.TEST.RPN_PRE_NMS_TOP_N, float(cfg.TEST.RPN_MIN_SIZE),
                exact_topk=cfg.RPN.EXACT_TOPK,
            )
        )(logits, deltas, im_hw)
        lv_b, lv_s, lv_v = nms_levels_batched(
            [(0, bx, ts, ms)],
            cfg.TEST.RPN_NMS_THRESH, cfg.TEST.RPN_POST_NMS_TOP_N,
        )
        boxes, scores, valid = lv_b[0], lv_s[0], lv_v[0]
        r = boxes.shape[1]
        batch_col = jnp.repeat(jnp.arange(b, dtype=jnp.float32), r)[:, None]
        rois5 = jnp.concatenate([batch_col, boxes.reshape(-1, 4)], axis=1)

        if cfg.MODEL.TYPE == "rfcn":
            cls_score, bbox_pred = self.rfcn(feat, rois5)
        else:
            pooled = roi_align(
                feat, rois5, 1.0 / stride,
                cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
                cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO,
            )
            if hasattr(self, "res5_head"):
                x = self.res5_head(pooled)
            else:
                x = pooled.reshape(pooled.shape[0], -1)
                x = nn.relu(self.fc6(x))
                x = nn.relu(self.fc7(x))
            cls_score = self.cls_score(x).astype(jnp.float32)
            bbox_pred = self.bbox_pred(x).astype(jnp.float32)

        c = cls_score.shape[-1]
        return {
            "features": feat,
            "rois": boxes,
            "roi_scores": scores,
            "roi_valid": valid,
            "cls_score": cls_score.reshape(b, r, c),
            "cls_prob": jax.nn.softmax(
                cls_score.reshape(b, r, c).astype(jnp.float32), axis=-1
            ),
            "bbox_pred": bbox_pred.reshape(b, r, -1),
        }
