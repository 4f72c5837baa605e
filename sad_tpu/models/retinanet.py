"""RetinaNet heads on an FPN backbone.

Capability-equivalent to detectron/lib/modeling/retinanet_heads.py:63-245,
Redesigned:
- The cls/bbox towers are defined ONCE and applied to every pyramid level —
  the reference's ConvShared cross-level weight-sharing trick
  (retinanet_heads.py:113-123) becomes natural module reuse.
- Heads emit NHWC maps (N, H_l, W_l, A*K); losses/decode reshape to
  (N, H_l, W_l, A, K). Channel order matches the reference layout
  c = a * K + k (a = octave*num_aspects + aspect).
- Prior-probability bias init on the cls logits (retinanet_heads.py:29-60).

Module names mirror the reference's shared-weight names (suffix fpn{k_min})
so checkpoint conversion is a renaming.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax.numpy as jnp
import numpy as np

from . import nn
from .arch import ModelArch
from .fpn import FPNRetinaNetBackbone
from .resnet import _conv


def _cls_bias_init(arch: ModelArch):
    """Bias init so initial predictions are ~background (focal loss paper)."""
    prior = arch.prior_prob
    if arch.softmax:
        # class 0 (background) gets log((C-1)(1-p)/p), others 0
        per_anchor = np.zeros((arch.cls_pred_dim,), np.float32)
        per_anchor[0] = np.log((arch.num_classes - 1) * (1 - prior) / prior)
        full = np.tile(per_anchor, arch.num_anchors)

        def init(key, shape, dtype=jnp.float32):
            assert shape == full.shape
            return jnp.asarray(full, dtype)

        return init
    value = -float(np.log((1 - prior) / prior))
    return nn.initializers.constant(value)


class RetinaNetHead(nn.Module):
    """Shared cls/bbox towers applied per level."""

    arch: ModelArch

    @nn.compact
    def __call__(
        self, features: Dict[int, jnp.ndarray]
    ) -> Tuple[Dict[int, jnp.ndarray], Dict[int, jnp.ndarray]]:
        a = self.arch
        dtype = jnp.dtype(a.compute_dtype)
        gauss = nn.initializers.normal(stddev=0.01)
        zero = nn.initializers.zeros
        k_min = a.min_level

        cls_tower = [
            _conv(
                f"retnet_cls_conv_n{i}_fpn{k_min}", a.fpn_dim, 3, 1,
                use_bias=True, dtype=dtype, kernel_init=gauss, bias_init=zero,
            )
            for i in range(a.num_convs)
        ]
        cls_pred = _conv(
            f"retnet_cls_pred_fpn{k_min}", a.cls_pred_dim * a.num_anchors, 3, 1,
            use_bias=True, dtype=dtype, kernel_init=gauss,
            bias_init=_cls_bias_init(a),
        )
        if not a.share_cls_bbox_tower:
            bbox_tower = [
                _conv(
                    f"retnet_bbox_conv_n{i}_fpn{k_min}", a.fpn_dim, 3, 1,
                    use_bias=True, dtype=dtype, kernel_init=gauss, bias_init=zero,
                )
                for i in range(a.num_convs)
            ]
        bbox_pred = _conv(
            f"retnet_bbox_pred_fpn{k_min}", a.bbox_regr_dim * a.num_anchors, 3, 1,
            use_bias=True, dtype=dtype, kernel_init=gauss, bias_init=zero,
        )

        cls_out: Dict[int, jnp.ndarray] = {}
        box_out: Dict[int, jnp.ndarray] = {}
        for lvl in a.levels:
            x = features[lvl]
            c = x
            for conv in cls_tower:
                c = nn.relu(conv(c))
            cls_out[lvl] = cls_pred(c).astype(jnp.float32)
            b = c if a.share_cls_bbox_tower else x
            if not a.share_cls_bbox_tower:
                for conv in bbox_tower:
                    b = nn.relu(conv(b))
            box_out[lvl] = bbox_pred(b).astype(jnp.float32)
        return cls_out, box_out


class RetinaNet(nn.Module):
    """Full detector: FPN backbone + RetinaNet head.

    Returns dict:
      'cls_logits': {level: (N, H_l, W_l, A*cls_pred_dim) float32}
      'bbox_pred':  {level: (N, H_l, W_l, A*bbox_regr_dim) float32}
      'cls_prob':   {level: sigmoid/softmax probs} (the inference-time
                    Sigmoid/GroupSpatialSoftmax of retinanet_heads.py:153-163;
                    always computed — XLA dead-code-eliminates it when unused)
    """

    arch: ModelArch

    @nn.compact
    def __call__(self, images: jnp.ndarray):
        a = self.arch
        feats = FPNRetinaNetBackbone(a, name="fpn")(images)
        cls_out, box_out = RetinaNetHead(a, name="head")(feats)

        probs = {}
        for lvl, logits in cls_out.items():
            if a.softmax:
                n, h, w, _ = logits.shape
                grouped = logits.reshape(n, h, w, a.num_anchors, a.cls_pred_dim)
                probs[lvl] = nn.softmax(grouped, axis=-1).reshape(logits.shape)
            else:
                probs[lvl] = nn.sigmoid(logits)
        return {"cls_logits": cls_out, "bbox_pred": box_out, "cls_prob": probs}
