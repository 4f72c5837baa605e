"""Feature Pyramid Network on a ResNet trunk, RetinaNet flavor (P3..P7).

Capability-equivalent to detectron/lib/modeling/FPN.py:116-249 for the
RetinaNet configuration (RPN_MIN_LEVEL=3, RPN_MAX_LEVEL=7,
EXTRA_CONV_LEVELS=True):
- 1x1 laterals on res3/res4/res5, nearest 2x top-down, 3x3 post-hoc convs
  (FPN.py:142-185, 227-249),
- P6 = 3x3/2 conv on the *raw res5 backbone feature* (not P5!) and
  P7 = 3x3/2 conv on relu(P6) (FPN.py:202-222 — EXTRA_CONV_LEVELS path).

Module names mirror reference blob names ('fpn_inner_res5_2_sum',
'fpn_inner_res4_5_sum_lateral', 'fpn_res3_3_sum', 'fpn_6', 'fpn_7') for the
checkpoint converter.
"""

from __future__ import annotations

from typing import Dict

import jax.numpy as jnp

from . import nn
from .arch import ModelArch
from .resnet import ResNetBody, _conv


def upsample_nearest_2x(x: jnp.ndarray) -> jnp.ndarray:
    """Nearest-neighbor 2x upsample, NHWC (ref op: UpsampleNearest,
    caffe2/modules/detectron/upsample_nearest_op.cu; used FPN.py:247)."""
    n, h, w, c = x.shape
    x = jnp.broadcast_to(x[:, :, None, :, None, :], (n, h, 2, w, 2, c))
    return x.reshape(n, h * 2, w * 2, c)


class FPNRetinaNetBackbone(nn.Module):
    """ResNet body + FPN; returns {level: (N, H_l, W_l, fpn_dim)} for
    levels min_level..max_level."""

    arch: ModelArch

    @nn.compact
    def __call__(self, images: jnp.ndarray) -> Dict[int, jnp.ndarray]:
        a = self.arch
        dtype = jnp.dtype(a.compute_dtype)
        body_out = ResNetBody(a, name="body")(images)

        stage_names = ResNetBody.stage_blob_names(a)  # res2.., res3.., res4.., res5..
        stage_dims = a.stage_dims()
        # FPN lateral stages: coarsest-first, down to min backbone level
        # (min_level=3 -> res5, res4, res3; FPN.py:129-137)
        n_stages = 4 - (max(a.min_level, 2) - 2)
        laterals_names = stage_names[::-1][:n_stages]  # ['res5_..','res4_..','res3_..']

        xavier = nn.initializers.xavier_uniform()
        zero = nn.initializers.zeros
        lateral_init = zero if a.zero_init_lateral else xavier

        # coarsest seed: 1x1 on res5
        inner = _conv(
            f"fpn_inner_{laterals_names[0]}", a.fpn_dim, 1, 1, use_bias=True,
            dtype=dtype, kernel_init=xavier, bias_init=zero,
        )(body_out[laterals_names[0]])
        inners = [inner]
        # top-down + lateral
        for name in laterals_names[1:]:
            lat = _conv(
                f"fpn_inner_{name}_lateral", a.fpn_dim, 1, 1, use_bias=True,
                dtype=dtype, kernel_init=lateral_init, bias_init=zero,
            )(body_out[name])
            td = upsample_nearest_2x(inners[-1])
            inners.append(lat + td)

        # post-hoc 3x3 convs -> P5, P4, P3 (coarsest-first order here)
        pyramid: Dict[int, jnp.ndarray] = {}
        top_backbone_level = 5
        for i, name in enumerate(laterals_names):
            lvl = top_backbone_level - i
            pyramid[lvl] = _conv(
                f"fpn_{name}", a.fpn_dim, 3, 1, use_bias=True, dtype=dtype,
                kernel_init=xavier, bias_init=zero,
            )(inners[i])

        # extra levels above P5:
        if a.max_level > top_backbone_level:
            if a.extra_conv_levels:
                # RetinaNet P6/P7: stride-2 convs on the raw res5 feature
                # (FPN.py:202-222)
                feat = body_out[stage_names[-1]]
                for lvl in range(top_backbone_level + 1, a.max_level + 1):
                    if lvl > top_backbone_level + 1:
                        feat = nn.relu(feat)
                    feat = _conv(
                        f"fpn_{lvl}", a.fpn_dim, 3, 2, use_bias=True, dtype=dtype,
                        kernel_init=xavier, bias_init=zero,
                    )(feat)
                    pyramid[lvl] = feat
            else:
                # original FPN P6: stride-2 max-pool subsample of P5
                # (FPN.py:192-198)
                assert a.max_level == top_backbone_level + 1, (
                    "levels above P6 need FPN.EXTRA_CONV_LEVELS"
                )
                pyramid[a.max_level] = nn.max_pool(
                    pyramid[top_backbone_level], (1, 1), strides=(2, 2)
                )

        return {lvl: pyramid[lvl] for lvl in a.levels}
