"""VGG backbones (inherited surface).

Capability-equivalent to detectron/lib/modeling/VGG16.py and
VGG_CNN_M_1024.py: single-scale conv bodies (stride 16) for the non-FPN
Faster R-CNN path. Names mirror the reference blob names (conv1_1, ...,
conv5_3 / conv1..conv5) for checkpoint conversion.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from . import nn
from .resnet import _conv


class VGG16Body(nn.Module):
    """VGG16 conv1_1..conv5_3 (VGG16.py add_VGG16_conv5_body): the first two
    stages are frozen (no grad) like the reference's StopGradient-free
    convention of not training conv1/conv2."""

    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        cfg_stages = [
            (2, 64, "conv1"),
            (2, 128, "conv2"),
            (3, 256, "conv3"),
            (3, 512, "conv4"),
            (3, 512, "conv5"),
        ]
        x = x.astype(self.dtype)
        for si, (n, dim, name) in enumerate(cfg_stages):
            for i in range(n):
                x = nn.relu(
                    _conv(f"{name}_{i + 1}", dim, 3, 1, use_bias=True,
                          dtype=self.dtype)(x)
                )
            if si < 4:  # no pool after conv5 (stride 16 output)
                x = nn.max_pool(x, (2, 2), strides=(2, 2))
        return x  # (N, H/16, W/16, 512)


class VGGCNNM1024Body(nn.Module):
    """VGG_CNN_M_1024 conv1..conv5 (VGG_CNN_M_1024.py): 7x7/2 + LRN-free
    stem, 5 convs, stride-16 output, 1024-d conv5 (the 'M_1024' variant)."""

    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        x = x.astype(self.dtype)
        x = nn.relu(_conv("conv1", 96, 7, 2, use_bias=True, dtype=self.dtype)(x))
        x = nn.max_pool(x, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
        x = nn.relu(_conv("conv2", 256, 5, 2, use_bias=True, dtype=self.dtype)(x))
        x = nn.max_pool(x, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))
        x = nn.relu(_conv("conv3", 512, 3, 1, use_bias=True, dtype=self.dtype)(x))
        x = nn.relu(_conv("conv4", 512, 3, 1, use_bias=True, dtype=self.dtype)(x))
        x = nn.relu(_conv("conv5", 1024, 3, 1, use_bias=True, dtype=self.dtype)(x))
        return x  # (N, H/16, W/16, 1024)
