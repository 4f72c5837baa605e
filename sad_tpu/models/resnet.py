"""ResNet / ResNeXt backbone bodies (NHWC, bf16 compute).

Capability-equivalent to detectron/lib/modeling/ResNet.py, redesigned:
- NHWC layout, bfloat16 compute with float32 params.
- AffineChannel frozen-BN (scale/bias receive no gradient — the reference's
  AffineChannel gradient maker only emits GI(0),
  caffe2/modules/detectron/affine_channel_op.cc:70-80).
- FREEZE_AT stages are wrapped in stop_gradient (ref: ResNet.py:103-122
  StopGradient), which also lets XLA skip their backward entirely.
- FOLD_AFFINE trace-time rewrite: conv -> AffineChannel pairs become
  conv(x, W*s) + b, moving the frozen per-channel scale off the activation
  tensor and onto the weights — the live-forward analogue of the reference
  converter's BN fold (tools/pickle_caffe_blobs.py:148-170). The parameter
  tree is unchanged (W and s/b stay separate params under the reference
  blob names), so checkpoints/converter/trainable-masks are untouched.
- ResNeXt = grouped 3x3 routed through ops/grouped_conv.py, whose
  SAD_TPU_GROUPED_CONV_IMPL trace-time knob swaps the conv phrasing
  (feature_group_count / group-to-batch / packed block-diagonal)
  underneath an unchanged parameter tree; CHANNEL_RATIO width
  multiplier for half-width students (ResNet.py:99-118).

Module names mirror the reference blob names (conv1, res_conv1_bn,
res2_0_branch2a, ...) so the pickle-checkpoint converter is a pure renaming.
"""

from __future__ import annotations

from typing import Any, List

import jax
import jax.numpy as jnp

from . import nn
from ..ops import grouped_conv as _gc
from .arch import ModelArch


class AffineChannel(nn.Module):
    """y = x * s + b per channel; s/b are frozen (no grad in the reference)."""

    dim: int

    @nn.compact
    def __call__(self, x):
        s = self.param("s", nn.initializers.ones, (self.dim,), jnp.float32)
        b = self.param("b", nn.initializers.zeros, (self.dim,), jnp.float32)
        return x * s.astype(x.dtype) + b.astype(x.dtype)


def _conv(name: str, features: int, kernel: int, stride: int = 1,
          dilation: int = 1, groups: int = 1, use_bias: bool = False,
          dtype=jnp.bfloat16, kernel_init=None, bias_init=None):
    pad = ((kernel - 1) * dilation) // 2
    return nn.Conv(
        features=features,
        kernel_size=(kernel, kernel),
        strides=(stride, stride),
        padding=((pad, pad), (pad, pad)),
        kernel_dilation=(dilation, dilation),
        feature_group_count=groups,
        use_bias=use_bias,
        dtype=dtype,
        param_dtype=jnp.float32,
        kernel_init=kernel_init or nn.initializers.he_normal(),
        bias_init=bias_init or nn.initializers.zeros,
        name=name,
    )


class GroupedConv(nn.Module):
    """Grouped conv with the same param tree as nn.Conv(feature_group_count)
    — name 'kernel', shape (k, k, cin/groups, features) — but whose compute
    phrasing is selected at trace time by ops/grouped_conv.py.
    Checkpoints and
    the weight converter see no difference."""

    features: int
    kernel: int
    groups: int
    stride: int = 1
    dilation: int = 1
    dtype: Any = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        if x.shape[-1] % self.groups or self.features % self.groups:
            raise ValueError(
                f"{self.name}: channels in/out ({x.shape[-1]}/{self.features})"
                f" must divide groups={self.groups} (check NUM_GROUPS x "
                f"WIDTH_PER_GROUP x CHANNEL_RATIO)"
            )
        k = self.param(
            "kernel", nn.initializers.he_normal(),
            (self.kernel, self.kernel, x.shape[-1] // self.groups,
             self.features), jnp.float32,
        )
        return _gc.grouped_conv(
            x.astype(self.dtype), k, self.groups,
            stride=self.stride, dilation=self.dilation,
        )


class _ConvKernel(nn.Module):
    """Declares just a conv kernel parameter under the reference blob name
    and returns it unapplied. The FOLD_AFFINE path needs the raw weight to
    scale by the AffineChannel `s` before the conv while keeping the
    checkpoint tree byte-identical to the nn.Conv layout (same module name,
    same 'kernel' param, same init, same RNG path)."""

    shape: Any
    kernel_init: Any = None

    @nn.compact
    def __call__(self):
        return self.param(
            "kernel", self.kernel_init or nn.initializers.he_normal(),
            tuple(self.shape), jnp.float32,
        )


class _AffineParams(nn.Module):
    """Declares AffineChannel s/b under the reference `_bn` blob name and
    returns them unapplied (FOLD_AFFINE path)."""

    dim: int

    @nn.compact
    def __call__(self):
        s = self.param("s", nn.initializers.ones, (self.dim,), jnp.float32)
        b = self.param("b", nn.initializers.zeros, (self.dim,), jnp.float32)
        return s, b


def _apply_conv(x, kernel, stride=1, dilation=1, groups=1):
    """Dense/grouped NHWC conv on an explicit kernel (same-pad convention
    as _conv). Used by the fold path; grouped shapes route through the
    phrasing dispatcher so lane packing still applies."""
    if groups > 1:
        return _gc.grouped_conv(
            x, kernel, groups, stride=stride, dilation=dilation
        )
    kh, kw = kernel.shape[:2]
    pad_h = ((kh - 1) * dilation) // 2
    pad_w = ((kw - 1) * dilation) // 2
    return jax.lax.conv_general_dilated(
        x,
        kernel.astype(x.dtype),
        (stride, stride),
        ((pad_h, pad_h), (pad_w, pad_w)),
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )


class Conv1S2D(nn.Module):
    """conv1 as a weight-equivalent space-to-depth conv (the MLPerf trick
    for the stem).

    A 7x7/s2 conv over 3-channel input contracts over only cin=3 channels
    per tap. Regrouping 2x2 input
    blocks into 12 channels turns it into a 4x4/s1 conv with IDENTICAL
    outputs: zero-pad the kernel to 8x8 with a leading row/col (the extra
    tap multiplies zeros), then split each spatial axis into (tap, block
    parity). The parameter keeps the reference's name and (7,7,cin,64)
    shape, so checkpoints and the weight converter are untouched; only the
    on-device compute layout changes. Equivalence is pinned by
    tests/test_s2d_stem.py. Ref stem: ResNet.py:88-99 / conv1 blob.
    """

    dtype: Any

    @nn.compact
    def __call__(self, x):
        c = x.shape[-1]
        w7 = self.param(
            "kernel", nn.initializers.he_normal(), (7, 7, c, 64), jnp.float32
        )
        return _s2d_conv(x, w7, self.dtype)


def _s2d_conv(x, w7, dtype):
    """The Conv1S2D transform on an explicit (7,7,c,64) kernel (shared with
    the FOLD_AFFINE stem, which pre-scales w7 by the res_conv1_bn `s`)."""
    n, h, w, c = x.shape
    w8 = jnp.pad(w7, ((1, 0), (1, 0), (0, 0), (0, 0)))
    # k[r, s, (by*2+bx)*c + ci, f] = w8[2r+by, 2s+bx, ci, f]
    k = (
        w8.reshape(4, 2, 4, 2, c, 64)
        .transpose(0, 2, 1, 3, 4, 5)
        .reshape(4, 4, 4 * c, 64)
    )
    y = (
        x.reshape(n, h // 2, 2, w // 2, 2, c)
        .transpose(0, 1, 3, 2, 4, 5)
        .reshape(n, h // 2, w // 2, 4 * c)
    )
    # block-row taps i-2..i+1 cover full-res rows 2i-4..2i+3; the
    # original pad-3 window is rows 2i-3..2i+3 plus the zeroed w8 row
    return jax.lax.conv_general_dilated(
        y.astype(dtype),
        k.astype(dtype),
        (1, 1),
        ((2, 1), (2, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (grouped) -> 1x1 bottleneck with AffineChannel after each
    conv, plus projection shortcut when dims change (ResNet.py:221-278)."""

    prefix: str  # e.g. 'res2_0'
    dim_in: int
    dim_out: int
    dim_inner: int
    stride: int
    groups: int
    dilation: int
    stride_1x1: bool
    dtype: Any
    fold: bool = False  # FOLD_AFFINE: conv(x, W*s) + b instead of conv;mul;add

    def _conv_bn(self, x, name, cout, ksz, stride=1, dilation=1, groups=1,
                 kernel_init=None):
        """conv -> AffineChannel pair; with self.fold the frozen scale is
        folded into the weight so the per-channel multiply runs over the
        O(C^2 k^2) kernel instead of the O(NHWC) activation."""
        if self.fold:
            cin = x.shape[-1]
            if cin % groups or cout % groups:
                raise ValueError(
                    f"{name}: channels in/out ({cin}/{cout}) must divide "
                    f"groups={groups}"
                )
            w = _ConvKernel(
                (ksz, ksz, cin // groups, cout), kernel_init, name=name
            )()
            s, b = _AffineParams(cout, name=name + "_bn")()
            y = _apply_conv(
                x.astype(self.dtype), w * s, stride=stride,
                dilation=dilation, groups=groups,
            )
            return y + b.astype(y.dtype)
        if groups > 1:
            y = GroupedConv(
                cout, ksz, groups, stride=stride, dilation=dilation,
                dtype=self.dtype, name=name,
            )(x)
        else:
            y = _conv(
                name, cout, ksz, stride, dilation=dilation,
                dtype=self.dtype, kernel_init=kernel_init,
            )(x)
        return AffineChannel(cout, name=name + "_bn")(y)

    @nn.compact
    def __call__(self, x):
        s1, s3 = (self.stride, 1) if self.stride_1x1 else (1, self.stride)
        p = self.prefix

        cur = self._conv_bn(x, p + "_branch2a", self.dim_inner, 1, stride=s1)
        cur = nn.relu(cur)

        cur = self._conv_bn(
            cur, p + "_branch2b", self.dim_inner, 3, stride=s3,
            dilation=self.dilation, groups=self.groups,
        )
        cur = nn.relu(cur)

        # branch2c conv init is down-scaled so a FROM-SCRATCH network starts
        # near-identity instead of exploding through 50 unnormalized layers
        # (AffineChannel is frozen, so the usual zero-gamma trick would kill
        # the branch permanently; a small *conv* init trains normally).
        # Pretrained loads overwrite this, so reference parity is unaffected.
        cur = self._conv_bn(
            cur, p + "_branch2c", self.dim_out, 1,
            kernel_init=nn.initializers.variance_scaling(
                0.01, "fan_in", "truncated_normal"
            ),
        )

        if self.dim_in != self.dim_out:
            sc = self._conv_bn(
                x, p + "_branch1", self.dim_out, 1, stride=self.stride
            )
        else:
            sc = x
        return nn.relu(cur + sc)


class ResNetBody(nn.Module):
    """conv1..res5 trunk returning the res2..res5 stage outputs (NHWC).

    Output dict keys are the reference's FPN-level-info blob names
    ('res{stage}_{last}_sum') so FPN wiring and checkpoint conversion line up.
    """

    arch: ModelArch

    @nn.compact
    def __call__(self, x):
        a = self.arch
        dtype = jnp.dtype(a.compute_dtype)
        x = x.astype(dtype)

        if a.fold_affine:
            w7 = _ConvKernel((7, 7, x.shape[-1], 64), name="conv1")()
            s, b = _AffineParams(64, name="res_conv1_bn")()
            w7 = w7 * s  # scale on output features commutes with the S2D repack
            if a.s2d_stem:
                p = _s2d_conv(x, w7, dtype)
            else:
                p = _apply_conv(x.astype(dtype), w7, stride=2)
            p = p + b.astype(p.dtype)
        elif a.s2d_stem:
            p = Conv1S2D(dtype=dtype, name="conv1")(x)
            p = AffineChannel(64, name="res_conv1_bn")(p)
        else:
            p = _conv("conv1", 64, 7, 2, dtype=dtype)(x)
            p = AffineChannel(64, name="res_conv1_bn")(p)
        p = nn.relu(p)
        p = nn.max_pool(p, (3, 3), strides=(2, 2), padding=((1, 1), (1, 1)))

        dim_in = 64
        dim_bottleneck = int(a.num_groups * a.width_per_group * a.channel_ratio)
        stage_dims = a.stage_dims()
        outputs = {}

        for stage_idx, (n_blocks, dim_out) in enumerate(
            zip(a.block_counts, stage_dims), start=2
        ):
            dilation = a.res5_dilation if stage_idx == 5 else 1
            inner = dim_bottleneck * (2 ** (stage_idx - 2))
            s = p
            block_cls = nn.remat(Bottleneck) if a.remat else Bottleneck
            for i in range(n_blocks):
                # stride 2 on the first block of res3..res5; res2 follows the
                # stride-2 max pool. The reference detects the stem with a
                # `dim_in != 64` heuristic (ResNet.py:171-175) that breaks
                # for small CHANNEL_RATIOs; use the stage index instead
                # (identical behavior at all real widths).
                stride = 2 if (i == 0 and stage_idx > 2 and dilation == 1) else 1
                s = block_cls(
                    prefix=f"res{stage_idx}_{i}",
                    dim_in=dim_in,
                    dim_out=dim_out,
                    dim_inner=inner,
                    stride=stride,
                    groups=a.num_groups,
                    dilation=dilation,
                    stride_1x1=a.stride_1x1,
                    dtype=dtype,
                    fold=a.fold_affine,
                )(s)
                dim_in = dim_out
            if a.freeze_at == stage_idx:
                s = jax.lax.stop_gradient(s)
            outputs[f"res{stage_idx}_{n_blocks - 1}_sum"] = s
            p = s

        return outputs

    @staticmethod
    def stage_blob_names(arch: ModelArch) -> List[str]:
        return [
            f"res{stage}_{n - 1}_sum"
            for stage, n in zip(range(2, 6), arch.block_counts)
        ]
