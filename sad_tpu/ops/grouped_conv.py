"""Grouped-conv phrasings.

ResNeXt's grouped 3x3 convs (the reference's `group=64`, ResNet.py
add_ResNet_bottleneck) have a per-group width of 4..32 channels. Besides
XLA's native `feature_group_count` lowering (cuDNN's grouped conv on the
GPU), this module provides one alternative family, parameterized by how
many groups share a dense conv:

    grouped_conv_packed(x, k, groups, pack, ...)

- ``pack=1``   — pure group-to-batch: the G groups become G batch blocks
  and one `batch_group_count=G` conv gives every group its own filters
  with NO flop inflation, at the cost of a cg-wide contraction.
- ``pack=G``   — single dense conv with a full block-diagonal kernel:
  G x the flops, but a C_in-wide contraction.
- ``1<pack<G`` — ``pack`` consecutive groups share one dense
  block-diagonal conv of ``pack*cg`` channels (``pack/1`` x flop
  inflation), batched over ``G/pack`` packs via `batch_group_count`.
  ``pack = 128 // cg`` fills a 128-wide contraction.

All phrasings consume the reference kernel layout (kh, kw, cin_per_group,
C_out) — the same parameter a `feature_group_count` conv holds — so they
are drop-in at trace time with no checkpoint/converter impact.
Equivalence is pinned by tests/test_grouped_conv.py. The default ('auto')
is `feature_group_count`; no packed phrasing has been measured on the GPU.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# Phrasing used by the backbone's grouped convs, read at TRACE time:
# 'auto' or 'fgc' (XLA feature_group_count), or an integer pack size for
# grouped_conv_packed ('1' = group-to-batch, 'lane' = 128//cg, 'dense' =
# one block-diagonal conv over all G groups).
GROUPED_CONV_IMPL = os.environ.get("SAD_TPU_GROUPED_CONV_IMPL", "auto")


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def grouped_conv_fgc(x, kernel, groups, stride=1, dilation=1):
    """The XLA-native phrasing: one conv with feature_group_count=groups.

    x: (N, H, W, C_in) NHWC; kernel: (kh, kw, C_in // groups, C_out).
    """
    kh, kw = kernel.shape[:2]
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    pad_h = ((kh - 1) * dh) // 2
    pad_w = ((kw - 1) * dw) // 2
    return jax.lax.conv_general_dilated(
        x,
        kernel.astype(x.dtype),
        (sh, sw),
        ((pad_h, pad_h), (pad_w, pad_w)),
        rhs_dilation=(dh, dw),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups,
    )


def pack_block_diagonal(kernel, groups, pack):
    """Scatter grouped weights into `G/pack` block-diagonal dense kernels.

    kernel: (kh, kw, cg_in, C_out) with output features group-major
    (feature index = g * cg_out + co, the feature_group_count layout).
    Returns (kh, kw, pack*cg_in, B*pack*cg_out) with B = groups // pack and
    output features ordered (b, p, co) — which IS (g, co) for g = b*pack+p,
    so the packed conv's output channel order matches the grouped layout
    with no post-permutation.
    """
    kh, kw, cg_in, c_out = kernel.shape
    if c_out % groups:
        raise ValueError(f"C_out {c_out} not divisible by groups {groups}")
    if groups % pack:
        raise ValueError(f"groups {groups} not divisible by pack {pack}")
    cg_out = c_out // groups
    b = groups // pack
    k6 = kernel.reshape(kh, kw, cg_in, b, pack, cg_out)
    eye = jnp.eye(pack, dtype=kernel.dtype)
    # packed[h,w,(q,ci),(b,p,co)] = k6[h,w,ci,b,p,co] * (p == q)
    packed = jnp.einsum("hwcbpo,qp->hwqcbpo", k6, eye)
    return packed.reshape(kh, kw, pack * cg_in, b * pack * cg_out)


def grouped_conv_packed(x, kernel, groups, pack, stride=1, dilation=1):
    """Grouped conv as `G/pack` block-diagonal dense convs over the batch
    dim (`batch_group_count`), `pack` groups per conv.

    x: (N, H, W, C_in) NHWC; kernel: (kh, kw, C_in // groups, C_out).
    Output: (N, H', W', C_out), channel order identical to the
    feature_group_count phrasing. Flop inflation = pack (each group pays
    for the pack's full contraction width); lane width = pack * cg_in.
    """
    n, h, w, c_in = x.shape
    kh, kw = kernel.shape[:2]
    cg_in = c_in // groups
    if kernel.shape[2] != cg_in:
        raise ValueError(
            f"kernel cin {kernel.shape[2]} != C_in/groups {cg_in}"
        )
    bgc = groups // pack
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    pad_h = ((kh - 1) * dh) // 2
    pad_w = ((kw - 1) * dw) // 2

    packed = pack_block_diagonal(kernel, groups, pack).astype(x.dtype)
    if bgc == 1:
        lhs = x  # full dense block-diagonal conv, no batch regrouping
    else:
        # channels are group-major: ch = (b*pack + p)*cg_in + ci.
        # XLA batch groups are contiguous batch blocks, so block b of the
        # batch must hold pack*cg_in channels of pack-group b.
        lhs = (
            x.reshape(n, h, w, bgc, pack * cg_in)
            .transpose(3, 0, 1, 2, 4)
            .reshape(bgc * n, h, w, pack * cg_in)
        )
    return jax.lax.conv_general_dilated(
        lhs,
        packed,
        (sh, sw),
        ((pad_h, pad_h), (pad_w, pad_w)),
        rhs_dilation=(dh, dw),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        batch_group_count=bgc,
    )


def resolve_pack(impl: str, groups: int, cg_in: int):
    """Map a GROUPED_CONV_IMPL spelling to a pack size (None = fgc)."""
    if impl in ("auto", "fgc", "", None):
        return None
    if impl == "dense":
        return groups
    if impl == "lane":
        # Largest DIVISOR of groups that fits a 128-wide contraction —
        # a non-divisor pack (e.g. groups=6, cg=24 -> 128//24 = 5) would
        # make pack_block_diagonal raise at trace time.
        cap = max(1, min(groups, 128 // max(cg_in, 1)))
        while groups % cap:
            cap -= 1
        return cap
    pack = int(impl)
    if pack <= 0 or groups % pack:
        raise ValueError(f"pack {pack} incompatible with groups {groups}")
    return pack


def grouped_conv(x, kernel, groups, stride=1, dilation=1, impl=None):
    """Dispatch a grouped conv by phrasing (module default: GROUPED_CONV_IMPL)."""
    impl = GROUPED_CONV_IMPL if impl is None else impl
    cg_in = x.shape[-1] // groups
    pack = resolve_pack(impl, groups, cg_in)
    if pack is None:
        return grouped_conv_fgc(x, kernel, groups, stride, dilation)
    return grouped_conv_packed(x, kernel, groups, pack, stride, dilation)
