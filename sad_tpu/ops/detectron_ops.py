"""The rest of the reference's custom op library, as static-shape JAX.

Covers the caffe2/modules/detectron ops not already in sad_tpu.ops.losses
(SURVEY.md §2.2a inventory). Layouts are NHWC (features) and (R, 5) rois
[batch_idx, x1, y1, x2, y2]; semantics cite the CUDA kernels they replicate.

Ops:
- roi_align            (roi_align_op.cu:40-160; exact, incl. boundary rules)
- roi_pool             (roi_pool_f_op.cu:36-95; exact max-pool semantics)
- ps_roi_pool          (ps_roi_pool_op.cu; R-FCN position-sensitive avg pool)
- group_spatial_softmax(group_spatial_softmax_op.cu SpatialSoftmaxKernel)
- softmax_focal_loss   (softmax_focal_loss_op.cu:55-140; custom VJP)
- sigmoid_cross_entropy_loss (sigmoid_cross_entropy_loss_op.cu:29-66)
- smooth_l1_loss_per_roi / softmax_with_loss_ohem / box_annotator_ohem
  (the OHEM trio: smooth_l1_loss_OHEM_op, softmax_with_loss_OHEM_op,
  box_annotator_ohem_op — per-RoI losses + top-k hard example selection)
- batch_permutation    (batch_permutation_op.cu)
- sample_as            (sample_as_op.cu — select rows where labels > 0)
- spatial_narrow_as    (spatial_narrow_as_op.cu — crop H/W to a target's)
- spatial_l2_loss      (spatial_l2_loss_op.cu — L2 feature imitation)
- spatial_sigmoid      (spatial_sigmoid_op.cu)
- affine_channel       (affine_channel_op.cu — functional form)
- upsample_nearest     (upsample_nearest_op.cu)
- zero_even            (detectron/lib/ops/zero_even_op.cu — the tutorial op)
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

FLT_MIN = float(np.finfo(np.float32).tiny)


# --------------------------------------------------------------------------- #
# RoI feature transforms
# --------------------------------------------------------------------------- #


def roi_align(
    features: jnp.ndarray,  # (B, H, W, C)
    rois: jnp.ndarray,  # (R, 5) [batch, x1, y1, x2, y2]
    spatial_scale: float,
    resolution: int,
    sampling_ratio: int = 2,
    roi_chunk: int = 256,  # not measured on the GPU
    slots_per_im: int = 0,
) -> jnp.ndarray:
    """RoIAlign, exact Detectron semantics (roi_align_op.cu:89-160): no
    rounding of roi coords, malformed rois forced to 1x1, average of an
    sr x sr bilinear sample grid per bin.

    sampling_ratio must be static and > 0 (the reference's adaptive
    sampling_ratio=0 computes a data-dependent grid per roi, which XLA cannot
    trace; pass an explicit ratio — Detectron FPN configs use 2).
    Returns (R, resolution, resolution, C).

    slots_per_im (static): caller's promise that rois are IMAGE-MAJOR with
    exactly this many slots per image (rois[i] belongs to image i //
    slots_per_im; the batch column is ignored). Every R-CNN call site
    builds rois as repeat(arange(B), S) + reshape, so this holds by
    construction there. With it, the tent matmuls run per image under
    vmap: contraction depth drops from B*axis to axis, cutting executed
    forward FLOPs by ~B (the round-5 jaxpr audit measured the un-blocked
    form spending ~half the bs8 Mask R-CNN step FLOPs multiplying
    cross-image zeros)."""
    assert sampling_ratio > 0, "needs a static sampling_ratio (>0)"
    features = jnp.asarray(features)
    b, h, w, c = features.shape
    res, sr = resolution, sampling_ratio

    if slots_per_im and rois.shape[0] != b * slots_per_im:
        raise ValueError(
            f"slots_per_im={slots_per_im} needs {b}*{slots_per_im} rois,"
            f" got {rois.shape[0]}"
        )
    # b >= 4: blocking cuts executed flops by b, but the per-image matmuls
    # contract over a b-times-smaller axis; small batches keep the
    # batch-folded form (threshold not measured on the GPU).
    if slots_per_im and b >= 4:
        rois_im = rois.reshape(b, slots_per_im, 5)
        rois_im = rois_im.at[:, :, 0].set(0.0)  # single-image batch index

        def one_image(f_im, r_im):
            return roi_align(
                f_im[None], r_im, spatial_scale, resolution,
                sampling_ratio, roi_chunk,
            )

        out = jax.vmap(one_image)(features, rois_im)
        return out.reshape(b * slots_per_im, res, res, c)

    # Matmul formulation: bilinear interpolation weights over a grid
    # axis are exactly the tent function max(0, 1-|y-row|) after the CUDA
    # kernel's edge handling (clamp-below 0, full weight to the top row
    # when floor(y) >= n-1, zero outside [-1, n]). Since the kernel's
    # weight of pixel (row, col) is the PRODUCT wy[row]*wx[col] and the
    # sr x sr bin average distributes over that product, the whole op is
    # two per-axis weight MATMULS: out = Wy @ F @ Wx^T. The FLOPs land in
    # matrix units, and the backward is transposed matmuls — no
    # scatter-add.
    # The chunked two-matmul form is bound by HBM traffic of the (rc*res,
    # keep_dim*c) intermediate, so (a) contract the LARGER spatial axis
    # first (the intermediate keeps the smaller one), and (b) store the
    # intermediate in the feature dtype (bf16 halves the traffic; the f32
    # path is unchanged). Both matmuls accumulate in f32 either way.
    x_first = w > h
    if x_first:
        fmat = features.transpose(0, 2, 1, 3).reshape(b * w, h * c)
    else:
        fmat = features.reshape(b * h, w * c)

    def axis_weights(lo, bin_sz, n):
        """Summed tent weights per output bin: (Rc, res, n), exact
        bilinear_interpolate semantics per sample (roi_align_op.cu:41-87),
        averaged over the sr samples of each bin."""
        ph = jnp.arange(res, dtype=jnp.float32)
        i = jnp.arange(sr, dtype=jnp.float32)
        s = (
            lo[:, None, None]
            + ph[None, :, None] * bin_sz[:, None, None]
            + (i[None, None, :] + 0.5) * bin_sz[:, None, None] / sr
        )  # (Rc, res, sr)
        inside = (s >= -1.0) & (s <= n)
        s_eff = jnp.clip(s, 0.0, float(n - 1))
        grid = jnp.arange(n, dtype=jnp.float32)
        wts = jnp.maximum(0.0, 1.0 - jnp.abs(s_eff[..., None] - grid))
        wts = wts * inside[..., None].astype(jnp.float32)
        return wts.sum(axis=2) / sr  # (Rc, res, n)

    def one_chunk(rois_chunk):
        rc = rois_chunk.shape[0]
        batch_idx = rois_chunk[:, 0].astype(jnp.int32)
        x1 = rois_chunk[:, 1] * spatial_scale
        y1 = rois_chunk[:, 2] * spatial_scale
        x2 = rois_chunk[:, 3] * spatial_scale
        y2 = rois_chunk[:, 4] * spatial_scale
        bin_w = jnp.maximum(x2 - x1, 1.0) / res
        bin_h = jnp.maximum(y2 - y1, 1.0) / res

        wy = axis_weights(y1, bin_h, h)  # (Rc, res, h)
        wx = axis_weights(x1, bin_w, w)  # (Rc, res, w)
        # fold each roi's batch selection into the first contraction's
        # row weights
        onb = (
            batch_idx[:, None] == jnp.arange(b, dtype=jnp.int32)[None, :]
        ).astype(jnp.float32)
        w1, n1 = (wx, w) if x_first else (wy, h)
        w2 = wy if x_first else wx
        w1b = (onb[:, None, :, None] * w1[:, :, None, :]).reshape(
            rc * res, b * n1
        )
        keep = h if x_first else w
        out1 = jax.lax.dot_general(
            w1b, fmat, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        ).reshape(rc, res, keep, c).astype(features.dtype)
        # operand order keeps C the minor (lane) dim of the result — any
        # remaining (res, res) swap is a cheap sublane shuffle, not a
        # lane-dim relayout
        out2 = jax.lax.dot_general(
            w2, out1, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # x_first: (Rc, res_y, res_x, c); else (Rc, res_x, res_y, c)
        if not x_first:
            out2 = out2.transpose(0, 2, 1, 3)
        return out2.astype(features.dtype)

    r = rois.shape[0]
    if r <= roi_chunk:
        return one_chunk(rois)
    pad = (-r) % roi_chunk
    rois_p = jnp.pad(rois, ((0, pad), (0, 0)))
    chunks = rois_p.reshape(-1, roi_chunk, 5)
    out = jax.lax.map(one_chunk, chunks)
    return out.reshape(-1, res, res, c)[:r]


def roi_pool(
    features: jnp.ndarray,  # (B, H, W, C)
    rois: jnp.ndarray,  # (R, 5)
    spatial_scale: float,
    resolution: int,
    roi_chunk: int = 32,
) -> jnp.ndarray:
    """RoIPoolF max pooling, exact semantics (roi_pool_f_op.cu:36-95):
    rounded roi coords, +1 extents, floor/ceil bin edges clipped to the map,
    empty bins = 0. Static-shape strategy: every bin maxes over a fixed
    window of the maximum possible bin size with out-of-bin positions
    masked."""
    features = jnp.asarray(features)
    b, h, w, c = features.shape
    res = resolution
    # a bin spans at most ceil(map/res)+1 rows/cols (floor/ceil edges)
    max_bh = int(np.ceil(h / res)) + 1
    max_bw = int(np.ceil(w / res)) + 1

    def one_chunk(rois_chunk):
        batch_idx = rois_chunk[:, 0].astype(jnp.int32)
        x1 = jnp.round(rois_chunk[:, 1] * spatial_scale).astype(jnp.int32)
        y1 = jnp.round(rois_chunk[:, 2] * spatial_scale).astype(jnp.int32)
        x2 = jnp.round(rois_chunk[:, 3] * spatial_scale).astype(jnp.int32)
        y2 = jnp.round(rois_chunk[:, 4] * spatial_scale).astype(jnp.int32)
        roi_w = jnp.maximum(x2 - x1 + 1, 1).astype(jnp.float32)
        roi_h = jnp.maximum(y2 - y1 + 1, 1).astype(jnp.float32)
        bin_h = roi_h / res
        bin_w = roi_w / res

        pidx = jnp.arange(res, dtype=jnp.float32)
        hstart = jnp.floor(pidx[None, :] * bin_h[:, None]).astype(jnp.int32)
        hend = jnp.ceil((pidx[None, :] + 1) * bin_h[:, None]).astype(jnp.int32)
        wstart = jnp.floor(pidx[None, :] * bin_w[:, None]).astype(jnp.int32)
        wend = jnp.ceil((pidx[None, :] + 1) * bin_w[:, None]).astype(jnp.int32)
        hstart = jnp.clip(hstart + y1[:, None], 0, h)
        hend = jnp.clip(hend + y1[:, None], 0, h)
        wstart = jnp.clip(wstart + x1[:, None], 0, w)
        wend = jnp.clip(wend + x1[:, None], 0, w)

        dh = jnp.arange(max_bh)
        dw = jnp.arange(max_bw)
        # (R, res, max_bh)
        hs = jnp.clip(hstart[:, :, None] + dh[None, None, :], 0, h - 1)
        hvalid = (hstart[:, :, None] + dh[None, None, :]) < hend[:, :, None]
        ws = jnp.clip(wstart[:, :, None] + dw[None, None, :], 0, w - 1)
        wvalid = (wstart[:, :, None] + dw[None, None, :]) < wend[:, :, None]

        def per_roi(bi, hs_r, hv_r, ws_r, wv_r):
            # gather (res, max_bh, res, max_bw, C)
            f = features[bi]  # (H, W, C)
            vals = f[hs_r[:, :, None, None], ws_r[None, None, :, :]]
            mask = hv_r[:, :, None, None, None] & wv_r[None, None, :, :, None]
            vals = jnp.where(mask, vals, -jnp.inf)
            out = vals.max(axis=(1, 3))  # (res, res, C)
            return jnp.where(jnp.isfinite(out), out, 0.0)  # empty bin = 0

        return jax.vmap(per_roi)(batch_idx, hs, hvalid, ws, wvalid)

    r = rois.shape[0]
    if r <= roi_chunk:
        return one_chunk(rois)
    pad = (-r) % roi_chunk
    rois_p = jnp.pad(rois, ((0, pad), (0, 0)))
    out = jax.lax.map(one_chunk, rois_p.reshape(-1, roi_chunk, 5))
    return out.reshape(-1, res, res, c)[:r]


def ps_roi_pool(
    features: jnp.ndarray,  # (B, H, W, res*res*C_out)
    rois: jnp.ndarray,  # (R, 5)
    spatial_scale: float,
    resolution: int,
    output_dim: int,
    roi_chunk: int = 32,
) -> jnp.ndarray:
    """Position-sensitive RoI average pooling (R-FCN, ps_roi_pool_op.cu):
    bin (ph, pw) averages channel group (ph*res + pw) of the score maps.
    Returns (R, res, res, output_dim)."""
    features = jnp.asarray(features)
    b, h, w, d = features.shape
    res = resolution
    assert d == res * res * output_dim, (d, res, output_dim)
    # regroup channels: (B, H, W, res, res, C_out)
    f = features.reshape(b, h, w, res, res, output_dim)
    max_bh = int(np.ceil(h / res)) + 1
    max_bw = int(np.ceil(w / res)) + 1

    def one_chunk(rois_chunk):
        batch_idx = rois_chunk[:, 0].astype(jnp.int32)
        # R-FCN rounds to bin edges (ps_roi_pool_op.cu uses round(x)*scale)
        x1 = jnp.round(rois_chunk[:, 1]) * spatial_scale
        y1 = jnp.round(rois_chunk[:, 2]) * spatial_scale
        x2 = jnp.round(rois_chunk[:, 3] + 1.0) * spatial_scale
        y2 = jnp.round(rois_chunk[:, 4] + 1.0) * spatial_scale
        roi_w = jnp.maximum(x2 - x1, 0.1)
        roi_h = jnp.maximum(y2 - y1, 0.1)
        bin_h = roi_h / res
        bin_w = roi_w / res

        pidx = jnp.arange(res, dtype=jnp.float32)
        hstart = jnp.floor(pidx[None, :] * bin_h[:, None] + y1[:, None]).astype(jnp.int32)
        hend = jnp.ceil((pidx[None, :] + 1) * bin_h[:, None] + y1[:, None]).astype(jnp.int32)
        wstart = jnp.floor(pidx[None, :] * bin_w[:, None] + x1[:, None]).astype(jnp.int32)
        wend = jnp.ceil((pidx[None, :] + 1) * bin_w[:, None] + x1[:, None]).astype(jnp.int32)
        hstart = jnp.clip(hstart, 0, h)
        hend = jnp.clip(hend, 0, h)
        wstart = jnp.clip(wstart, 0, w)
        wend = jnp.clip(wend, 0, w)

        dh = jnp.arange(max_bh)
        dw = jnp.arange(max_bw)
        hs = jnp.clip(hstart[:, :, None] + dh[None, None, :], 0, h - 1)
        hvalid = (hstart[:, :, None] + dh[None, None, :]) < hend[:, :, None]
        ws = jnp.clip(wstart[:, :, None] + dw[None, None, :], 0, w - 1)
        wvalid = (wstart[:, :, None] + dw[None, None, :]) < wend[:, :, None]

        def per_roi2(bi, hs_r, hv_r, ws_r, wv_r):
            fb = f[bi]
            out = []
            for ph in range(res):
                row = []
                for pw in range(res):
                    win = fb[hs_r[ph][:, None], ws_r[pw][None, :], ph, pw]  # (mbh,mbw,C)
                    m = (hv_r[ph][:, None] & wv_r[pw][None, :])[..., None]
                    s = jnp.where(m, win, 0.0).sum(axis=(0, 1))
                    cnt = jnp.maximum(m.sum(), 1)
                    row.append(s / cnt)
                out.append(jnp.stack(row))
            return jnp.stack(out)  # (res, res, C_out)

        return jax.vmap(per_roi2)(batch_idx, hs, hvalid, ws, wvalid)

    r = rois.shape[0]
    if r <= roi_chunk:
        return one_chunk(rois)
    pad = (-r) % roi_chunk
    rois_p = jnp.pad(rois, ((0, pad), (0, 0)))
    out = jax.lax.map(one_chunk, rois_p.reshape(-1, roi_chunk, 5))
    return out.reshape(-1, res, res, output_dim)[:r]


# --------------------------------------------------------------------------- #
# Softmax focal loss (RETINANET.SOFTMAX path)
# --------------------------------------------------------------------------- #


def group_spatial_softmax(logits: jnp.ndarray, num_classes: int) -> jnp.ndarray:
    """Per-anchor-group softmax over the class sub-axis
    (group_spatial_softmax_op.cu SpatialSoftmaxKernel). logits (..., A*C)."""
    shape = logits.shape
    a = shape[-1] // num_classes
    grouped = logits.reshape(shape[:-1] + (a, num_classes))
    return jax.nn.softmax(grouped, axis=-1).reshape(shape)


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5))
def softmax_focal_loss(
    logits: jnp.ndarray,  # (..., A, C) — C includes background at index 0
    labels: jnp.ndarray,  # (..., A) int32: -1 ignore / 0 bg / 1..C-1 fg
    normalizer: jnp.ndarray,  # scalar fg count
    gamma: float,
    alpha: float,
    scale: float,
) -> jnp.ndarray:
    """Softmax variant of the focal loss (softmax_focal_loss_op.cu:55-90):
    per anchor cell, z = (1-alpha)/Np for bg, alpha/Np for fg;
    loss = -(1-p_label)^gamma * log(p_label) * z, ignored where label<0."""
    loss, _ = _sfl_fwd_impl(logits, labels, normalizer, gamma, alpha, scale)
    return loss


def _sfl_terms(logits, labels, normalizer, alpha):
    p = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    t = labels.astype(jnp.int32)
    Np = jnp.maximum(jnp.asarray(normalizer, jnp.float32), 1.0)
    z = jnp.where(t == 0, (1.0 - alpha) / Np, 0.0) + jnp.where(
        t >= 1, alpha / Np, 0.0
    )
    p_label = jnp.take_along_axis(
        p, jnp.maximum(t, 0)[..., None], axis=-1
    )[..., 0]
    return p, p_label, t, z


def _sfl_fwd_impl(logits, labels, normalizer, gamma, alpha, scale):
    p, p_label, t, z = _sfl_terms(logits, labels, normalizer, alpha)
    losses = jnp.where(
        t >= 0,
        -jnp.power(1.0 - p_label, gamma)
        * jnp.log(jnp.maximum(p_label, FLT_MIN))
        * z,
        0.0,
    )
    return jnp.float32(scale) * jnp.sum(losses, dtype=jnp.float32), None


def _sfl_fwd(logits, labels, normalizer, gamma, alpha, scale):
    loss, _ = _sfl_fwd_impl(logits, labels, normalizer, gamma, alpha, scale)
    return loss, (logits, labels, normalizer)


def _sfl_bwd(gamma, alpha, scale, res, g):
    logits, labels, normalizer = res
    p, p_label, t, z = _sfl_terms(logits, labels, normalizer, alpha)
    onemp = 1.0 - p_label
    # buff (softmax_focal_loss_op.cu:96-113)
    buff = jnp.where(
        t >= 0,
        (
            -jnp.power(onemp, gamma)
            + gamma
            * jnp.power(onemp, gamma - 1.0)
            * p_label
            * jnp.log(jnp.maximum(p_label, FLT_MIN))
        )
        * z,
        0.0,
    )
    # dX (cu:118-140): c1*g*buff*(c2 - P)
    c = logits.shape[-1]
    d = jax.lax.broadcasted_iota(jnp.int32, logits.shape, logits.ndim - 1)
    c2 = (t[..., None] == d).astype(jnp.float32)
    dx = buff[..., None] * (c2 - p) * jnp.float32(g) * jnp.float32(scale)
    return (
        dx.astype(logits.dtype),
        np.zeros(labels.shape, dtype=jax.dtypes.float0),
        jnp.zeros_like(jnp.asarray(normalizer, jnp.float32)),
    )


softmax_focal_loss.defvjp(_sfl_fwd, _sfl_bwd)


# --------------------------------------------------------------------------- #
# Mask loss + misc elementwise ops
# --------------------------------------------------------------------------- #


def sigmoid_cross_entropy_loss(
    logits: jnp.ndarray, targets: jnp.ndarray, scale: float = 1.0
) -> jnp.ndarray:
    """Mean stable BCE over non-ignored (-1) elements
    (sigmoid_cross_entropy_loss_op.cu:29-66: sum(losses)/max(count,1))."""
    x = logits.astype(jnp.float32)
    t = targets.astype(jnp.float32)
    valid = (targets != -1).astype(jnp.float32)
    ge = (x >= 0).astype(jnp.float32)
    losses = (-x * (t - ge) + jnp.log(1.0 + jnp.exp(x - 2.0 * x * ge))) * valid
    count = jnp.maximum(jnp.sum(valid), 1.0)
    return jnp.float32(scale) * jnp.sum(losses, dtype=jnp.float32) / count


def batch_permutation(x: jnp.ndarray, indices: jnp.ndarray) -> jnp.ndarray:
    """Reorder along the batch dim (batch_permutation_op.cu; FPN roi
    unshuffle)."""
    return x[indices.astype(jnp.int32)]


def sample_as(x: jnp.ndarray, labels: jnp.ndarray, max_out: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Select rows of x where labels > 0 (sample_as_op.cu — mask subsampling).
    Static-shape form: returns (x_selected (max_out, ...), valid (max_out,));
    rows beyond the fg count are zero/invalid."""
    fg = labels > 0
    order = jnp.argsort(~fg, stable=True)  # fg rows first, original order
    idx = order[:max_out]
    valid = fg[idx]
    out = jnp.where(
        valid.reshape((-1,) + (1,) * (x.ndim - 1)), x[idx], 0
    )
    return out, valid


def spatial_narrow_as(x: jnp.ndarray, like: jnp.ndarray) -> jnp.ndarray:
    """Crop x's H/W (dims 1, 2 in NHWC) to match `like`
    (spatial_narrow_as_op.cu)."""
    return x[:, : like.shape[1], : like.shape[2]]


def spatial_l2_loss(
    x: jnp.ndarray, y: jnp.ndarray, scale: float = 1.0
) -> jnp.ndarray:
    """0.5 * scale * mean squared error (spatial_l2_loss_op.cu — the L2
    feature-imitation loss; note the RETINANET.L2_LOSS flag is dead in the
    reference, SURVEY.md Appendix C.3)."""
    d = x.astype(jnp.float32) - y.astype(jnp.float32)
    return jnp.float32(scale) * 0.5 * jnp.mean(d * d, dtype=jnp.float32)


def spatial_sigmoid(x: jnp.ndarray) -> jnp.ndarray:
    """Elementwise sigmoid (spatial_sigmoid_op.cu)."""
    return jax.nn.sigmoid(x)


def affine_channel(x: jnp.ndarray, scale: jnp.ndarray, bias: jnp.ndarray) -> jnp.ndarray:
    """y = x * s + b per channel, functional form (affine_channel_op.cu).
    Gradient flows to x only in the reference (.cc:70-80); use
    stop_gradient on s/b to replicate when autodiffing through this."""
    return x * jax.lax.stop_gradient(scale) + jax.lax.stop_gradient(bias)


def upsample_nearest(x: jnp.ndarray, scale: int = 2) -> jnp.ndarray:
    """Nearest-neighbor upsample, NHWC (upsample_nearest_op.cu)."""
    n, h, w, c = x.shape
    x = jnp.broadcast_to(
        x[:, :, None, :, None, :], (n, h, scale, w, scale, c)
    )
    return x.reshape(n, h * scale, w * scale, c)


def zero_even(x: jnp.ndarray) -> jnp.ndarray:
    """Zero the even-indexed elements along dim 0 (the reference's tutorial
    custom op, detectron/lib/ops/zero_even_op.cu)."""
    idx = jnp.arange(x.shape[0])
    return jnp.where(
        (idx % 2 == 0).reshape((-1,) + (1,) * (x.ndim - 1)), 0, x
    )


# --------------------------------------------------------------------------- #
# OHEM trio (R-FCN online hard example mining)
# --------------------------------------------------------------------------- #


def softmax_with_loss_ohem(
    logits: jnp.ndarray,  # (R, C)
    labels: jnp.ndarray,  # (R,) int32
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-RoI softmax cross-entropy WITHOUT reduction
    (softmax_with_loss_OHEM_op.cu) — feeds BoxAnnotatorOHEM. Returns
    (per_roi_loss (R,), probs (R, C))."""
    p = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    t = jnp.maximum(labels.astype(jnp.int32), 0)
    p_label = jnp.take_along_axis(p, t[:, None], axis=-1)[:, 0]
    loss = jnp.where(
        labels >= 0, -jnp.log(jnp.maximum(p_label, FLT_MIN)), 0.0
    )
    return loss, p


def smooth_l1_loss_per_roi(
    y_hat: jnp.ndarray,  # (R, D)
    y: jnp.ndarray,
    inside_weights: jnp.ndarray,
    outside_weights: jnp.ndarray,
    beta: float = 1.0,
) -> jnp.ndarray:
    """Per-RoI smooth-L1 WITHOUT reduction (smooth_l1_loss_OHEM_op.cu)."""
    d = inside_weights * (y_hat.astype(jnp.float32) - y.astype(jnp.float32))
    ad = jnp.abs(d)
    huber = jnp.where(ad < beta, 0.5 * d * d / beta, ad - 0.5 * beta)
    return jnp.sum(outside_weights * huber, axis=-1)


def box_annotator_ohem(
    cls_loss: jnp.ndarray,  # (R,)
    bbox_loss: jnp.ndarray,  # (R,)
    labels: jnp.ndarray,  # (R,)
    roi_per_img: int,
) -> jnp.ndarray:
    """Select the top-`roi_per_img` hardest RoIs by total loss and return a
    per-RoI keep weight (1 kept / 0 dropped) — the selection semantics of
    box_annotator_ohem_op.cu, static-shape (weights instead of label surgery:
    multiply downstream losses by the returned weights)."""
    total = cls_loss + bbox_loss
    k = min(roi_per_img, total.shape[0])
    thresh = jax.lax.top_k(total, k)[0][-1]
    keep = (total >= thresh).astype(jnp.float32)
    # break ties beyond k deterministically by rank
    rank = jnp.argsort(jnp.argsort(-total))
    keep = keep * (rank < k)
    return keep
