"""Extended detectron op library vs NumPy transcriptions of the CUDA kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sad_tpu.ops import detectron_ops as D

FLT_MIN = np.finfo(np.float32).tiny


# ----------------------------------------------------------------- oracles


def np_bilinear(feat_hw, h, w, y, x):
    """bilinear_interpolate transcription (roi_align_op.cu:41-87)."""
    if y < -1.0 or y > h or x < -1.0 or x > w:
        return 0.0
    y = max(y, 0.0)
    x = max(x, 0.0)
    y_low, x_low = int(y), int(x)
    if y_low >= h - 1:
        y_high = y_low = h - 1
        y = float(y_low)
    else:
        y_high = y_low + 1
    if x_low >= w - 1:
        x_high = x_low = w - 1
        x = float(x_low)
    else:
        x_high = x_low + 1
    ly, lx = y - y_low, x - x_low
    hy, hx = 1 - ly, 1 - lx
    return (
        hy * hx * feat_hw[y_low, x_low]
        + hy * lx * feat_hw[y_low, x_high]
        + ly * hx * feat_hw[y_high, x_low]
        + ly * lx * feat_hw[y_high, x_high]
    )


def np_roi_align(features_nhwc, rois, scale, res, sr):
    """RoIAlignForward transcription (roi_align_op.cu:89-160)."""
    r = len(rois)
    b, h, w, c = features_nhwc.shape
    out = np.zeros((r, res, res, c), np.float32)
    for i, roi in enumerate(rois):
        bi = int(roi[0])
        x1, y1, x2, y2 = roi[1] * scale, roi[2] * scale, roi[3] * scale, roi[4] * scale
        rw = max(x2 - x1, 1.0)
        rh = max(y2 - y1, 1.0)
        bh, bw = rh / res, rw / res
        for ch in range(c):
            fm = features_nhwc[bi, :, :, ch]
            for ph in range(res):
                for pw in range(res):
                    acc = 0.0
                    for iy in range(sr):
                        yy = y1 + ph * bh + (iy + 0.5) * bh / sr
                        for ix in range(sr):
                            xx = x1 + pw * bw + (ix + 0.5) * bw / sr
                            acc += np_bilinear(fm, h, w, yy, xx)
                    out[i, ph, pw, ch] = acc / (sr * sr)
    return out


def np_roi_pool(features_nhwc, rois, scale, res):
    """RoIPoolFForward transcription (roi_pool_f_op.cu:36-95)."""
    r = len(rois)
    b, h, w, c = features_nhwc.shape
    out = np.zeros((r, res, res, c), np.float32)
    for i, roi in enumerate(rois):
        bi = int(roi[0])
        x1 = int(round(roi[1] * scale))
        y1 = int(round(roi[2] * scale))
        x2 = int(round(roi[3] * scale))
        y2 = int(round(roi[4] * scale))
        rw = max(x2 - x1 + 1, 1)
        rh = max(y2 - y1 + 1, 1)
        bh, bw = rh / res, rw / res
        for ph in range(res):
            for pw in range(res):
                hs = min(max(int(np.floor(ph * bh)) + y1, 0), h)
                he = min(max(int(np.ceil((ph + 1) * bh)) + y1, 0), h)
                ws = min(max(int(np.floor(pw * bw)) + x1, 0), w)
                we = min(max(int(np.ceil((pw + 1) * bw)) + x1, 0), w)
                if he <= hs or we <= ws:
                    out[i, ph, pw, :] = 0.0
                else:
                    out[i, ph, pw, :] = features_nhwc[bi, hs:he, ws:we, :].max(
                        axis=(0, 1)
                    )
    return out


# ------------------------------------------------------------------- tests


class TestRoIAlign:
    @pytest.mark.parametrize(
        "seed,hw", [(0, (12, 16)), (1, (12, 16)), (0, (16, 12))]
    )  # wide hits the x-first contraction order, tall the y-first
    def test_matches_cuda_transcription(self, seed, hw):
        rng = np.random.RandomState(seed)
        feats = rng.randn(2, hw[0], hw[1], 3).astype(np.float32)
        rois = np.array(
            [
                [0, 4.0, 4.0, 40.0, 36.0],
                [1, 0.0, 0.0, 63.0, 47.0],
                [0, 10.3, 7.7, 25.9, 30.1],
                [1, 50.0, 40.0, 20.0, 10.0],  # malformed -> 1x1
            ],
            np.float32,
        )
        ref = np_roi_align(feats, rois, 0.25, 5, 2)
        got = jax.jit(
            lambda f, r: D.roi_align(f, r, 0.25, 5, sampling_ratio=2)
        )(feats, rois)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4, atol=1e-5)

    def test_chunked_equals_unchunked(self):
        rng = np.random.RandomState(2)
        feats = rng.randn(1, 8, 8, 4).astype(np.float32)
        rois = np.concatenate(
            [np.zeros((10, 1)), rng.uniform(0, 30, (10, 4))], axis=1
        ).astype(np.float32)
        a = D.roi_align(feats, rois, 0.25, 3, 2, roi_chunk=4)
        b = D.roi_align(feats, rois, 0.25, 3, 2, roi_chunk=64)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-5)


def _multilevel_case():
    """FPN levels P2..P5 of a 256x384 canvas and rois spanning them: small
    (P2), large (P4/P5), extreme aspect ratios, a zero-area roi (1-px bin
    rule) and invalid slots."""
    rng = np.random.RandomState(0)
    b, c = 2, 4
    hc, wc = 256, 384
    feats = {
        l: rng.randn(b, hc // 2 ** l, wc // 2 ** l, c).astype(np.float32)
        for l in (2, 3, 4, 5)
    }
    r = 21
    x1 = rng.uniform(0, wc * 0.8, r)
    y1 = rng.uniform(0, hc * 0.8, r)
    w = np.concatenate(
        [rng.uniform(6, 40, 8), rng.uniform(100, 300, 5),
         rng.uniform(2, 6, 4), rng.uniform(200, 370, 4)]
    )
    h = np.concatenate(
        [rng.uniform(6, 40, 8), rng.uniform(100, 200, 5),
         rng.uniform(150, 250, 4), rng.uniform(1, 4, 4)]
    )
    rois = np.stack(
        [rng.randint(0, b, r).astype(np.float32), x1, y1,
         np.minimum(x1 + w, wc - 1), np.minimum(y1 + h, hc - 1)],
        axis=1,
    ).astype(np.float32)
    rois[-1, 1:] = [10.0, 10.0, 10.0, 10.0]
    valid = rng.rand(r) > 0.15
    return feats, rois, valid


class TestMultilevelRoIAlign:
    """ops/proposals.multilevel_roi_align: each roi is pooled from its FPN
    level (map_rois_to_fpn_levels) and invalid slots come back zero."""

    @pytest.mark.parametrize("res", [2, 7])
    def test_matches_per_level_cuda_transcription(self, res):
        from sad_tpu.ops.proposals import (
            map_rois_to_fpn_levels,
            multilevel_roi_align,
        )

        feats, rois, valid = _multilevel_case()
        levels = np.asarray(map_rois_to_fpn_levels(jnp.asarray(rois[:, 1:]), 2, 5))
        assert len(set(levels.tolist())) >= 2  # the case spans levels
        got = jax.jit(
            lambda f, r, l, v: multilevel_roi_align(f, r, l, v, res, 2)
        )(feats, rois, levels, valid)
        for i in range(len(rois)):
            lvl = int(levels[i])
            ref = np_roi_align(feats[lvl], rois[i:i + 1], 1.0 / 2 ** lvl, res, 2)
            want = ref[0] if valid[i] else np.zeros_like(ref[0])
            np.testing.assert_allclose(
                np.asarray(got[i]), want, rtol=1e-4, atol=1e-5
            )

    def test_gradient_reaches_only_assigned_levels(self):
        from sad_tpu.ops.proposals import (
            map_rois_to_fpn_levels,
            multilevel_roi_align,
        )

        feats, rois, valid = _multilevel_case()
        levels = map_rois_to_fpn_levels(jnp.asarray(rois[:, 1:]), 2, 5)
        keep = np.asarray(levels) != 3  # the P3 rois are masked invalid
        feats_j = {l: jnp.asarray(f) for l, f in feats.items()}

        def loss(f, rr):
            o = multilevel_roi_align(f, rr, levels, jnp.asarray(valid & keep), 7, 2)
            return jnp.sum(jnp.sin(o) * o)

        gf, gr = jax.grad(loss, argnums=(0, 1))(feats_j, jnp.asarray(rois))
        assert float(jnp.abs(gf[3]).max()) == 0.0
        assert float(jnp.abs(gf[5]).max()) == 0.0
        assert float(jnp.abs(gf[2]).max()) > 0.0
        # proposals are data: no gradient flows to roi coordinates
        assert float(jnp.abs(gr).max()) == 0.0


class TestRoIPool:
    def test_matches_cuda_transcription(self):
        rng = np.random.RandomState(0)
        feats = rng.randn(2, 10, 14, 3).astype(np.float32)
        rois = np.array(
            [
                [0, 0.0, 0.0, 55.0, 39.0],
                [1, 8.0, 8.0, 24.0, 24.0],
                [0, 30.0, 20.0, 10.0, 5.0],  # malformed
            ],
            np.float32,
        )
        ref = np_roi_pool(feats, rois, 0.25, 4)
        got = jax.jit(lambda f, r: D.roi_pool(f, r, 0.25, 4))(feats, rois)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5, atol=1e-6)


class TestSoftmaxFocalLoss:
    def _oracle(self, logits, labels, wp, gamma, alpha, scale):
        """softmax_focal_loss_op.cu:55-90 transcription, (..., A, C) layout."""
        p = np.exp(logits - logits.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        Np = max(wp, 1.0)
        z = np.where(labels == 0, (1 - alpha) / Np, 0.0) + np.where(
            labels >= 1, alpha / Np, 0.0
        )
        pl_ = np.take_along_axis(p, np.maximum(labels, 0)[..., None], -1)[..., 0]
        losses = np.where(
            labels >= 0,
            -np.power(1 - pl_, gamma) * np.log(np.maximum(pl_, FLT_MIN)) * z,
            0.0,
        )
        return scale * losses.sum(dtype=np.float64).astype(np.float32)

    def test_forward(self):
        rng = np.random.RandomState(0)
        logits = rng.randn(2, 4, 4, 3, 6).astype(np.float32)
        labels = rng.randint(-1, 6, (2, 4, 4, 3)).astype(np.int32)
        ref = self._oracle(logits, labels, 7.0, 2.0, 0.25, 0.5)
        got = D.softmax_focal_loss(
            jnp.asarray(logits), jnp.asarray(labels), jnp.float32(7.0),
            2.0, 0.25, 0.5,
        )
        np.testing.assert_allclose(np.asarray(got), ref, rtol=2e-4, atol=2e-5)

    def test_backward_shape_and_masking(self):
        rng = np.random.RandomState(1)
        logits = jnp.asarray(rng.randn(2, 3, 3, 2, 5), jnp.float32)
        labels = jnp.asarray(rng.randint(-1, 5, (2, 3, 3, 2)), jnp.int32)
        g = jax.grad(
            lambda x: D.softmax_focal_loss(x, labels, jnp.float32(4.0), 2.0, 0.25, 1.0)
        )(logits)
        # ignored cells (-1) get zero gradient across all classes
        ig = np.asarray(labels) == -1
        np.testing.assert_array_equal(np.asarray(g)[ig], 0.0)
        assert np.isfinite(np.asarray(g)).all()


class TestElementwiseOps:
    def test_sigmoid_cross_entropy_loss(self):
        rng = np.random.RandomState(0)
        x = rng.randn(40).astype(np.float32)
        t = rng.randint(-1, 2, 40).astype(np.int32)
        valid = t != -1
        p = 1 / (1 + np.exp(-x))
        ref = -(t * np.log(p) + (1 - t) * np.log(1 - p))
        ref = np.where(valid, ref, 0).sum() / max(valid.sum(), 1)
        got = D.sigmoid_cross_entropy_loss(jnp.asarray(x), jnp.asarray(t))
        np.testing.assert_allclose(float(got), ref, rtol=1e-4)

    def test_group_spatial_softmax(self):
        rng = np.random.RandomState(0)
        x = rng.randn(2, 4, 4, 6).astype(np.float32)  # A=2, C=3
        p = np.asarray(D.group_spatial_softmax(jnp.asarray(x), 3))
        sums = p.reshape(2, 4, 4, 2, 3).sum(-1)
        np.testing.assert_allclose(sums, 1.0, rtol=1e-5)

    def test_batch_permutation_and_zero_even(self):
        x = jnp.arange(12.0).reshape(4, 3)
        np.testing.assert_allclose(
            np.asarray(D.batch_permutation(x, jnp.asarray([2, 0, 3, 1]))),
            np.asarray(x)[[2, 0, 3, 1]],
        )
        z = np.asarray(D.zero_even(x))
        assert (z[0] == 0).all() and (z[2] == 0).all()
        np.testing.assert_allclose(z[1], np.asarray(x)[1])

    def test_spatial_narrow_as_and_upsample(self):
        x = jnp.ones((1, 6, 8, 2))
        like = jnp.zeros((1, 4, 5, 7))
        assert D.spatial_narrow_as(x, like).shape == (1, 4, 5, 2)
        u = D.upsample_nearest(jnp.arange(4.0).reshape(1, 2, 2, 1))
        assert u.shape == (1, 4, 4, 1)
        np.testing.assert_allclose(np.asarray(u)[0, :2, :2, 0], 0.0)

    def test_sample_as(self):
        x = jnp.arange(10.0).reshape(5, 2)
        labels = jnp.asarray([0, 1, 0, 2, 0])
        out, valid = D.sample_as(x, labels, 3)
        assert valid.tolist() == [True, True, False]
        np.testing.assert_allclose(np.asarray(out)[0], [2, 3])
        np.testing.assert_allclose(np.asarray(out)[1], [6, 7])

    def test_affine_channel_stops_gradient(self):
        x = jnp.ones((2, 3))
        s = jnp.asarray([2.0, 3.0, 4.0])
        b = jnp.asarray([0.1, 0.2, 0.3])
        gs = jax.grad(lambda ss: D.affine_channel(x, ss, b).sum())(s)
        assert float(jnp.abs(gs).max()) == 0.0


class TestOHEM:
    def test_per_roi_losses_and_selection(self):
        rng = np.random.RandomState(0)
        logits = jnp.asarray(rng.randn(8, 4), jnp.float32)
        labels = jnp.asarray([0, 1, 2, -1, 3, 0, 1, 2], jnp.int32)
        cls_loss, probs = D.softmax_with_loss_ohem(logits, labels)
        assert cls_loss.shape == (8,)
        assert float(cls_loss[3]) == 0.0  # ignored
        y_hat = jnp.asarray(rng.randn(8, 4), jnp.float32)
        y = jnp.zeros((8, 4))
        w = jnp.ones((8, 4))
        bbox_loss = D.smooth_l1_loss_per_roi(y_hat, y, w, w)
        keep = D.box_annotator_ohem(cls_loss, bbox_loss, labels, roi_per_img=3)
        assert float(keep.sum()) == 3.0
        total = np.asarray(cls_loss + bbox_loss)
        kept_idx = np.where(np.asarray(keep) > 0)[0]
        assert set(kept_idx) == set(np.argsort(-total)[:3])
