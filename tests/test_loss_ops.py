"""Numeric parity tests: sad_tpu.ops.losses vs the NumPy golden transcriptions
of the reference CUDA kernels (sad_tpu.ops.reference_numpy).

Mirrors the Caffe2 testing pattern (assertReferenceChecks /
assertGradientChecks, caffe2/python/hypothesis_test_util.py) with randomized
cases; the reference itself ships NO tests for these ops (SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sad_tpu.ops import losses as L
from sad_tpu.ops import reference_numpy as R

ATOL = 2e-5
RTOL = 2e-4


def _rand_case(seed, n=2, a=3, c=5, h=4, w=6):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, a * c, h, w).astype(np.float32) * 3.0
    teacher_probs = rng.uniform(1e-4, 1 - 1e-4, (n, a * c, h, w)).astype(np.float32)
    # labels: -1 ignore / 0 bg / 1..c fg
    labels = rng.randint(-1, c + 1, (n, a, h, w)).astype(np.int32)
    wp = float(rng.uniform(0.0, 50.0))
    return logits, teacher_probs, labels, wp


def _nchw_to_nhwac(logits_nchw, num_classes):
    """(N, A*C, H, W) -> (N, H, W, A, C) — the sad_tpu loss layout."""
    n, d, h, w = logits_nchw.shape
    a = d // num_classes
    return (
        logits_nchw.reshape(n, a, num_classes, h, w).transpose(0, 3, 4, 1, 2)
    )


def _labels_to_nhwa(labels_nahw):
    return labels_nahw.transpose(0, 2, 3, 1)  # (N, H, W, A)


class TestSigmoidFocalLoss:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("wp_small", [False, True])
    def test_forward_matches_cuda_transcription(self, seed, wp_small):
        logits, _, labels, wp = _rand_case(seed)
        if wp_small:
            wp = 0.3  # exercises the max(wp, 1) clamp
        gamma, alpha, scale, c = 2.0, 0.25, 1.0 / 8.0, 5

        ref, _ = R.sigmoid_focal_loss_fwd(logits, labels, wp, gamma, alpha, c, scale)
        got = L.sigmoid_focal_loss(
            jnp.asarray(_nchw_to_nhwac(logits, c)),
            jnp.asarray(_labels_to_nhwa(labels)),
            jnp.float32(wp),
            gamma,
            alpha,
            scale,
        )
        np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("seed", [3, 4])
    def test_backward_matches_cuda_transcription(self, seed):
        logits, _, labels, wp = _rand_case(seed)
        gamma, alpha, scale, c = 2.0, 0.25, 0.125, 5
        g = 1.7  # incoming d(avg_loss)

        ref_dx = R.sigmoid_focal_loss_bwd(
            logits, labels, wp, gamma, alpha, c, scale, g
        )
        f = lambda x: g * L.sigmoid_focal_loss(
            x,
            jnp.asarray(_labels_to_nhwa(labels)),
            jnp.float32(wp),
            gamma,
            alpha,
            scale,
        )
        got_dx = jax.grad(f)(jnp.asarray(_nchw_to_nhwac(logits, c)))
        # map back to NCHW for comparison
        got_nchw = np.asarray(got_dx).transpose(0, 3, 4, 1, 2).reshape(logits.shape)
        np.testing.assert_allclose(got_nchw, ref_dx, rtol=RTOL, atol=ATOL)

    def test_all_ignore_gives_zero(self):
        logits, _, labels, _ = _rand_case(7)
        labels[:] = -1
        got = L.sigmoid_focal_loss(
            jnp.asarray(_nchw_to_nhwac(logits, 5)),
            jnp.asarray(_labels_to_nhwa(labels)),
            jnp.float32(10.0),
            2.0,
            0.25,
            1.0,
        )
        assert float(got) == 0.0


class TestSigmoidAdaptiveDistillLoss:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    @pytest.mark.parametrize("beta", [0.0])
    def test_forward_matches_cuda_transcription(self, seed, beta):
        logits, pt, labels, wp = _rand_case(seed)
        gamma, alpha, scale, c = 2.0, 0.5, 0.125, 5
        ignored = -1

        ref, _ = R.sigmoid_adaptive_distill_loss_fwd(
            logits, pt, labels, wp, gamma, alpha, beta, c, ignored, scale
        )
        got = L.sigmoid_adaptive_distill_loss(
            jnp.asarray(_nchw_to_nhwac(logits, c)),
            jnp.asarray(_nchw_to_nhwac(pt, c)),
            jnp.asarray(_labels_to_nhwa(labels)),
            jnp.float32(wp),
            gamma,
            alpha,
            beta,
            ignored,
            scale,
        )
        np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL, atol=ATOL)

    def test_forward_beta_nonzero(self):
        # beta != 0 exercises the teacher-entropy term (KL when beta=1);
        # teacher probs away from {0,1} so the reference math is finite.
        logits, pt, labels, wp = _rand_case(11)
        gamma, alpha, beta, scale, c = 2.0, 0.5, 1.0, 1.0, 5
        ref, _ = R.sigmoid_adaptive_distill_loss_fwd(
            logits, pt, labels, wp, gamma, alpha, beta, c, -1, scale
        )
        got = L.sigmoid_adaptive_distill_loss(
            jnp.asarray(_nchw_to_nhwac(logits, c)),
            jnp.asarray(_nchw_to_nhwac(pt, c)),
            jnp.asarray(_labels_to_nhwa(labels)),
            jnp.float32(wp),
            gamma,
            alpha,
            beta,
            -1,
            scale,
        )
        np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL, atol=ATOL)

    @pytest.mark.parametrize("seed", [5, 6])
    def test_backward_matches_cuda_transcription(self, seed):
        logits, pt, labels, wp = _rand_case(seed)
        gamma, alpha, beta, scale, c = 2.0, 0.5, 0.0, 0.125, 5
        g = 2.3

        ref_dx = R.sigmoid_adaptive_distill_loss_bwd(
            logits, pt, labels, wp, gamma, alpha, beta, c, -1, scale, g
        )
        f = lambda x: g * L.sigmoid_adaptive_distill_loss(
            x,
            jnp.asarray(_nchw_to_nhwac(pt, c)),
            jnp.asarray(_labels_to_nhwa(labels)),
            jnp.float32(wp),
            gamma,
            alpha,
            beta,
            -1,
            scale,
        )
        got_dx = jax.grad(f)(jnp.asarray(_nchw_to_nhwac(logits, c)))
        got_nchw = np.asarray(got_dx).transpose(0, 3, 4, 1, 2).reshape(logits.shape)
        np.testing.assert_allclose(got_nchw, ref_dx, rtol=RTOL, atol=ATOL)

    def test_no_gradient_to_teacher(self):
        logits, pt, labels, wp = _rand_case(9)
        c = 5
        f = lambda tp: L.sigmoid_adaptive_distill_loss(
            jnp.asarray(_nchw_to_nhwac(logits, c)),
            tp,
            jnp.asarray(_labels_to_nhwa(labels)),
            jnp.float32(wp),
            2.0,
            0.5,
            0.0,
            -1,
            1.0,
        )
        dt = jax.grad(f)(jnp.asarray(_nchw_to_nhwac(pt, c)))
        assert float(jnp.abs(dt).max()) == 0.0


class TestPowSum:
    def test_matches_reference(self):
        rng = np.random.RandomState(0)
        arrs = [rng.uniform(0, 1, (2, 45, 8, 8)).astype(np.float32) for _ in range(5)]
        ref = R.pow_sum(arrs, 1.8)
        got = L.pow_sum([jnp.asarray(a) for a in arrs], 1.8)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5)


class TestSelectSmoothL1Loss:
    def _sparse_case(self, seed, n=2, a=3, h=5, w=7):
        """Build the reference's sparse (M,4) form and the dense form of
        the same problem, and check the loss values agree."""
        rng = np.random.RandomState(seed)
        d = 4 * a
        bbox_pred = rng.randn(n, d, h, w).astype(np.float32)
        # pick fg locations: (n, anchor, y, x) unique
        mask = rng.uniform(size=(n, a, h, w)) < 0.15
        idx = np.argwhere(mask)
        m = len(idx)
        targets = rng.randn(m, 4).astype(np.float32)
        locs = np.zeros((m, 4), dtype=np.float32)
        dense_targets = np.zeros((n, a, 4, h, w), dtype=np.float32)
        for i, (ni, ai, yi, xi) in enumerate(idx):
            locs[i] = [ni, ai * 4, yi, xi]  # anchor offset, cls-agnostic
            dense_targets[ni, ai, :, yi, xi] = targets[i]
        fg_num = float(m) + rng.uniform(0, 3)
        return bbox_pred, targets, locs, mask, dense_targets, fg_num

    @pytest.mark.parametrize("seed", [0, 1])
    def test_forward_matches_sparse_reference(self, seed):
        bbox_pred, targets, locs, mask, dense_targets, fg_num = self._sparse_case(seed)
        beta, scale = 0.11, 0.125
        ref, _ = R.select_smooth_l1_loss_fwd(bbox_pred, targets, locs, fg_num, beta, scale)

        n, d, h, w = bbox_pred.shape
        a = d // 4
        pred_dense = bbox_pred.reshape(n, a, 4, h, w).transpose(0, 3, 4, 1, 2)
        tgt_dense = dense_targets.transpose(0, 3, 4, 1, 2)
        mask_dense = mask.transpose(0, 2, 3, 1)
        got = L.select_smooth_l1_loss(
            jnp.asarray(pred_dense),
            jnp.asarray(tgt_dense),
            jnp.asarray(mask_dense),
            jnp.float32(fg_num),
            beta,
            scale,
        )
        np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL, atol=ATOL)

    def test_backward_matches_sparse_reference(self):
        bbox_pred, targets, locs, mask, dense_targets, fg_num = self._sparse_case(3)
        beta, scale, g = 0.11, 0.125, 1.9
        ref_dx = R.select_smooth_l1_loss_bwd(
            bbox_pred, targets, locs, fg_num, beta, scale, g
        )
        n, d, h, w = bbox_pred.shape
        a = d // 4
        pred_dense = bbox_pred.reshape(n, a, 4, h, w).transpose(0, 3, 4, 1, 2)
        tgt_dense = dense_targets.transpose(0, 3, 4, 1, 2)
        mask_dense = mask.transpose(0, 2, 3, 1)
        f = lambda x: g * L.select_smooth_l1_loss(
            x, jnp.asarray(tgt_dense), jnp.asarray(mask_dense),
            jnp.float32(fg_num), beta, scale,
        )
        got = jax.grad(f)(jnp.asarray(pred_dense))
        got_nchw = (
            np.asarray(got).transpose(0, 3, 4, 1, 2).reshape(bbox_pred.shape)
        )
        np.testing.assert_allclose(got_nchw, ref_dx, rtol=RTOL, atol=ATOL)

    def test_empty_fg_gives_zero_loss_and_grad(self):
        n, a, h, w = 1, 2, 3, 3
        pred = jnp.asarray(np.random.RandomState(0).randn(n, h, w, a, 4), jnp.float32)
        tgt = jnp.zeros_like(pred)
        mask = jnp.zeros((n, h, w, a), bool)
        loss = L.select_smooth_l1_loss(pred, tgt, mask, jnp.float32(0.0), 0.11, 1.0)
        assert float(loss) == 0.0
        dx = jax.grad(
            lambda x: L.select_smooth_l1_loss(x, tgt, mask, jnp.float32(0.0), 0.11, 1.0)
        )(pred)
        assert float(jnp.abs(dx).max()) == 0.0


class TestJitAndVmap:
    def test_losses_jit_and_vmap_per_group(self):
        # Per-device-group normalizers (the reference computes Np per GPU):
        # vmap the loss over a leading group axis with per-group normalizers.
        g, n, a, c, h, w = 4, 2, 3, 5, 4, 4
        rng = np.random.RandomState(0)
        logits = jnp.asarray(rng.randn(g, n, h, w, a, c), jnp.float32)
        pt = jnp.asarray(rng.uniform(0.01, 0.99, (g, n, h, w, a, c)), jnp.float32)
        labels = jnp.asarray(rng.randint(-1, c + 1, (g, n, h, w, a)), jnp.int32)
        norms = jnp.asarray(rng.uniform(1, 20, (g,)), jnp.float32)

        @jax.jit
        def per_group_losses(lg, tp, lb, nm):
            f = jax.vmap(
                lambda x, t, l, s: L.sigmoid_adaptive_distill_loss(
                    x, t, l, s, 2.0, 0.5, 0.0, -1, 0.25
                )
            )
            return f(lg, tp, lb, nm)

        out = per_group_losses(logits, pt, labels, norms)
        assert out.shape == (g,)
        ref0, _ = R.sigmoid_adaptive_distill_loss_fwd(
            np.asarray(logits[0]).transpose(0, 3, 4, 1, 2).reshape(n, a * c, h, w),
            np.asarray(pt[0]).transpose(0, 3, 4, 1, 2).reshape(n, a * c, h, w),
            np.asarray(labels[0]).transpose(0, 3, 1, 2),
            float(norms[0]),
            2.0, 0.5, 0.0, c, -1, 0.25,
        )
        np.testing.assert_allclose(np.asarray(out[0]), ref0, rtol=RTOL, atol=ATOL)


class TestRandomizedParitySweep:
    """Property-style sweep over random shapes/hyperparameters, mirroring the
    Caffe2 hypothesis_test_util pattern (SURVEY.md §4): many randomized
    configurations, each checked against the NumPy transcription."""

    def test_focal_and_distill_random_configs(self):
        rng = np.random.RandomState(1234)
        for trial in range(12):
            n = int(rng.randint(1, 3))
            a = int(rng.randint(1, 5))
            c = int(rng.choice([1, 2, 5, 11]))
            h = int(rng.randint(1, 7))
            w = int(rng.randint(1, 7))
            gamma = float(rng.choice([0.5, 1.0, 2.0, 4.0]))
            alpha = float(rng.uniform(0.05, 0.95))
            scale = float(rng.uniform(0.01, 2.0))
            wp = float(rng.uniform(0.0, 30.0))
            logits = rng.randn(n, a * c, h, w).astype(np.float32) * rng.uniform(0.5, 4)
            pt = rng.uniform(1e-4, 1 - 1e-4, (n, a * c, h, w)).astype(np.float32)
            labels = rng.randint(-1, c + 1, (n, a, h, w)).astype(np.int32)

            ref_f, _ = R.sigmoid_focal_loss_fwd(
                logits, labels, wp, gamma, alpha, c, scale
            )
            got_f = L.sigmoid_focal_loss(
                jnp.asarray(_nchw_to_nhwac(logits, c)),
                jnp.asarray(_labels_to_nhwa(labels)),
                jnp.float32(wp), gamma, alpha, scale,
            )
            np.testing.assert_allclose(
                np.asarray(got_f), ref_f, rtol=5e-4, atol=5e-5,
                err_msg=f"focal trial {trial}",
            )

            ref_d, _ = R.sigmoid_adaptive_distill_loss_fwd(
                logits, pt, labels, wp, gamma, alpha, 0.0, c, -1, scale
            )
            got_d = L.sigmoid_adaptive_distill_loss(
                jnp.asarray(_nchw_to_nhwac(logits, c)),
                jnp.asarray(_nchw_to_nhwac(pt, c)),
                jnp.asarray(_labels_to_nhwa(labels)),
                jnp.float32(wp), gamma, alpha, 0.0, -1, scale,
            )
            np.testing.assert_allclose(
                np.asarray(got_d), ref_d, rtol=5e-4, atol=5e-5,
                err_msg=f"distill trial {trial}",
            )
