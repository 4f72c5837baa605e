"""Per-image blocking of the dense RoIAlign tent matmuls (slots_per_im).

A round-5 jaxpr audit found the batch-folded dense form spending ~half the
bs8 Mask R-CNN step FLOPs contracting cross-image zeros (the one-hot batch
selector is folded into the first tent matmul's columns, so the
contraction depth is B*axis instead of axis). slots_per_im is the caller's
static promise that rois are image-major with equal counts — every R-CNN
call site builds them that way — letting the op vmap per image. These
tests pin exact equivalence (outputs AND feature gradients) of the
blocked and unblocked forms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sad_tpu.ops.detectron_ops as D
from sad_tpu.ops.proposals import (
    dense_multilevel_roi_align,
    map_rois_to_fpn_levels,
)


def _image_major_rois(rng, b, s, hc, wc):
    x1 = rng.uniform(0, wc * 0.7, b * s)
    y1 = rng.uniform(0, hc * 0.7, b * s)
    w = rng.uniform(2, wc * 0.5, b * s)
    h = rng.uniform(2, hc * 0.5, b * s)
    col = np.repeat(np.arange(b), s).astype(np.float32)
    rois = np.stack(
        [col, x1, y1, np.minimum(x1 + w, wc - 1),
         np.minimum(y1 + h, hc - 1)], axis=1
    ).astype(np.float32)
    rois[3, 1:] = [9.0, 9.0, 9.0, 9.0]  # degenerate -> 1px-bin rule
    return jnp.asarray(rois)


class TestRoiAlignSlotsPerIm:
    @pytest.mark.parametrize("hw", [(12, 16), (16, 12)])
    def test_forward_equivalence(self, hw):
        rng = np.random.RandomState(0)
        b, s = 4, 10
        feats = jnp.asarray(rng.randn(b, *hw, 4).astype(np.float32))
        rois = _image_major_rois(rng, b, s, hw[0] * 4, hw[1] * 4)
        base = D.roi_align(feats, rois, 0.25, 5, 2)
        blocked = D.roi_align(feats, rois, 0.25, 5, 2, slots_per_im=s)
        np.testing.assert_allclose(
            np.asarray(blocked), np.asarray(base), rtol=1e-5, atol=1e-5
        )

    def test_chunking_under_blocking(self):
        """slots_per_im > roi_chunk: the inner per-image chunk loop."""
        rng = np.random.RandomState(1)
        b, s = 4, 9
        feats = jnp.asarray(rng.randn(b, 8, 8, 4).astype(np.float32))
        rois = _image_major_rois(rng, b, s, 32, 32)
        base = D.roi_align(feats, rois, 0.25, 3, 2, roi_chunk=4)
        blocked = D.roi_align(
            feats, rois, 0.25, 3, 2, roi_chunk=4, slots_per_im=s
        )
        np.testing.assert_allclose(
            np.asarray(blocked), np.asarray(base), rtol=1e-5, atol=1e-5
        )

    def test_batch_column_ignored(self):
        """The contract: with slots_per_im (and b >= 4, the measured
        win region), image ownership comes from the slot position, not
        the batch column."""
        rng = np.random.RandomState(2)
        b, s = 4, 6
        feats = jnp.asarray(rng.randn(b, 8, 8, 4).astype(np.float32))
        rois = _image_major_rois(rng, b, s, 32, 32)
        scrambled = rois.at[:, 0].set(
            jnp.asarray(rng.randint(0, b, b * s), jnp.float32)
        )
        a = D.roi_align(feats, rois, 0.25, 3, 2, slots_per_im=s)
        bb = D.roi_align(feats, scrambled, 0.25, 3, 2, slots_per_im=s)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(bb))

    def test_small_batch_gate(self):
        """b < 4 keeps the batch-folded form (chip-measured: blocking
        LOSES ~3% at bs2) — slots_per_im is then semantically inert, so
        the batch column is honored again."""
        rng = np.random.RandomState(7)
        b, s = 2, 6
        feats = jnp.asarray(rng.randn(b, 8, 8, 4).astype(np.float32))
        rois = _image_major_rois(rng, b, s, 32, 32)
        base = D.roi_align(feats, rois, 0.25, 3, 2)
        gated = D.roi_align(feats, rois, 0.25, 3, 2, slots_per_im=s)
        np.testing.assert_array_equal(np.asarray(gated), np.asarray(base))

    def test_shape_mismatch_raises(self):
        feats = jnp.zeros((2, 8, 8, 4))
        rois = jnp.zeros((7, 5))
        with pytest.raises(ValueError, match="slots_per_im"):
            D.roi_align(feats, rois, 0.25, 3, 2, slots_per_im=4)

    def test_feature_grads_equal(self):
        rng = np.random.RandomState(3)
        b, s = 4, 8
        feats = jnp.asarray(rng.randn(b, 10, 14, 4).astype(np.float32))
        rois = _image_major_rois(rng, b, s, 40, 56)
        cot = jnp.asarray(rng.randn(b * s, 5, 5, 4).astype(np.float32))

        def loss(f, spi):
            return jnp.sum(
                D.roi_align(f, rois, 0.25, 5, 2, slots_per_im=spi) * cot
            )

        g0 = jax.grad(lambda f: loss(f, 0))(feats)
        g1 = jax.grad(lambda f: loss(f, s))(feats)
        np.testing.assert_allclose(
            np.asarray(g1), np.asarray(g0), rtol=1e-4, atol=1e-5
        )


class TestMultilevelSlotsPerIm:
    def _setup(self, seed=0, b=4, s=12, c=8):
        rng = np.random.RandomState(seed)
        hc, wc = 256, 384
        feats = {
            l: jnp.asarray(
                rng.randn(b, hc // 2 ** l, wc // 2 ** l, c)
                .astype(np.float32)
            )
            for l in (2, 3, 4, 5)
        }
        rois = _image_major_rois(rng, b, s, hc, wc)
        levels = map_rois_to_fpn_levels(rois[:, 1:], 2, 5)
        valid = jnp.asarray(rng.rand(b * s) > 0.2)
        return feats, rois, levels, valid

    def test_dense_multilevel_equivalence(self):
        feats, rois, levels, valid = self._setup()
        a = dense_multilevel_roi_align(feats, rois, levels, valid, 7, 2)
        bb = dense_multilevel_roi_align(
            feats, rois, levels, valid, 7, 2, slots_per_im=12
        )
        np.testing.assert_allclose(
            np.asarray(bb), np.asarray(a), rtol=1e-5, atol=1e-5
        )

    def test_hybrid_dispatch_grads(self):
        """multilevel_roi_align with slots_per_im (per-image blocking):
        outputs and feature grads match the unblocked form."""
        from sad_tpu.ops.proposals import multilevel_roi_align

        feats, rois, levels, valid = self._setup(seed=4)
        cot = None

        def run(f, spi):
            out = multilevel_roi_align(
                f, rois, levels, valid, 7, 2, slots_per_im=spi
            )
            nonlocal cot
            if cot is None:
                cot = jnp.asarray(
                    np.random.RandomState(5).randn(*out.shape)
                    .astype(np.float32)
                )
            return jnp.sum(out * cot)

        v0, g0 = jax.value_and_grad(lambda f: run(f, 0))(feats)
        v1, g1 = jax.value_and_grad(lambda f: run(f, 12))(feats)
        np.testing.assert_allclose(float(v1), float(v0), rtol=1e-5)
        for l in g0:
            np.testing.assert_allclose(
                np.asarray(g1[l]), np.asarray(g0[l]), rtol=1e-4, atol=1e-5
            )
