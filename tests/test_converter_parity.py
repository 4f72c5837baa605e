"""Converter layout parity for non-conv kernels.

The reference's released weights store:
- Dense (FC) kernels as (out, in) with CHW-flattened input rows
  (fast_rcnn_heads.py add_roi_2mlp_head flattens an NCHW RoI feature;
  mask_rcnn_heads.py:50-60 USE_FC_OUTPUT),
- ConvTranspose filters as IOHW computing the conv-adjoint
  (conv_transpose_op_impl.h:40-48; flax's ConvTranspose is a plain
  fractionally-strided correlation, so the kernel must also be spatially
  flipped — verified here against torch, whose deconv shares Caffe2's
  semantics).

These tests prove functional parity: a reference-layout computation and the
converted flax module produce identical outputs.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from sad_tpu.models import nn
from sad_tpu.train.checkpoint import (
    _kernel_to_flax,
    _kernel_to_ref,
    flax_to_reference_blobs,
    reference_blobs_to_flax,
)


class TestFCConversion:
    def test_fc_chw_to_hwc_functional_parity(self):
        """A reference FC applied to a CHW-flattened feature == the converted
        flax kernel applied to the HWC flatten of the same feature."""
        rng = np.random.RandomState(0)
        res, c, out = 7, 16, 32
        feat_chw = rng.randn(2, c, res, res).astype(np.float32)  # NCHW
        w_ref = rng.randn(out, c * res * res).astype(np.float32)  # (out, in_chw)

        y_ref = feat_chw.reshape(2, -1) @ w_ref.T

        k_flax = _kernel_to_flax(w_ref, "fc6", {"fc6": res})
        assert k_flax.shape == (res * res * c, out)
        feat_hwc = feat_chw.transpose(0, 2, 3, 1)  # NHWC (our layout)
        y_flax = feat_hwc.reshape(2, -1) @ k_flax

        np.testing.assert_allclose(y_flax, y_ref, rtol=1e-5, atol=1e-5)

    def test_fc_roundtrip(self):
        rng = np.random.RandomState(1)
        res, c, out = 7, 16, 32
        k = rng.randn(res * res * c, out).astype(np.float32)
        fc = {"fc6": res}
        back = _kernel_to_flax(_kernel_to_ref(k, "fc6", fc), "fc6", fc)
        np.testing.assert_array_equal(back, k)

    def test_plain_fc_no_permutation(self):
        """fc7 / cls_score (1-D input) get a pure transpose."""
        rng = np.random.RandomState(2)
        w_ref = rng.randn(8, 24).astype(np.float32)
        np.testing.assert_array_equal(
            _kernel_to_flax(w_ref, "fc7", {"fc6": 7}), w_ref.T
        )

    def test_2d_kernel_no_crash_in_tree_conversion(self):
        """Round-trip a tree mixing conv + FC kernels (the round-1 converter
        raised ValueError on any 2-D kernel)."""
        rng = np.random.RandomState(3)
        params = {
            "conv1": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)},
            "fc6": {
                "kernel": rng.randn(4 * 7 * 7, 16).astype(np.float32),
                "bias": np.zeros(16, np.float32),
            },
            "cls_score": {"kernel": rng.randn(16, 5).astype(np.float32)},
        }
        fc = {"fc6": 7}
        blobs = flax_to_reference_blobs(params, fc_resolutions=fc)
        assert blobs["fc6_w"].shape == (16, 4 * 7 * 7)
        assert blobs["cls_score_w"].shape == (5, 16)
        zeros = jax.tree_util.tree_map(np.zeros_like, params)
        restored, loaded, skipped = reference_blobs_to_flax(
            blobs, zeros, strict=True, fc_resolutions=fc
        )
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(a, b), params, restored
        )


class TestDeconvConversion:
    @pytest.mark.parametrize("k,s,cin,cout", [(2, 2, 3, 4), (4, 2, 3, 5)])
    def test_deconv_functional_parity_vs_torch(self, k, s, cin, cout):
        """Caffe2/torch ConvTranspose(IOHW weights) == flax ConvTranspose with
        the converted kernel. 4x4/2 uses pad=1 like kps_score_lowres
        (keypoint_rcnn_heads.py:79 pad=DECONV_KERNEL/2-1)."""
        torch = pytest.importorskip("torch")
        rng = np.random.RandomState(4)
        x = rng.randn(2, cin, 6, 6).astype(np.float32)
        w = rng.randn(cin, cout, k, k).astype(np.float32)
        pad = k // 2 - 1 if k > 2 else 0
        y_ref = torch.nn.functional.conv_transpose2d(
            torch.tensor(x), torch.tensor(w), stride=s, padding=pad
        ).numpy()

        mod = nn.ConvTranspose(cout, (k, k), strides=(s, s))
        k_flax = jnp.asarray(_kernel_to_flax(w, "conv5_mask", None))
        assert k_flax.shape == (k, k, cin, cout)
        y = mod.apply(
            {"params": {"kernel": k_flax, "bias": jnp.zeros(cout)}},
            jnp.asarray(x.transpose(0, 2, 3, 1)),
        )
        y = np.asarray(y)
        if k > 2:  # flax SAME-style sizing differs; crop to torch extent
            oh = y_ref.shape[2]
            y = y[:, :oh, :oh, :] if y.shape[1] >= oh else y
        np.testing.assert_allclose(
            y[:, : y_ref.shape[2], : y_ref.shape[3], :],
            y_ref.transpose(0, 2, 3, 1),
            rtol=1e-4,
            atol=1e-4,
        )

    def test_deconv_roundtrip(self):
        rng = np.random.RandomState(5)
        k = rng.randn(2, 2, 8, 8).astype(np.float32)  # flax HWIO
        back = _kernel_to_flax(_kernel_to_ref(k, "conv5_mask", None), "conv5_mask", None)
        np.testing.assert_array_equal(back, k)
