"""Space-to-depth conv1 stem (S2D_STEM) is weight-equivalent to the 7x7/s2
conv: same parameter (name, shape, init), same outputs, so checkpoints and
the reference weight converter are unaffected by the flag."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from sad_tpu.models.resnet import Conv1S2D, _conv


def _ref_stem(x, kernel):
    conv = _conv("conv1", 64, 7, 2, dtype=jnp.float32)
    return conv.apply({"params": {"kernel": kernel}}, x)


class TestConv1S2D:
    def test_matches_7x7_stride2_conv(self):
        rng = np.random.RandomState(0)
        x = jnp.asarray(rng.randn(2, 32, 48, 3), jnp.float32)
        kernel = jnp.asarray(rng.randn(7, 7, 3, 64) * 0.1, jnp.float32)

        ref = _ref_stem(x, kernel)
        s2d = Conv1S2D(dtype=jnp.float32).apply(
            {"params": {"kernel": kernel}}, x
        )
        assert s2d.shape == ref.shape == (2, 16, 24, 64)
        np.testing.assert_allclose(
            np.asarray(s2d), np.asarray(ref), rtol=1e-5, atol=1e-5
        )

    def test_gradients_match(self):
        rng = np.random.RandomState(1)
        x = jnp.asarray(rng.randn(1, 16, 16, 3), jnp.float32)
        kernel = jnp.asarray(rng.randn(7, 7, 3, 64) * 0.1, jnp.float32)

        g_ref = jax.grad(lambda k: float(0) + _ref_stem(x, k).sum())(kernel)
        g_s2d = jax.grad(
            lambda k: Conv1S2D(dtype=jnp.float32)
            .apply({"params": {"kernel": k}}, x)
            .sum()
        )(kernel)
        assert g_s2d.shape == (7, 7, 3, 64)
        np.testing.assert_allclose(
            np.asarray(g_s2d), np.asarray(g_ref), rtol=1e-4, atol=1e-4
        )

    def test_full_model_flag_parity(self):
        """Same params, same RetinaNet outputs with S2D_STEM on/off."""
        from sad_tpu.config import Config
        from sad_tpu.config.config import merge_cfg_from_dict

        cfg = merge_cfg_from_dict(
            Config(),
            {
                "MODEL": {
                    "TYPE": "retinanet",
                    "NUM_CLASSES": 2,
                    "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body",
                },
                "FPN": {
                    "FPN_ON": True,
                    "RPN_MIN_LEVEL": 3,
                    "RPN_MAX_LEVEL": 7,
                    "EXTRA_CONV_LEVELS": True,
                    "COARSEST_STRIDE": 64,
                },
                "RETINANET": {
                    "RETINANET_ON": True,
                    "ASPECT_RATIOS": (1.0,),
                    "SCALES_PER_OCTAVE": 1,
                },
                "RESNETS": {"CHANNEL_RATIO": 0.125},
                "COMPUTE_DTYPE": "float32",
            },
        )
        from sad_tpu.models import create_model
        from sad_tpu.models.model_builder import init_model_params

        rng = np.random.RandomState(2)
        x = jnp.asarray(rng.randn(1, 64, 64, 3), jnp.float32)

        m0 = create_model(cfg)
        params = init_model_params(m0, jax.random.PRNGKey(0), (1, 64, 64, 3))
        m1 = create_model(dataclasses.replace(cfg, S2D_STEM=True))

        out0 = m0.apply({"params": params}, x)
        out1 = m1.apply({"params": params}, x)
        flat0 = jax.tree_util.tree_leaves(out0)
        flat1 = jax.tree_util.tree_leaves(out1)
        assert len(flat0) == len(flat1) > 0
        for a, b in zip(flat0, flat1):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4
            )
