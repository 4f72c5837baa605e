"""End-to-end Faster R-CNN training step + inference decode on a tiny trunk."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_rcnn import rcnn_cfg


def _tiny(cfg):
    return dataclasses.replace(
        cfg, RESNETS=dataclasses.replace(cfg.RESNETS, CHANNEL_RATIO=0.0625)
    )


@pytest.fixture(scope="module")
def tiny_rcnn():
    cfg = _tiny(rcnn_cfg(mask=True))
    cfg = dataclasses.replace(
        cfg,
        TRAIN=dataclasses.replace(
            cfg.TRAIN,
            RPN_PRE_NMS_TOP_N=40,
            RPN_POST_NMS_TOP_N=16,
            BATCH_SIZE_PER_IM=8,
            IMS_PER_BATCH=2,
        ),
    )
    from sad_tpu.models import create_model

    model = create_model(cfg)
    images = jnp.zeros((2, 64, 64, 3), jnp.float32)
    im_hw = jnp.asarray([[64, 64], [64, 64]], jnp.float32)
    params = model.init(
        jax.random.PRNGKey(0), images, im_hw, method="init_all"
    )["params"]
    return cfg, model, params


def _rcnn_batch(cfg, seed=0):
    from sad_tpu.data.rpn_minibatch import add_rpn_blobs_to_batch

    rng = np.random.RandomState(seed)
    b, h, w = 2, 64, 64
    batch = {
        "data": rng.randn(b, h, w, 3).astype(np.float32),
        "im_hw": np.asarray([[64, 64], [64, 64]], np.float32),
    }
    entries = []
    for i in range(b):
        entries.append(
            {
                "boxes": np.asarray([[8, 8, 40, 40], [20, 20, 60, 56]], np.float32),
                "gt_classes": np.asarray([1, 3], np.int32),
                "is_crowd": np.zeros(2, bool),
            }
        )
    add_rpn_blobs_to_batch(cfg, batch, entries, (h, w), np.ones(b), seed=seed)
    return jax.tree_util.tree_map(jnp.asarray, batch)


class TestRPNTargets:
    def test_sampling_caps_and_weights(self):
        cfg = _tiny(rcnn_cfg())
        batch = {}
        from sad_tpu.data.rpn_minibatch import add_rpn_blobs_to_batch

        entries = [
            {
                "boxes": np.asarray([[8, 8, 40, 40]], np.float32),
                "gt_classes": np.asarray([1], np.int32),
                "is_crowd": np.zeros(1, bool),
            }
        ]
        add_rpn_blobs_to_batch(cfg, batch, entries, (64, 64), np.ones(1))
        labels = np.concatenate(
            [batch["rpn_labels"][l].reshape(-1) for l in batch["rpn_labels"]]
        )
        n_sampled = (labels >= 0).sum()
        assert 0 < n_sampled <= cfg.TRAIN.RPN_BATCH_SIZE_PER_IM
        assert (labels == 1).sum() >= 1
        ow = np.concatenate(
            [
                batch["rpn_bbox_outside_weights"][l].reshape(-1, 4)
                for l in batch["rpn_bbox_outside_weights"]
            ]
        )
        nz = ow[ow[:, 0] > 0]
        np.testing.assert_allclose(nz, 1.0 / n_sampled, rtol=1e-5)


class TestRCNNTrainStep:
    def test_one_step_updates_and_is_finite(self, tiny_rcnn):
        cfg, model, params = tiny_rcnn
        from sad_tpu.train import TrainState, init_momentum_state
        from sad_tpu.train.rcnn_train import make_rcnn_train_step

        batch = _rcnn_batch(cfg)
        step = jax.jit(make_rcnn_train_step(cfg, model, n_groups=1))
        state = TrainState(params, init_momentum_state(params).velocity)
        new_state, metrics = step(
            state, batch, jnp.float32(1e-4), jax.random.PRNGKey(1)
        )
        assert np.isfinite(float(metrics["loss"]))
        for k in ("loss_cls", "loss_bbox", "accuracy_cls"):
            assert np.isfinite(float(metrics[k]))
        assert any(
            k.startswith("loss_rpn_cls_fpn") for k in metrics
        )
        moved = jax.tree_util.tree_reduce(
            lambda acc, x: acc or bool(np.any(x)),
            jax.tree_util.tree_map(
                lambda a, b2: np.asarray(a) != np.asarray(b2),
                params, new_state.params,
            ),
            False,
        )
        assert moved


class TestRCNNMeshStep:
    def test_step_over_8_device_mesh(self, tiny_rcnn):
        """The R-CNN step jits and runs over the 8-device data mesh with
        n_groups=8 (one image per group) — the multi-chip configuration
        train_loop builds (n_groups=NUM_GPUS, batch sharded on 'data')."""
        from sad_tpu.data.rpn_minibatch import add_rpn_blobs_to_batch
        from sad_tpu.parallel import create_mesh
        from sad_tpu.parallel.mesh import (
            replicated_sharding,
            shard_batch_tree,
        )
        from sad_tpu.train import TrainState, init_momentum_state
        from sad_tpu.train.rcnn_train import make_rcnn_train_step

        cfg, model, params = tiny_rcnn
        rng = np.random.RandomState(3)
        b, h, w = 8, 64, 64
        batch = {
            "data": rng.randn(b, h, w, 3).astype(np.float32),
            "im_hw": np.tile(np.float32([64, 64]), (b, 1)),
        }
        entries = [
            {
                "boxes": np.asarray(
                    [[8, 8, 40, 40], [20, 20, 60, 56]], np.float32
                ),
                "gt_classes": np.asarray([1, 3], np.int32),
                "is_crowd": np.zeros(2, bool),
            }
            for _ in range(b)
        ]
        add_rpn_blobs_to_batch(cfg, batch, entries, (h, w), np.ones(b), seed=3)
        batch = jax.tree_util.tree_map(jnp.asarray, batch)

        mesh = create_mesh()
        assert mesh.devices.size == 8
        batch_sh = shard_batch_tree(batch, mesh)
        rep = replicated_sharding(mesh)
        params_r = jax.device_put(params, rep)
        state = TrainState(
            params_r,
            jax.device_put(init_momentum_state(params_r).velocity, rep),
        )
        step = jax.jit(make_rcnn_train_step(cfg, model, n_groups=8))
        new_state, metrics = step(
            state, batch_sh, jnp.float32(1e-4), jax.random.PRNGKey(4)
        )
        assert np.isfinite(float(metrics["loss"]))
        assert np.isfinite(float(metrics["loss_cls"]))


class TestRCNNInference:
    def test_decode_shapes_and_masks(self, tiny_rcnn):
        cfg, model, params = tiny_rcnn
        from sad_tpu.eval.rcnn_inference import make_rcnn_inference_fn

        infer = make_rcnn_inference_fn(cfg, model)
        images = jnp.asarray(
            np.random.RandomState(0).randn(2, 64, 64, 3), jnp.float32
        )
        im_hw = jnp.asarray([[64, 64], [60, 50]], jnp.float32)
        scale = jnp.asarray([1.0, 1.0], jnp.float32)
        out = infer(params, images, im_hw, scale)
        k = cfg.TEST.DETECTIONS_PER_IM
        assert out["boxes"].shape == (2, k, 4)
        assert out["scores"].shape == (2, k)
        assert out["mask_prob"].shape[:2] == (2, k)
        assert out["mask_prob"].shape[-1] == cfg.MODEL.NUM_CLASSES
        v = np.asarray(out["valid"])
        b = np.asarray(out["boxes"])
        if v.any():
            assert (b[v][:, 2] <= 63.0 + 1e-5).all()


class TestAuxRoiSlotCaps:
    """MRCNN/KRCNN.ROI_SLOTS_PER_IM (static-shape extension): the aux-branch
    slot count. knob == box fg cap must be bit-identical to the default
    (-1); a smaller cap must still produce a finite, trainable step."""

    def _mask_kp_setup(self, knob_m, knob_k):
        import dataclasses as dc

        from sad_tpu.models import create_model

        cfg = _tiny(rcnn_cfg(mask=True))
        cfg = dc.replace(
            cfg,
            MODEL=dc.replace(cfg.MODEL, KEYPOINTS_ON=True),
            TRAIN=dc.replace(
                cfg.TRAIN, RPN_PRE_NMS_TOP_N=40, RPN_POST_NMS_TOP_N=16,
                BATCH_SIZE_PER_IM=8, IMS_PER_BATCH=2,
            ),
            MRCNN=dc.replace(cfg.MRCNN, ROI_SLOTS_PER_IM=knob_m),
            KRCNN=dc.replace(cfg.KRCNN, ROI_SLOTS_PER_IM=knob_k,
                             NUM_KEYPOINTS=5,
                             ROI_XFORM_RESOLUTION=7, UP_SCALE=2),
        )
        model = create_model(cfg)
        images = jnp.zeros((2, 64, 64, 3), jnp.float32)
        im_hw = jnp.asarray([[64, 64], [64, 64]], jnp.float32)
        params = model.init(
            jax.random.PRNGKey(0), images, im_hw, method="init_all"
        )["params"]
        batch = dict(_rcnn_batch(cfg))
        rng = np.random.RandomState(3)
        batch["gt_mask_rasters"] = jnp.asarray(
            (rng.rand(2, 2, 8, 8) > 0.5).astype(np.float32)
        )
        batch["gt_mask_stride"] = jnp.float32(8.0)
        kp = np.zeros((2, 2, 5, 3), np.float32)
        kp[..., 0] = rng.uniform(10, 55, (2, 2, 5))
        kp[..., 1] = rng.uniform(10, 50, (2, 2, 5))
        kp[..., 2] = 2.0
        batch["gt_keypoints"] = jnp.asarray(kp)
        return cfg, model, params, batch

    def _run(self, knob_m, knob_k):
        from sad_tpu.train import TrainState, init_momentum_state
        from sad_tpu.train.rcnn_train import make_rcnn_train_step

        cfg, model, params, batch = self._mask_kp_setup(knob_m, knob_k)
        step = jax.jit(make_rcnn_train_step(cfg, model, n_groups=1))
        state = TrainState(params, init_momentum_state(params).velocity)
        _, metrics = step(state, batch, jnp.float32(1e-4),
                          jax.random.PRNGKey(1))
        return {k: float(v) for k, v in metrics.items()}

    def test_knob_at_fg_cap_is_identity(self):
        from sad_tpu.ops.proposals import sampled_fg_cap

        cap = sampled_fg_cap(8, 0.25)
        base = self._run(-1, -1)
        same = self._run(cap, cap)
        assert base.keys() == same.keys()
        for k in base:
            np.testing.assert_equal(base[k], same[k])

    def test_smaller_cap_trains_finite(self):
        m = self._run(1, 1)
        assert np.isfinite(m["loss"])
        assert np.isfinite(m["loss_mask"]) and np.isfinite(m["loss_kps"])
