"""Model construction, parameter-role masks, checkpoint round-trip, optimizer
semantics, LR policy, and a full joint distillation train step on a tiny arch
over the virtual 8-device CPU mesh."""

import dataclasses

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sad_tpu.config import Config, load_cfg
from sad_tpu.config.config import merge_cfg_from_dict
from sad_tpu.models import RetinaNet, ModelArch, trainable_mask, bias_mask
from sad_tpu.models.model_builder import init_model_params
from sad_tpu.train import (
    TrainState,
    get_lr_at_iter,
    init_momentum_state,
    lr_change_correction,
    make_train_step,
    momentum_sgd_update,
    MomentumSGDState,
)
from sad_tpu.train.checkpoint import (
    flax_to_reference_blobs,
    reference_blobs_to_flax,
)


def tiny_arch(**kw) -> ModelArch:
    base = dict(
        depth=50,
        block_counts=(1, 1, 1, 1),
        num_groups=1,
        width_per_group=8,
        stride_1x1=True,
        channel_ratio=1.0,
        res5_dilation=1,
        freeze_at=2,
        fpn_dim=16,
        zero_init_lateral=False,
        min_level=3,
        max_level=7,
        extra_conv_levels=True,
        num_classes=5,
        aspect_ratios=(1.0, 2.0),
        scales_per_octave=1,
        anchor_scale=4.0,
        num_convs=1,
        prior_prob=0.01,
        share_cls_bbox_tower=False,
        class_specific_bbox=False,
        softmax=False,
        compute_dtype="float32",
    )
    base.update(kw)
    return ModelArch(**base)


def tiny_cfg(n_groups=2) -> Config:
    cfg = Config()
    return merge_cfg_from_dict(
        cfg,
        {
            "MODEL": {"TYPE": "distillation", "NUM_CLASSES": 5},
            "NUM_GPUS": n_groups,
            "FPN": {
                "FPN_ON": True,
                "RPN_MIN_LEVEL": 3,
                "RPN_MAX_LEVEL": 7,
                "EXTRA_CONV_LEVELS": True,
                "COARSEST_STRIDE": 128,
            },
            "RETINANET": {
                "RETINANET_ON": True,
                "ASPECT_RATIOS": (1.0, 2.0),
                "SCALES_PER_OCTAVE": 1,
                "LOSS_GAMMA": 2.0,
                "LOSS_ALPHA": 0.25,
            },
            "DISTILLATION": {
                "DISTILLATION_ON": True,
                "LOSS_ALPHA": 0.5,
                "LOSS_GAMMA": 2.0,
                "ADAPTIVE_NORMALIZER": True,
                "LOGITS_POWER": 1.8,
                "TEMPERATURE": 1.0,
            },
            "SOLVER": {"BASE_LR": 0.01, "MOMENTUM": 0.9, "WEIGHT_DECAY": 0.0001},
        },
    )


@pytest.fixture(scope="module")
def tiny_model_and_params():
    arch = tiny_arch()
    model = RetinaNet(arch)
    params = init_model_params(model, jax.random.PRNGKey(0), (1, 128, 128, 3))
    return arch, model, params


class TestModel:
    def test_output_shapes(self, tiny_model_and_params):
        arch, model, params = tiny_model_and_params
        out = model.apply({"params": params}, jnp.zeros((2, 128, 128, 3)))
        a, k = arch.num_anchors, arch.cls_pred_dim
        for i, lvl in enumerate(arch.levels):
            s = 2 ** lvl
            assert out["cls_logits"][lvl].shape == (2, 128 // s, 128 // s, a * k)
            assert out["bbox_pred"][lvl].shape == (2, 128 // s, 128 // s, a * 4)
            assert out["cls_prob"][lvl].dtype == jnp.float32

    def test_prior_prob_bias_init(self, tiny_model_and_params):
        arch, model, params = tiny_model_and_params
        out = model.apply({"params": params}, jnp.zeros((1, 128, 128, 3)))
        # with prior-prob bias init, initial probs should be near PRIOR_PROB
        p = np.asarray(out["cls_prob"][7])
        assert 0.001 < p.mean() < 0.05

    def test_trainable_mask_freezes_affine_and_stage(self, tiny_model_and_params):
        arch, model, params = tiny_model_and_params
        mask = trainable_mask(params, freeze_at=2)
        flat = jax.tree_util.tree_flatten_with_path(mask)[0]
        frozen = {
            "/".join(str(getattr(p, "key", p)) for p in path)
            for path, v in flat
            if not v
        }
        # all AffineChannel params frozen
        assert any("res_conv1_bn" in f for f in frozen)
        assert all(
            ("_bn" in f) or ("conv1" in f) or ("res2_" in f) for f in frozen
        )
        # conv1 and res2 convs frozen; res3+ convs trainable
        assert any("conv1/kernel" in f for f in frozen)
        assert any("res2_0_branch2a/kernel" in f for f in frozen)
        assert not any("res3_0_branch2a/kernel" in f for f in frozen)
        assert not any("retnet_cls_pred" in f for f in frozen)

    def test_bias_mask(self, tiny_model_and_params):
        arch, model, params = tiny_model_and_params
        mask = bias_mask(params)
        flat = jax.tree_util.tree_flatten_with_path(mask)[0]
        for path, v in flat:
            names = [str(getattr(p, "key", p)) for p in path]
            assert v == (names[-1] == "bias")

    def test_checkpoint_roundtrip(self, tiny_model_and_params):
        arch, model, params = tiny_model_and_params
        blobs = flax_to_reference_blobs(params)
        assert "conv1_w" in blobs
        assert blobs["conv1_w"].shape == (64, 3, 7, 7)  # OIHW
        assert "res_conv1_bn_s" in blobs
        assert "retnet_cls_pred_fpn3_w" in blobs
        assert "fpn_6_w" in blobs and "fpn_7_b" in blobs
        zeros = jax.tree_util.tree_map(np.zeros_like, params)
        restored, loaded, skipped = reference_blobs_to_flax(blobs, zeros, strict=True)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
            params,
            restored,
        )


class TestOptimizer:
    def test_caffe2_momentum_semantics(self):
        # hand-computed: V := mu*V + lr*(g + wd*w); w -= V
        params = {"w": jnp.array([1.0, 2.0]), "bias": jnp.array([0.5])}
        grads = {"w": jnp.array([0.1, -0.2]), "bias": jnp.array([0.3])}
        state = init_momentum_state(params)
        trainable = {"w": True, "bias": True}
        is_bias = {"w": False, "bias": True}
        lr, mu, wd = 0.1, 0.9, 0.01

        p1, s1 = momentum_sgd_update(
            params, grads, state, jnp.float32(lr),
            momentum=mu, weight_decay=wd, trainable=trainable, is_bias=is_bias,
        )
        v_w = lr * (np.array([0.1, -0.2]) + wd * np.array([1.0, 2.0]))
        v_b = lr * 2.0 * np.array([0.3])  # bias: 2x LR, no WD
        np.testing.assert_allclose(p1["w"], np.array([1.0, 2.0]) - v_w, rtol=1e-6)
        np.testing.assert_allclose(p1["bias"], np.array([0.5]) - v_b, rtol=1e-6)

        # second step accumulates momentum
        p2, s2 = momentum_sgd_update(
            p1, grads, s1, jnp.float32(lr),
            momentum=mu, weight_decay=wd, trainable=trainable, is_bias=is_bias,
        )
        v_w2 = mu * v_w + lr * (np.array([0.1, -0.2]) + wd * np.asarray(p1["w"]))
        np.testing.assert_allclose(p2["w"], np.asarray(p1["w"]) - v_w2, rtol=1e-6)

    def test_frozen_params_untouched(self):
        params = {"a": jnp.array([1.0]), "b": jnp.array([2.0])}
        grads = {"a": jnp.array([5.0]), "b": jnp.array([5.0])}
        state = init_momentum_state(params)
        p1, _ = momentum_sgd_update(
            params, grads, state, jnp.float32(0.1),
            momentum=0.9, weight_decay=0.0,
            trainable={"a": True, "b": False}, is_bias={"a": False, "b": False},
        )
        assert float(p1["b"][0]) == 2.0
        assert float(p1["a"][0]) != 1.0


class TestLRPolicy:
    def test_steps_with_decay_and_warmup(self):
        cfg = load_cfg(
            os.path.join(
                os.path.dirname(__file__), "..", "configs",
                "retinanet_R-50-FPN_distillation.yaml",
            )
        )
        s = cfg.SOLVER
        # warmup: linear from BASE_LR/3 to BASE_LR over 1000 iters
        assert abs(get_lr_at_iter(s, 0) - 0.01 / 3.0) < 1e-6
        assert abs(get_lr_at_iter(s, 1000) - 0.01) < 1e-7
        assert abs(get_lr_at_iter(s, 100000) - 0.01) < 1e-7
        assert abs(get_lr_at_iter(s, 180000) - 0.001) < 1e-8
        assert abs(get_lr_at_iter(s, 240000) - 0.0001) < 1e-9
        # at/past MAX_ITER the reference's get_step_index falls through to
        # the last enumerate value -> same LR as the final step region
        assert abs(get_lr_at_iter(s, s.MAX_ITER) - 0.0001) < 1e-9
        assert abs(get_lr_at_iter(s, s.MAX_ITER + 5) - 0.0001) < 1e-9

    def test_momentum_correction_trigger(self):
        cfg = load_cfg(
            os.path.join(
                os.path.dirname(__file__), "..", "configs",
                "retinanet_R-50-FPN_distillation.yaml",
            )
        )
        s = cfg.SOLVER
        # decay step: ratio 10 > 1.1 -> correction 0.1
        corr = lr_change_correction(s, 0.01, 0.001)
        assert corr is not None and abs(corr - 0.1) < 1e-9
        # small warmup change: no correction
        assert lr_change_correction(s, 0.00334, 0.00335) is None


class TestJointTrainStep:
    def test_distillation_step_runs_and_updates(self):
        cfg = tiny_cfg(n_groups=2)
        s_arch = tiny_arch()
        t_arch = tiny_arch(block_counts=(1, 1, 2, 1))  # "bigger" teacher
        student = RetinaNet(s_arch)
        teacher = RetinaNet(t_arch)
        H = W = 128
        B, G = 4, 2
        sp = init_model_params(student, jax.random.PRNGKey(0), (1, H, W, 3))
        tp = init_model_params(teacher, jax.random.PRNGKey(1), (1, H, W, 3))

        rng = np.random.RandomState(0)
        a = s_arch.num_anchors
        batch = {
            "data": jnp.asarray(rng.randn(B, H, W, 3), jnp.float32),
            "teacher_data": jnp.asarray(rng.randn(B, H, W, 3), jnp.float32),
            "labels": {},
            "bbox_targets": {},
            "fg_mask": {},
            "fg_num": jnp.asarray([3.0, 5.0], jnp.float32),
        }
        for lvl in cfg.fpn_levels():
            s = 2 ** lvl
            h, w = H // s, W // s
            batch["labels"][lvl] = jnp.asarray(
                rng.randint(-1, 5, (B, h, w, a)), jnp.int32
            )
            batch["bbox_targets"][lvl] = jnp.asarray(
                rng.randn(B, h, w, a, 4), jnp.float32
            )
            batch["fg_mask"][lvl] = jnp.asarray(
                rng.uniform(size=(B, h, w, a)) < 0.05
            )

        step = jax.jit(make_train_step(cfg, student, teacher, n_groups=G))
        state = TrainState(sp, init_momentum_state(sp).velocity)
        new_state, metrics = step(state, tp, batch, jnp.float32(0.01))

        assert np.isfinite(float(metrics["loss"]))
        assert float(metrics["distill_normalizer"]) > 0
        for lvl in cfg.fpn_levels():
            assert np.isfinite(float(metrics[f"fl_fpn{lvl}"]))
            assert np.isfinite(float(metrics[f"fl_distill_fpn{lvl}"]))

        # trainable params moved, frozen ones did not
        t_mask = trainable_mask(sp, cfg.TRAIN.FREEZE_AT)
        moved = jax.tree_util.tree_map(
            lambda old, new: bool(np.any(np.asarray(old) != np.asarray(new))),
            sp,
            new_state.params,
        )
        flat_m = jax.tree_util.tree_flatten_with_path(moved)[0]
        flat_t = jax.tree_util.tree_leaves(t_mask)
        for (path, did_move), is_trainable in zip(flat_m, flat_t):
            if not is_trainable:
                assert not did_move, f"frozen param moved: {path}"
        assert any(m for (_, m) in flat_m)

    def test_step_over_8_device_mesh(self):
        from sad_tpu.parallel import create_mesh
        from sad_tpu.parallel.mesh import shard_batch_tree, replicated_sharding

        cfg = tiny_cfg(n_groups=8)
        arch = tiny_arch()
        student = RetinaNet(arch)
        teacher = RetinaNet(arch)
        H = W = 128
        B, G = 8, 8
        sp = init_model_params(student, jax.random.PRNGKey(0), (1, H, W, 3))
        tp = init_model_params(teacher, jax.random.PRNGKey(1), (1, H, W, 3))

        rng = np.random.RandomState(0)
        a = arch.num_anchors
        batch = {
            "data": jnp.asarray(rng.randn(B, H, W, 3), jnp.float32),
            "teacher_data": jnp.asarray(rng.randn(B, H, W, 3), jnp.float32),
            "labels": {},
            "bbox_targets": {},
            "fg_mask": {},
            "fg_num": jnp.asarray(rng.uniform(1, 9, (G,)), jnp.float32),
        }
        for lvl in cfg.fpn_levels():
            s = 2 ** lvl
            h, w = H // s, W // s
            batch["labels"][lvl] = jnp.asarray(
                rng.randint(-1, 5, (B, h, w, a)), jnp.int32
            )
            batch["bbox_targets"][lvl] = jnp.asarray(
                rng.randn(B, h, w, a, 4), jnp.float32
            )
            batch["fg_mask"][lvl] = jnp.asarray(
                rng.uniform(size=(B, h, w, a)) < 0.05
            )

        mesh = create_mesh()
        assert mesh.devices.size == 8
        batch_sh = shard_batch_tree(batch, mesh)
        rep = replicated_sharding(mesh)
        sp_r = jax.device_put(sp, rep)
        tp_r = jax.device_put(tp, rep)
        state = TrainState(sp_r, jax.device_put(init_momentum_state(sp_r).velocity, rep))

        step = jax.jit(make_train_step(cfg, student, teacher, n_groups=G))
        new_state, metrics = step(state, tp_r, batch_sh, jnp.float32(0.01))
        assert np.isfinite(float(metrics["loss"]))

    def test_shard_batch_tree_rejects_misshaped_batch(self):
        from sad_tpu.parallel import create_mesh
        from sad_tpu.parallel.mesh import shard_batch_tree

        mesh = create_mesh()
        # rank>=2 with non-divisible leading dim: a misshaped batch
        with pytest.raises(ValueError, match="cannot be data-sharded"):
            shard_batch_tree({"data": jnp.zeros((3, 4, 4, 3))}, mesh)
        # 1-D non-divisible (per-group fg_num) still replicates fine
        out = shard_batch_tree({"fg_num": jnp.ones((3,))}, mesh)
        assert out["fg_num"].shape == (3,)


class TestFusedOptimizer:
    def test_fused_matches_per_leaf(self):
        from sad_tpu.train.optimizer import (
            MomentumSGDState,
            fused_momentum_sgd_update,
            momentum_sgd_update,
        )

        rng = np.random.RandomState(0)
        params = {
            "w": jnp.asarray(rng.randn(4, 3), jnp.float32),
            "bias": jnp.asarray(rng.randn(3), jnp.float32),
            "frozen": jnp.asarray(rng.randn(2, 2), jnp.float32),
        }
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape), jnp.float32), params
        )
        vel = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape) * 0.1, jnp.float32), params
        )
        trainable = {"w": True, "bias": True, "frozen": False}
        is_bias = {"w": False, "bias": True, "frozen": False}
        kw = dict(momentum=0.9, weight_decay=1e-4, trainable=trainable,
                  is_bias=is_bias)
        # per-leaf reference: frozen velocity untouched; fused zeroes frozen
        # velocity — zero it in the input so both paths agree (real training
        # always starts frozen velocity at zero)
        vel = dict(vel, frozen=jnp.zeros_like(vel["frozen"]))
        p1, s1 = momentum_sgd_update(
            params, grads, MomentumSGDState(vel), jnp.float32(0.02), **kw
        )
        p2, s2 = fused_momentum_sgd_update(
            params, grads, MomentumSGDState(vel), jnp.float32(0.02), **kw
        )
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7
            ),
            (p1, s1.velocity), (p2, s2.velocity),
        )


class TestSpatialSharding:
    def test_height_sharded_conv_matches_replicated(self):
        """'model'-axis spatial sharding (SURVEY §5.7): XLA partitions the
        convs with halo exchange; results match a replicated run."""
        import numpy as onp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from sad_tpu.models import RetinaNet
        from sad_tpu.parallel import create_mesh
        from sad_tpu.parallel.mesh import replicated_sharding, spatial_sharding

        mesh = create_mesh(n_data=2, n_model=4)
        model = RetinaNet(tiny_arch())
        x = jnp.asarray(
            onp.random.RandomState(0).randn(2, 128, 128, 3), jnp.float32
        )
        params = model.init(jax.random.PRNGKey(0), x)["params"]
        params = jax.device_put(params, replicated_sharding(mesh))
        fwd = jax.jit(lambda p, im: model.apply({"params": p}, im))
        out = fwd(params, jax.device_put(x, spatial_sharding(mesh)))
        ref = fwd(params, jax.device_put(x, replicated_sharding(mesh)))
        for lvl in out["cls_logits"]:
            onp.testing.assert_allclose(
                onp.asarray(out["cls_logits"][lvl]),
                onp.asarray(ref["cls_logits"][lvl]),
                atol=2e-5,
            )
