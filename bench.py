"""Benchmark: joint teacher+student SAD training step throughput on a GPU.

Measures the flagship workload — R-50 student distilled from R-101 teacher
(configs/), input canvas 640x1024 (TRAIN.SCALES=600 / MAX_SIZE=1000 padded
to COARSEST_STRIDE=128, the reference's distillation config geometry) — and
prints ONE JSON line naming the device. Refuses to run without a GPU.

Baseline: the reference's plain (non-distill) RetinaNet R-50 1x trains at
16 imgs / 0.483 s = 33.1 imgs/s on 8x P100 => 4.14 imgs/s per GPU
(detectron/MODEL_ZOO.md:889-897). The distillation step is strictly heavier
(adds a frozen R-101 forward). vs_baseline = imgs/s per device / 4.14.
"""

from __future__ import annotations

import json
import time

import numpy as np


def main():
    import sys

    import jax
    import jax.numpy as jnp

    import chip_smoke
    from sad_tpu.config import load_cfg
    from sad_tpu.models import create_model
    from sad_tpu.models.model_builder import init_model_params
    from sad_tpu.train import TrainState, init_momentum_state, make_train_step

    # extra KEY VALUE override pairs apply to BOTH configs (experiment
    # sweeps, e.g. `python bench.py S2D_STEM True`); default run unchanged
    extra = sys.argv[1:]
    devices = chip_smoke.require_gpu(1)
    from sad_tpu.utils.env import enable_compile_cache

    enable_compile_cache()
    # random-init + std~60 mean-only-normalized inputs diverge; unit scale
    # (chip_smoke.INIT_OPTS) keeps every timed iteration finite
    opts = ["NUM_GPUS", "8", "COMPUTE_DTYPE", "bfloat16"] + chip_smoke.INIT_OPTS
    student_cfg = load_cfg(chip_smoke.STUDENT_YAML, opts + extra)
    teacher_cfg = load_cfg(chip_smoke.TEACHER_YAML, opts + extra)

    h, w = 640, 1024
    # 16 groups of TRAIN.IMS_PER_BATCH=2 images on one device, with
    # identical per-group loss math (batch size not yet swept on the GPU)
    n_groups = 16
    n_images = student_cfg.TRAIN.IMS_PER_BATCH * n_groups

    student = create_model(student_cfg)
    teacher = create_model(teacher_cfg)
    sp = init_model_params(student, jax.random.PRNGKey(0), (1, h, w, 3))
    tp = init_model_params(teacher, jax.random.PRNGKey(1), (1, h, w, 3))

    rng = np.random.RandomState(0)
    a = student_cfg.num_anchors_per_cell()
    # the shipped training input path: ONE raw uint8 canvas per image,
    # student+teacher normalization applied on device
    batch = {
        "data_u8": jnp.asarray(
            rng.randint(90, 150, (n_images, h, w, 3)).astype(np.uint8)),
        "content_hw": jnp.asarray(
            np.tile(np.float32([600.0, 1000.0]), (n_images, 1))),
        "labels": {},
        "bbox_targets": {},
        "fg_mask": {},
        "fg_num": jnp.asarray([24.0] * n_groups, jnp.float32),
    }
    for lvl in student_cfg.fpn_levels():
        s = 2 ** lvl
        hl, wl = h // s, w // s
        batch["labels"][lvl] = jnp.asarray(
            rng.randint(-1, 81, (n_images, hl, wl, a)), jnp.int32
        )
        batch["bbox_targets"][lvl] = jnp.asarray(
            rng.randn(n_images, hl, wl, a, 4), jnp.float32
        )
        batch["fg_mask"][lvl] = jnp.asarray(
            rng.uniform(size=(n_images, hl, wl, a)) < 0.002
        )

    step = jax.jit(
        make_train_step(student_cfg, student, teacher, n_groups=n_groups,
                        teacher_cfg=teacher_cfg),
        donate_argnums=(0,),
    )
    state = TrainState(sp, init_momentum_state(sp).velocity)

    # Tiny LR: random-init + LR 0.01 diverges to NaN within a few steps, and
    # a NaN parameter state would time a degenerate step. With finite,
    # evolving params every iteration is real work.
    lr = jnp.float32(1e-6)

    # warmup / compile
    state, metrics = step(state, tp, batch, lr)
    jax.block_until_ready(metrics["loss"])
    assert np.isfinite(float(metrics["loss"])), "bench step produced NaN"

    for _ in range(3):  # warm-up past the compiling call
        state, metrics = step(state, tp, batch, lr)
    jax.block_until_ready(metrics["loss"])

    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step(state, tp, batch, lr)
    jax.block_until_ready(metrics["loss"])
    dt = time.perf_counter() - t0
    assert np.isfinite(float(metrics["loss"])), "bench step produced NaN"

    imgs_per_sec = n_images * iters / dt
    baseline = 33.1 / 8.0  # reference plain R-50 per-GPU imgs/s
    print(
        json.dumps(
            {
                "metric": "joint_distill_train_imgs_per_sec_per_device",
                "value": imgs_per_sec,
                "unit": "imgs/s/device (R50<-R101 SAD step, 640x1024, bs32)",
                "vs_baseline": imgs_per_sec / baseline,
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                },
                "card": chip_smoke.card_info(),
            }
        )
    )


if __name__ == "__main__":
    main()
