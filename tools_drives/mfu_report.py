"""Model FLOPs of a train step, counted from its jaxpr.

    python tools_drives/mfu_report.py   # runs on the CPU, no GPU needed

FLOPs are counted by walking the step function's jaxpr and summing
`conv_general_dilated` and `dot_general` contractions; elementwise work is
excluded by convention, so the number is the standard "model flops"
accounting. Backward-pass convs appear in the jaxpr (the step traces
through jax.grad), so no 3x heuristics are involved. `scan` bodies are
multiplied by length; `pjit`/`custom_vjp`/`remat` calls are recursed into.
Pallas kernels are opaque to the walk.

Model FLOP/s utilization is these FLOPs over a measured step time and the
device's peak; both come from a GPU run, not from this script.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CONFIGS = os.path.join(REPO, "configs")


# ------------------------------------------------------------------ jaxpr walk
def _conv_flops(eqn) -> float:
    out = eqn.outvars[0].aval.shape
    rhs = eqn.invars[1].aval.shape
    dn = eqn.params["dimension_numbers"]
    # rhs spec: I is the per-group input-feature dim, so depth per output
    # element = KH * KW * I regardless of feature/batch group counts.
    rhs_spec = dn.rhs_spec  # (out_feat, in_feat, *spatial) positions
    k_spatial = [rhs[i] for j, i in enumerate(rhs_spec) if j >= 2]
    depth = rhs[rhs_spec[1]] * int(np.prod(k_spatial or [1]))
    return 2.0 * float(np.prod(out)) * depth


def _dot_flops(eqn) -> float:
    out = eqn.outvars[0].aval.shape
    lhs = eqn.invars[0].aval.shape
    (lc, _), _ = eqn.params["dimension_numbers"]
    depth = int(np.prod([lhs[i] for i in lc] or [1]))
    return 2.0 * float(np.prod(out)) * depth


def flops_of_jaxpr(jaxpr, mult: float = 1.0) -> float:
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "conv_general_dilated":
            total += mult * _conv_flops(eqn)
        elif name == "dot_general":
            total += mult * _dot_flops(eqn)
        elif name == "scan":
            length = eqn.params.get("length", 1)
            total += flops_of_jaxpr(eqn.params["jaxpr"].jaxpr,
                                    mult * length)
        elif name == "while":
            # bounded proposal loops only; count one iteration and flag
            total += flops_of_jaxpr(eqn.params["body_jaxpr"].jaxpr, mult)
        else:
            for p in ("jaxpr", "call_jaxpr", "fun_jaxpr"):
                sub = eqn.params.get(p) if hasattr(eqn, "params") else None
                if sub is not None:
                    inner = getattr(sub, "jaxpr", sub)
                    total += flops_of_jaxpr(inner, mult)
                    break
            else:
                if hasattr(eqn, "params"):
                    for v in eqn.params.values():
                        if hasattr(v, "jaxpr"):
                            total += flops_of_jaxpr(
                                getattr(v, "jaxpr", v), mult)
    return total


# ------------------------------------------------------------ workload tracing
def _retinanet_batch(cfg, h, w, n_images, n_groups):
    import jax.numpy as jnp

    a = cfg.num_anchors_per_cell()
    batch = {
        "data_u8": jnp.zeros((n_images, h, w, 3), jnp.uint8),
        "content_hw": jnp.zeros((n_images, 2), jnp.float32),
        "labels": {}, "bbox_targets": {}, "fg_mask": {},
        "fg_num": jnp.ones((n_groups,), jnp.float32),
    }
    for lvl in cfg.fpn_levels():
        s = 2 ** lvl
        hl, wl = h // s, w // s
        batch["labels"][lvl] = jnp.zeros((n_images, hl, wl, a), jnp.int32)
        batch["bbox_targets"][lvl] = jnp.zeros(
            (n_images, hl, wl, a, 4), jnp.float32)
        batch["fg_mask"][lvl] = jnp.zeros((n_images, hl, wl, a), bool)
    return batch


def trace_retinanet(yaml, n_groups, h_w=None, teacher_yaml=None,
                    extra=()):
    import jax
    import jax.numpy as jnp

    from sad_tpu.config import load_cfg
    from sad_tpu.data.minibatch import canvas_shapes
    from sad_tpu.models import create_model
    from sad_tpu.models.model_builder import init_model_params
    from sad_tpu.train import TrainState, init_momentum_state, \
        make_train_step

    base = ["NUM_GPUS", "1", "TRAIN.WEIGHTS", "", "COMPUTE_DTYPE",
            "bfloat16", "PIXEL_STD", "(57.375,57.12,58.395)"] + list(extra)
    cfg = load_cfg(yaml, base)
    tcfg = load_cfg(teacher_yaml, base) if teacher_yaml else None
    (h, w) = h_w or canvas_shapes(cfg)[0]
    n_images = cfg.TRAIN.IMS_PER_BATCH * n_groups
    model = create_model(cfg)
    teacher = create_model(tcfg) if tcfg else None
    params = init_model_params(model, jax.random.PRNGKey(0),
                               (1, 128, 128, 3))
    tp = (init_model_params(teacher, jax.random.PRNGKey(1),
                            (1, 128, 128, 3)) if teacher else None)
    step = make_train_step(cfg, model, teacher, n_groups=n_groups,
                           teacher_cfg=tcfg)
    batch = _retinanet_batch(cfg, h, w, n_images, n_groups)
    state = TrainState(params, init_momentum_state(params).velocity)
    jaxpr = jax.make_jaxpr(step)(state, tp, batch, jnp.float32(1e-6))
    return flops_of_jaxpr(jaxpr.jaxpr), n_images


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # flagship SAD step: 16 images (8 groups x 2) at 640x1024
    flops, n = trace_retinanet(
        os.path.join(CONFIGS, "retinanet_R-50-FPN_distillation.yaml"),
        n_groups=8, h_w=(640, 1024),
        teacher_yaml=os.path.join(CONFIGS, "retinanet_R-101-FPN_1x_teacher.yaml"),
        extra=("NUM_GPUS", "8"))
    print(json.dumps({
        "workload": "SAD step R-50<-R-101, 16 images at 640x1024",
        "tflops_per_step": round(flops / 1e12, 3),
        "gflops_per_img": round(flops / n / 1e9, 1),
    }))


if __name__ == "__main__":
    main()
