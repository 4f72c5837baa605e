"""Time the hand-written GPU kernel and the top-k forms against XLA's plain
versions, on one GPU, at the shapes the main path uses.

    python tools_drives/kernel_forms_drive.py [--out kernel_forms.json]

- Greedy NMS at decode scale (16 images x 5000 class-offset candidates,
  100 picks, IoU 0.5) and at RPN scale (2 x 12000 candidates, 2000 picks,
  IoU 0.7), in three forms: nms_fixed (a fori_loop of one-vs-all IoU
  steps), an IoU-matrix form (the K x K suppression mask computed once,
  then the same greedy loop reading rows of it), and the Pallas kernel.
- Exact top-k over the P3 score grid at 640x1024 (80*128*9*80 scores per
  image, k=1000): lax.top_k against approx_max_k at recall 1.0 and 0.99.
- End to end in the pseudo-label phase: one jitted R-101 teacher inference
  step (forward, decode, NMS) over 16 images at 640x1024, with the kernel
  and with nms_fixed, in turns (kernel, plain, plain, kernel).

Times are medians of host-clock windows that end in block_until_ready,
after a compiling warm-up call; the card's name and power limit are
printed beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def timed(fn, *args, reps: int):
    import jax

    jax.block_until_ready(fn(*args))  # compile + warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3, float(np.min(ts)) * 1e3


def nms_iou_matrix(boxes, scores, thr, max_out):
    """Greedy NMS reading a precomputed IoU>thr mask (one problem)."""
    import jax
    import jax.numpy as jnp

    from sad_tpu.ops.nms import NEG_INF

    b = boxes.astype(jnp.float32)
    areas = (b[:, 2] - b[:, 0] + 1.0) * (b[:, 3] - b[:, 1] + 1.0)
    iw = jnp.maximum(jnp.minimum(b[:, None, 2], b[None, :, 2])
                     - jnp.maximum(b[:, None, 0], b[None, :, 0]) + 1.0, 0.0)
    ih = jnp.maximum(jnp.minimum(b[:, None, 3], b[None, :, 3])
                     - jnp.maximum(b[:, None, 1], b[None, :, 1]) + 1.0, 0.0)
    inter = iw * ih
    mask = inter / (areas[:, None] + areas[None, :] - inter) > thr
    k = b.shape[0]

    def body(i, st):
        live, idx, val = st
        pick = jnp.argmax(live)
        ok = live[pick] > NEG_INF
        kill = ok & (mask[pick] | (jnp.arange(k) == pick))
        live = jnp.where(kill, NEG_INF, live)
        return (live, idx.at[i].set(jnp.where(ok, pick, 0)), val.at[i].set(ok))

    init = (scores.astype(jnp.float32), jnp.zeros((max_out,), jnp.int32),
            jnp.zeros((max_out,), bool))
    _, idx, val = jax.lax.fori_loop(0, max_out, body, init)
    return idx, val


def nms_forms(n, k, max_out, thr, seed, reps):
    import jax
    import jax.numpy as jnp

    from sad_tpu.ops.nms import greedy_nms, nms_fixed

    boxes, scores = chip_smoke.nms_problems(seed, n, k)
    bj, sj = jnp.asarray(boxes), jnp.asarray(scores)
    forms = {
        "nms_fixed": jax.jit(jax.vmap(
            lambda b, s: nms_fixed(b, s, thr, max_out))),
        "iou_matrix": jax.jit(jax.vmap(
            lambda b, s: nms_iou_matrix(b, s, thr, max_out))),
        "pallas_kernel": jax.jit(lambda b, s: greedy_nms(b, s, thr, max_out)),
    }
    out = {}
    ref = None
    for name, fn in forms.items():
        med, best = timed(fn, bj, sj, reps=reps)
        idx, val = (np.asarray(x) for x in fn(bj, sj))
        same = None
        if ref is None:
            ref = (idx, val)
        else:
            same = int(sum(
                idx[p][val[p]].tolist() == ref[0][p][ref[1][p]].tolist()
                for p in range(n)))
        out[name] = {"median_ms": med, "min_ms": best,
                     "problems_equal_to_nms_fixed": same}
        print(f"nms N={n} K={k} max_out={max_out} {name}: median {med:.4f} ms "
              f"min {best:.4f} ms equal {same}", flush=True)
    return out


def topk_forms(n, reps):
    import jax

    x = jax.random.uniform(jax.random.PRNGKey(0), (n, 80 * 128 * 9 * 80))
    forms = {
        "lax.top_k": lambda r: jax.lax.top_k(r, 1000),
        "approx_max_k_recall_1.0": lambda r: jax.lax.approx_max_k(
            r, 1000, recall_target=1.0),
        "approx_max_k_recall_0.99": lambda r: jax.lax.approx_max_k(
            r, 1000, recall_target=0.99),
    }
    out = {}
    for name, f in forms.items():
        # vmapped, as decode runs it per image
        med, best = timed(jax.jit(jax.vmap(f)), x, reps=reps)
        out[name] = {"median_ms": med, "min_ms": best}
        print(f"topk N={n} {name}: median {med:.4f} ms min {best:.4f} ms",
              flush=True)
    return out


def pseudo_label_step(reps):
    """R-101 teacher inference (forward + decode + NMS), kernel vs plain."""
    import jax
    import jax.numpy as jnp

    from sad_tpu.config import load_cfg
    from sad_tpu.eval.inference import make_inference_fn
    from sad_tpu.models import create_model
    from sad_tpu.models.model_builder import init_model_params
    from sad_tpu.ops import nms

    cfg = load_cfg(chip_smoke.TEACHER_YAML,
                   chip_smoke.INIT_OPTS + ["TEST.SCORE_THRESH", "0.0"])
    model = create_model(cfg)
    params = init_model_params(model, jax.random.PRNGKey(0), (1, 640, 1024, 3))
    rng = np.random.RandomState(0)
    images = jnp.asarray(rng.randint(0, 255, (16, 640, 1024, 3)).astype(np.uint8))
    hw = jnp.asarray(np.tile(np.float32([600, 1000]), (16, 1)))
    scale = jnp.ones((16,), jnp.float32)
    fns = {"pallas_kernel": make_inference_fn(cfg, model)}
    orig = nms.uses_kernel
    nms.uses_kernel = lambda k: False
    try:
        fns["nms_fixed"] = make_inference_fn(cfg, model)
        jax.block_until_ready(fns["nms_fixed"](params, images, hw, scale, hw))
    finally:
        nms.uses_kernel = orig
    out = {name: [] for name in fns}
    for name in ("pallas_kernel", "nms_fixed", "nms_fixed", "pallas_kernel"):
        med, best = timed(fns[name], params, images, hw, scale, hw, reps=reps)
        out[name].append(med)
        print(f"pseudo-label step (16 x 640x1024, R-101) {name}: median "
              f"{med:.3f} ms min {best:.3f} ms", flush=True)
    a = fns["pallas_kernel"](params, images, hw, scale, hw)
    b = fns["nms_fixed"](params, images, hw, scale, hw)
    same = bool(np.array_equal(np.asarray(a["valid"]), np.asarray(b["valid"])))
    print(f"pseudo-label step: kernel and nms_fixed valid masks equal: {same}")
    out["valid_equal"] = same
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default="kernel_forms.json")
    args = p.parse_args()
    devices = chip_smoke.require_gpu(1)
    from sad_tpu.utils.env import enable_compile_cache

    enable_compile_cache()
    card = chip_smoke.card_info()
    print(f"card: {card}; device {devices[0].device_kind}", flush=True)
    res = {
        "card": card,
        "device_kind": devices[0].device_kind,
        "nms_decode": nms_forms(16, 5000, 100, 0.5, 0, reps=20),
        "nms_rpn": nms_forms(2, 12000, 2000, 0.7, 1, reps=5),
        "topk_1": topk_forms(1, reps=20),
        "topk_8": topk_forms(8, reps=10),
        "pseudo_label_step": pseudo_label_step(reps=5),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"card: {card}", flush=True)


if __name__ == "__main__":
    main()
