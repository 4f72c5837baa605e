"""Smoke run of the main path on one NVIDIA GPU, at full model width.

    python chip_smoke.py            # one GPU: device, kernels, trainer, pseudo-labels
    python chip_smoke.py --four     # four GPUs: the data-parallel SAD step only

The configuration is the flagship one: an R-50-FPN RetinaNet student
distilled from an R-101-FPN teacher (configs/), 80 classes, 256-wide FPN,
scale 600 / max 1000 (canvas 640x1024), bf16 compute, random weights from
--seed. Phases, in order; any failure ends the run with a non-zero code:

1. device: refuses anything but a GPU; prints the card's name and power
   limit (nvidia-smi, in a child that never touches JAX).
2. kernels: each kernel of the path, compiled for the card, against its
   plain reference at real width (greedy NMS, exact top-k, the loss ops),
   plus the teacher forward's TF32-vs-f32 gap for information.
3. trainer: ``tools.train_net`` takes 4 SAD steps (16 images each, with the
   unlabeled stream on) over synthetic COCO splits registered under the
   config's dataset names; losses finite, checkpoint written, re-run is a
   resume no-op.
4. pseudo-labels: ``tools.test_net --pseudo-out`` runs the R-101 teacher
   over 16 synthetic unlabeled images and writes the COCO json.

``--four`` runs one SAD step at the flagship geometry (16 images in 8
groups) on a 4-GPU 'data' mesh and on one GPU, both f32 at the highest
matmul precision, compares loss and updated parameters (rtol 1e-4), then
one bf16 step on the mesh. The times printed are smoke readings, not
benchmarks. The last line of stdout is one JSON object.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(REPO, "configs")
STUDENT_YAML = os.path.join(CONFIGS, "retinanet_R-50-FPN_distillation.yaml")
TEACHER_YAML = os.path.join(CONFIGS, "retinanet_R-101-FPN_1x_teacher.yaml")
# random-init weights on unit-scale inputs keep every step finite
INIT_OPTS = ["PIXEL_STD", "(57.375, 57.12, 58.395)", "TRAIN.WEIGHTS", ""]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """'name, power limit' of each card, from nvidia-smi in a child process
    (it never opens the card through JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def optional_imports() -> dict:
    """Which optional packages import here (information only)."""
    return {m: importlib.util.find_spec(m) is not None
            for m in ("flax", "yaml", "PIL", "cv2", "orbax")}


class CompileLog:
    """XLA backend compiles as JAX's monitoring hooks report them: (wall
    clock start, function name, seconds). They tell compile time apart from
    step time in the smoke readings, and place XLA's own log lines."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.events = []
        jax.monitoring.register_event_time_span_listener(self._record)

    def _record(self, event, start, end, **kwargs):
        if event == self.EVENT:
            self.events.append((start, kwargs.get("fun_name", "?"), end - start))

    def summary(self, since: int = 0, min_s: float = 1.0) -> str:
        """Compiles from event `since` on that took at least `min_s`."""
        slow = [e for e in self.events[since:] if e[2] >= min_s]
        return ", ".join(
            f"{time.strftime('%H:%M:%S', time.localtime(t))} {name} {s:.1f} s"
            for t, name, s in slow
        ) or "none"


def require_gpu(count: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}"
        )
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devices)}")
    return devices


# --------------------------------------------------------------- kernels


def nms_problems(seed: int, n: int, k: int, span=(1024.0, 640.0), classes=80):
    """Clustered candidate boxes with quantized (tied) scores and classes,
    in the decode's class-offset form."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 1, (n, 60, 2)) * np.float32(span)
    which = rng.randint(0, 60, (n, k))
    xy = np.take_along_axis(centers, which[..., None], 1)
    xy = xy + rng.uniform(-12, 12, (n, k, 2))
    wh = rng.uniform(8, 160, (n, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = (rng.randint(1, 200, (n, k)) / 200.0).astype(np.float32)
    cls = rng.randint(0, classes, (n, k))
    offset = (cls * (max(span) + 200.0)).astype(np.float32)[..., None]
    return boxes + offset, scores


def _iou_row(b, i):
    b = b.astype(np.float64)
    areas = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    iw = np.maximum(np.minimum(b[i, 2], b[:, 2]) - np.maximum(b[i, 0], b[:, 0]) + 1, 0)
    ih = np.maximum(np.minimum(b[i, 3], b[:, 3]) - np.maximum(b[i, 1], b[:, 1]) + 1, 0)
    inter = iw * ih
    return inter / (areas[i] + areas - inter)


def near_threshold(boxes, seq_a, seq_b, thr, eps=1e-6) -> int:
    """Count candidates whose IoU with a pick lies within eps of thr, over
    the picks up to and including the first point where two keep sequences
    part (0 when they agree)."""
    n = min(len(seq_a), len(seq_b))
    first = next((i for i in range(n) if seq_a[i] != seq_b[i]), None)
    if first is None and len(seq_a) == len(seq_b):
        return 0
    first = n if first is None else first
    picks = list(seq_a[: first + 1]) + list(seq_b[first: first + 1])
    return int(sum(np.sum(np.abs(_iou_row(boxes, p) - thr) < eps) for p in picks))


def check_nms(n, k, max_out, thr, seed):
    import jax
    import jax.numpy as jnp

    from sad_tpu.ops.nms import greedy_nms, nms_fixed, uses_kernel

    assert uses_kernel(k)
    boxes, scores = nms_problems(seed, n, k)
    bj, sj = jnp.asarray(boxes), jnp.asarray(scores)
    kern = jax.jit(lambda b, s: greedy_nms(b, s, thr, max_out))
    plain = jax.jit(jax.vmap(lambda b, s: nms_fixed(b, s, thr, max_out)))
    ki, kv = (np.asarray(x) for x in kern(bj, sj))
    pi, pv = (np.asarray(x) for x in plain(bj, sj))
    mismatched = explained = 0
    for p in range(n):
        a, b = ki[p][kv[p]].tolist(), pi[p][pv[p]].tolist()
        if a != b:
            mismatched += 1
            near = near_threshold(boxes[p], a, b, thr)
            if not near:
                raise AssertionError(
                    f"NMS kernel and nms_fixed part with no IoU near {thr} "
                    f"(problem {p})"
                )
            explained += near
    log(f"kernel greedy_nms K={k} max_out={max_out} thr={thr} N={n}: "
        f"{mismatched}/{n} keep sequences differ from nms_fixed "
        f"(near-threshold IoUs: {explained}); picks/problem "
        f"{kv.sum(1).min()}..{kv.sum(1).max()}; "
        f"tolerance: equal except IoU within 1e-6 of the threshold")


def check_topk(n, k, width=80 * 128 * 9 * 80):
    import jax
    import jax.numpy as jnp

    from sad_tpu.ops import topk

    x = jax.random.uniform(jax.random.PRNGKey(3), (n, width))
    x = jnp.round(x * 4096.0) / 4096.0  # ties at the k-th value
    got_v, got_i = jax.jit(jax.vmap(lambda r: topk.top_k(r, k)))(x)
    ref_v, _ = jax.jit(lambda r: jax.lax.top_k(r, k))(x)
    got_v, ref_v = np.asarray(got_v), np.asarray(ref_v)
    err = float(np.abs(np.sort(got_v, 1) - np.sort(ref_v, 1)).max())
    picked = np.take_along_axis(np.asarray(x), np.asarray(got_i), 1)
    assert err == 0.0 and np.array_equal(picked, got_v), "top-k multiset differs"
    log(f"kernel top_k (approx_max_k recall 1.0) vs lax.top_k, {n}x{x.shape[1]} "
        f"k={k}: max |sorted value diff| {err} (tolerance 0)")


def check_losses(seed: int, grid=(2, 80, 128, 9, 80)):
    """ops/losses.py against the numpy transcriptions of the CUDA kernels
    over a full P3 grid (2 images, 80x128 cells, 9 anchors, 80 classes)."""
    import jax
    import jax.numpy as jnp

    from sad_tpu.ops import losses as L
    from sad_tpu.ops import reference_numpy as R

    rng = np.random.RandomState(seed)
    n, h, w, a, c = grid
    logits = (rng.randn(n, h, w, a, c) * 3).astype(np.float32)
    tprob = rng.uniform(1e-4, 1 - 1e-4, (n, h, w, a, c)).astype(np.float32)
    labels = rng.randint(-1, c + 1, (n, h, w, a)).astype(np.int32)
    box = rng.randn(n, h, w, a, 4).astype(np.float32)
    fg = rng.rand(n, h, w, a) < 0.01  # box-regression anchors (sparse)
    tgt = rng.randn(n, h, w, a, 4).astype(np.float32) * fg[..., None]
    wp = float(fg.sum())
    locs = np.argwhere(fg)  # rows (n, y, x, a) -> the oracle's [n, 4a, y, x]
    sparse_locs = np.stack(
        [locs[:, 0], 4 * locs[:, 3], locs[:, 1], locs[:, 2]], 1
    ).astype(np.float32)
    to_nchw = lambda x: x.reshape(n, h, w, -1).transpose(0, 3, 1, 2)
    lab_nchw = labels.transpose(0, 3, 1, 2)
    with jax.default_matmul_precision("highest"):
        got = {
            "sigmoid_focal_loss": L.sigmoid_focal_loss(
                jnp.asarray(logits), jnp.asarray(labels), jnp.float32(wp),
                2.0, 0.25, 0.5),
            "sigmoid_adaptive_distill_loss": L.sigmoid_adaptive_distill_loss(
                jnp.asarray(logits), jnp.asarray(tprob), jnp.asarray(labels),
                jnp.float32(wp), 2.0, 0.5, 0.0, -1, 0.5),
            "pow_sum": L.pow_sum([jnp.asarray(tprob)], 1.8),
            "select_smooth_l1_loss": L.select_smooth_l1_loss(
                jnp.asarray(box), jnp.asarray(tgt), jnp.asarray(fg),
                jnp.float32(wp), 0.11, 0.5),
        }
        got = {k: float(v) for k, v in got.items()}
    ref = {
        "sigmoid_focal_loss": R.sigmoid_focal_loss_fwd(
            to_nchw(logits), lab_nchw, wp, 2.0, 0.25, c, 0.5)[0],
        "sigmoid_adaptive_distill_loss": R.sigmoid_adaptive_distill_loss_fwd(
            to_nchw(logits), to_nchw(tprob), lab_nchw, wp, 2.0, 0.5, 0.0, c,
            -1, 0.5)[0],
        "pow_sum": R.pow_sum([tprob], 1.8),
        "select_smooth_l1_loss": R.select_smooth_l1_loss_fwd(
            to_nchw(box), tgt[fg], sparse_locs, wp, 0.11, 0.5)[0],
    }
    for name in got:
        r = float(ref[name])
        err = abs(got[name] - r)
        tol = 1e-6 + 1e-5 * abs(r)
        log(f"kernel {name} (P3 grid {n}x{h}x{w}x{a}x{c}, f32): "
            f"|got-ref| {err:.3e} (tolerance {tol:.3e}, rtol 1e-5 atol 1e-6)")
        assert err <= tol, f"{name}: {got[name]} vs reference {r}"


def teacher_precision_gap(seed: int):
    """Information: the R-101 teacher forward in f32 at the default matmul
    precision (TF32 on this card) against the highest precision."""
    import jax
    import jax.numpy as jnp

    from sad_tpu.config import load_cfg
    from sad_tpu.models import create_model
    from sad_tpu.models.model_builder import init_model_params

    cfg = load_cfg(TEACHER_YAML, INIT_OPTS + ["COMPUTE_DTYPE", "float32"])
    model = create_model(cfg)
    params = init_model_params(model, jax.random.PRNGKey(seed), (1, 640, 1024, 3))
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (2, 640, 1024, 3))
    fwd = lambda p, im: model.apply({"params": p}, im)
    with jax.default_matmul_precision("highest"):
        hi = jax.jit(fwd)(params, x)
    lo = jax.jit(fwd)(params, x)
    for key in ("cls_prob", "bbox_pred"):
        d = max(float(jnp.abs(hi[key][l] - lo[key][l]).max()) for l in hi[key])
        s = max(float(jnp.abs(hi[key][l]).max()) for l in hi[key])
        log(f"info teacher R-101 f32 {key}: max |default - highest| {d:.3e} "
            f"(max |value| {s:.3e})")


# --------------------------------------------------------------- trainer


def make_datasets(root: str, seed: int, sizes=(480, 480)) -> None:
    """Synthetic COCO splits at the config's scales, registered under the
    config's dataset names (80 categories, like COCO). Square images all
    land on one canvas orientation, so each program compiles once."""
    from sad_tpu.config.catalog import register_dataset
    from sad_tpu.data.synth_coco import generate_synthetic_coco

    # the loader resizes to 600 (max 1000) on the 640x1024 canvas
    splits = {
        "coco_2017_train": dict(n_images=32, labeled=True),
        "coco_2017_unlabel_R101_600": dict(n_images=32, labeled=True),
        "coco_2017_unlabel": dict(n_images=16, labeled=False),
    }
    for i, (name, kw) in enumerate(splits.items()):
        img_dir, ann = generate_synthetic_coco(
            root, name, seed=seed + i, n_categories=80, size_range=sizes, **kw
        )
        register_dataset(name, img_dir, ann, allow_override=True)


def write_cfg(path: str, yaml_path: str, opts) -> str:
    from sad_tpu.config import load_cfg
    from sad_tpu.config.config import cfg_to_yaml

    with open(path, "w") as f:
        f.write(cfg_to_yaml(load_cfg(yaml_path, opts)))
    return path


def peak_gib(device) -> float:
    return device.memory_stats()["peak_bytes_in_use"] / 2 ** 30


def run_trainer(work: str, student_yaml: str, teacher_yaml: str, opts,
                iters: int = 4):
    """tools.train_net for `iters` SAD steps, then again (resume no-op)."""
    from sad_tpu.config import load_cfg
    from sad_tpu.config.config import get_output_dir
    from sad_tpu.tools import train_net
    from sad_tpu.train.checkpoint import load_checkpoint

    out = os.path.join(work, "train_out")
    teacher_cfg = write_cfg(os.path.join(work, "teacher.yaml"), teacher_yaml,
                            INIT_OPTS)
    argv = ["--cfg", student_yaml, "--teacher_cfg", teacher_cfg, "--skip-test",
            "--max-iters", str(iters), "OUTPUT_DIR", out] + list(opts)
    cfg = load_cfg(student_yaml, argv[argv.index("OUTPUT_DIR"):])
    assert cfg.DISTILLATION.UNLABEL_DISTILLATION
    run_dir = get_output_dir(cfg, training=True)

    t0 = time.perf_counter()
    train_net.main(argv)
    first = time.perf_counter() - t0
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        stats_text = f.read()
    stats = [json.loads(line) for line in stats_text.splitlines()]
    losses = [s["loss"] for s in stats]
    assert stats and all(np.isfinite(losses)), f"non-finite losses {losses}"
    final = os.path.join(run_dir, "model_final.pkl")
    assert load_checkpoint(final)["iter"] == iters, "checkpoint not written"

    t0 = time.perf_counter()
    train_net.main(argv)
    second = time.perf_counter() - t0
    with open(os.path.join(run_dir, "stats.jsonl")) as f:
        assert f.read() == stats_text, "re-run trained again instead of resuming"
    assert load_checkpoint(final)["iter"] == iters
    return {
        "images_per_step": cfg.TRAIN.IMS_PER_BATCH * cfg.NUM_GPUS,
        "stats": stats, "first_run_s": first, "resume_run_s": second,
    }


def run_pseudo_labels(work: str, teacher_yaml: str, opts, n_images: int = 16):
    """tools.test_net --pseudo-out over the unlabeled split."""
    from sad_tpu.tools import test_net

    out_json = os.path.join(work, "pseudo.json")
    teacher_cfg = write_cfg(os.path.join(work, "teacher_test.yaml"),
                            teacher_yaml, INIT_OPTS + list(opts))
    t0 = time.perf_counter()
    test_net.main(["--cfg", teacher_cfg, "--pseudo-out", out_json,
                   "--pseudo-score-thresh", "0.0", "--batch-size", "16",
                   "TEST.SCORE_THRESH", "0.0",
                   "OUTPUT_DIR", os.path.join(work, "test_out")])
    seconds = time.perf_counter() - t0
    with open(out_json) as f:
        doc = json.load(f)
    anns = doc["annotations"]
    cats = {c["id"] for c in doc["categories"]}
    assert len(doc["images"]) == n_images
    assert anns, "pseudo-label json has no annotations"
    for a in anns:
        assert a["category_id"] in cats and len(a["bbox"]) == 4
        assert np.all(np.isfinite(a["bbox"])) and np.isfinite(a["score"])
    return {"annotations": len(anns), "images": len(doc["images"]),
            "seconds": seconds}


# --------------------------------------------------------------- 4 GPUs


def synthetic_step_batch(cfg, n_images: int, n_groups: int, h: int, w: int,
                         seed: int):
    """A train-step batch (uint8 canvases, anchor labels and targets)."""
    rng = np.random.RandomState(seed)
    a = cfg.num_anchors_per_cell()
    batch = {
        "data_u8": rng.randint(0, 255, (n_images, h, w, 3)).astype(np.uint8),
        "content_hw": np.tile(np.float32([h, w]), (n_images, 1)),
        "labels": {}, "bbox_targets": {}, "fg_mask": {},
        "fg_num": rng.uniform(4, 40, (n_groups,)).astype(np.float32),
    }
    for lvl in cfg.fpn_levels():
        hl, wl = h // 2 ** lvl, w // 2 ** lvl
        labels = rng.randint(-1, cfg.MODEL.NUM_CLASSES, (n_images, hl, wl, a))
        batch["labels"][lvl] = labels.astype(np.int32)
        batch["bbox_targets"][lvl] = rng.randn(n_images, hl, wl, a, 4).astype(
            np.float32)
        batch["fg_mask"][lvl] = labels > 0
    return batch


def data_parallel_step(student_cfg, teacher_cfg, devices, n_images: int,
                       n_groups: int, h: int, w: int, seed: int,
                       lr: float = 1e-3):
    """One SAD step on a 'data' mesh over `devices` and on devices[0] alone
    (the train loop's sharding, train/train_loop.py). Returns
    (loss_mesh, loss_one, params_mesh, params_one) as numpy."""
    import jax
    import jax.numpy as jnp

    from sad_tpu.models import create_model
    from sad_tpu.models.model_builder import init_model_params
    from sad_tpu.parallel import create_mesh
    from sad_tpu.parallel.mesh import replicated_sharding, shard_batch_tree
    from sad_tpu.train import TrainState, init_momentum_state, make_train_step

    student, teacher = create_model(student_cfg), create_model(teacher_cfg)
    sp = init_model_params(student, jax.random.PRNGKey(seed), (1, h, w, 3))
    tp = init_model_params(teacher, jax.random.PRNGKey(seed + 1), (1, h, w, 3))
    host = synthetic_step_batch(student_cfg, n_images, n_groups, h, w, seed)
    step = make_train_step(student_cfg, student, teacher, n_groups=n_groups,
                           teacher_cfg=teacher_cfg)

    def run(devs):
        mesh = create_mesh(n_data=len(devs), devices=devs)
        rep = replicated_sharding(mesh)
        state = TrainState(jax.device_put(sp, rep),
                           jax.device_put(init_momentum_state(sp).velocity, rep))
        new, metrics = jax.jit(step)(state, jax.device_put(tp, rep),
                                     shard_batch_tree(host, mesh), jnp.float32(lr))
        return (float(metrics["loss"]),
                jax.tree_util.tree_map(np.asarray, new.params))

    loss_mesh, p_mesh = run(list(devices))
    loss_one, p_one = run([devices[0]])
    return loss_mesh, loss_one, p_mesh, p_one


def compare_steps(loss_mesh, loss_one, p_mesh, p_one, rtol: float = 1e-4):
    import jax

    np.testing.assert_allclose(loss_mesh, loss_one, rtol=rtol)
    worst = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(p_mesh),
                    jax.tree_util.tree_leaves(p_one)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6)
        worst = max(worst, float(np.max(np.abs(a - b))))
    return worst


def four_gpu_phase(devices, seed: int, extra_opts=(), h: int = 640,
                   w: int = 1024):
    """The --four phase on `devices` (four of them)."""
    import jax

    from sad_tpu.config import load_cfg

    opts = INIT_OPTS + ["NUM_GPUS", "8"] + list(extra_opts)
    n_images, n_groups = 16, 8
    f32 = ["COMPUTE_DTYPE", "float32"]
    scfg, tcfg = (load_cfg(y, opts + f32) for y in (STUDENT_YAML, TEACHER_YAML))
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        lm, lo, pm, po = data_parallel_step(scfg, tcfg, devices, n_images,
                                            n_groups, h, w, seed)
    worst = compare_steps(lm, lo, pm, po)
    log(f"four: f32 SAD step, {n_images} images in {n_groups} groups at "
        f"{h}x{w}: loss 4 GPUs {lm!r} vs 1 GPU {lo!r}; max |param diff| "
        f"{worst:.3e} (rtol 1e-4) [{time.perf_counter() - t0:.1f} s incl. "
        f"compile]")
    bf16 = ["COMPUTE_DTYPE", "bfloat16"]
    scfg, tcfg = (load_cfg(y, opts + bf16) for y in (STUDENT_YAML, TEACHER_YAML))
    lb, _, _, _ = data_parallel_step(scfg, tcfg, devices, n_images, n_groups,
                                     h, w, seed + 2)
    assert np.isfinite(lb), f"bf16 4-GPU step loss {lb}"
    log(f"four: bf16 SAD step on 4 GPUs: loss {lb!r}")
    return len(devices)


# --------------------------------------------------------------- main


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--four", action="store_true",
                   help="only the 4-GPU data-parallel step and its comparison")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    if args.four:
        # the f32 reference step on one GPU needs most of the card
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.95")
    import jax

    devices = require_gpu(4 if args.four else 1)
    compiles = CompileLog()
    from sad_tpu.utils.env import enable_compile_cache

    log(f"device: {devices[0].device_kind} x{len(devices)} "
        f"(platform {devices[0].platform}); compile cache "
        f"{enable_compile_cache()}")
    log(f"optional imports: {json.dumps(optional_imports(), sort_keys=True)}")

    if args.four:
        count = four_gpu_phase(devices[:4], args.seed)
    else:
        check_nms(16, 5000, 100, 0.5, args.seed)
        check_nms(4, 12000, 2000, 0.7, args.seed + 1)
        check_topk(2, 1000)
        check_losses(args.seed)
        teacher_precision_gap(args.seed)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            make_datasets(os.path.join(work, "data"), args.seed)
            mark = len(compiles.events)
            tr = run_trainer(work, STUDENT_YAML, TEACHER_YAML, INIT_OPTS)
            steps = tr["stats"]
            log(f"trainer (smoke reading, not a benchmark): "
                f"{tr['images_per_step']} images/step; train loop's timer, "
                f"mean s/step over iterations 0-3 (lagged: it holds any "
                f"compile after iteration 0): {steps[-1]['time']}; losses "
                f"{[(s['iter'], s['loss']) for s in steps]}; run "
                f"{tr['first_run_s']:.1f} s incl. compile; resume no-op "
                f"{tr['resume_run_s']:.1f} s; peak "
                f"{peak_gib(devices[0]):.2f} GiB; compiles >= 1 s: "
                f"{compiles.summary(mark)}")
            mark = len(compiles.events)
            pl = run_pseudo_labels(work, TEACHER_YAML, [])
            log(f"pseudo-labels (smoke reading): {pl['annotations']} boxes over "
                f"{pl['images']} images in {pl['seconds']:.1f} s incl. compile; "
                f"peak {peak_gib(devices[0]):.2f} GiB; compiles >= 1 s: "
                f"{compiles.summary(mark)}")
        count = len(jax.devices())
    log(f"all compiles >= 5 s (local time, name, seconds): "
        f"{compiles.summary(min_s=5.0)}")
    log(f"card: {card_info()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
