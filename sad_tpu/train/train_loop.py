"""Training driver: the tools/train_net.py `train_model` equivalent.

Replicates (ref: detectron/tools/train_net.py:104-266):
- teacher + student config pair; teacher weights loaded frozen,
- AUTO_RESUME checkpoint scan (:208-233),
- the SGD hot loop: LR schedule feed + momentum correction on LR change,
  jitted joint step, smoothed JSON stats, periodic checkpoints
  (SNAPSHOT_ITERS / NUM_GPUS), NaN-loss abort (:186-189),
- loader lifecycle with clean shutdown.

Design notes: there is no CreateNet/RunNet boundary — the jitted step
IS the executable; the per-iter host work is the same as the reference's
(lr feed + stats fetch). Device transfer overlaps compute via JAX async
dispatch and a prefetching host loader.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sad_tpu.config import Config
from sad_tpu.config.config import get_output_dir
from sad_tpu.data.dataset import combined_roidb_for_training
from sad_tpu.data.loader import TrainingLoader
from sad_tpu.models import create_model
from sad_tpu.models.model_builder import init_model_params
from sad_tpu.utils.logging import setup_logging
from sad_tpu.utils.stats import TrainingStats

from .checkpoint import (
    find_latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from .lr_policy import get_lr_at_iter, lr_change_correction
from .optimizer import MomentumSGDState, init_momentum_state, rescale_momentum
from .train_step import TrainState, make_train_step

logger = setup_logging(__name__)


def _canvas_probe_shape(cfg: Config):
    from sad_tpu.data.minibatch import canvas_shapes

    (h, w), _ = canvas_shapes(cfg)
    return (1, h, w, 3)


def train_model(
    cfg: Config,
    teacher_cfg: Optional[Config] = None,
    max_iters: Optional[int] = None,
    loader: Optional[TrainingLoader] = None,
    output_dir: Optional[str] = None,
) -> TrainState:
    """Run the full training loop; returns the final TrainState."""
    distill = cfg.DISTILLATION.DISTILLATION_ON and teacher_cfg is not None
    output_dir = output_dir or get_output_dir(cfg, training=True)
    os.makedirs(output_dir, exist_ok=True)
    max_iters = max_iters or cfg.SOLVER.MAX_ITER
    # embed the active config in checkpoints (ref: net.py:149-182 stores
    # 'cfg' yaml in every weights pkl) and in the run dir for the dashboard
    from sad_tpu.config.config import cfg_to_yaml

    cfg_yaml = cfg_to_yaml(cfg)
    with open(os.path.join(output_dir, "cfg.yaml"), "w") as f:
        f.write(cfg_yaml)

    # ----- models + params
    student = create_model(cfg)
    probe = _canvas_probe_shape(cfg)
    params = init_model_params(student, jax.random.PRNGKey(cfg.RNG_SEED), probe)
    teacher = teacher_params = None
    if distill:
        teacher = create_model(teacher_cfg)
        teacher_params = init_model_params(
            teacher, jax.random.PRNGKey(cfg.RNG_SEED + 1), probe
        )
        if teacher_cfg.TRAIN.WEIGHTS:
            teacher_params = load_reference_or_native(
                teacher_cfg.TRAIN.WEIGHTS, teacher_params, teacher_cfg
            )
            logger.info("Loaded teacher weights: %s", teacher_cfg.TRAIN.WEIGHTS)

    # ----- checkpoint backend (TRAIN.CHECKPOINT_BACKEND)
    if cfg.TRAIN.CHECKPOINT_BACKEND not in ("pickle", "orbax"):
        raise ValueError(
            "TRAIN.CHECKPOINT_BACKEND must be 'pickle' or 'orbax'; got "
            f"{cfg.TRAIN.CHECKPOINT_BACKEND!r}"
        )
    ckptr = None
    if cfg.TRAIN.CHECKPOINT_BACKEND == "orbax":
        from .orbax_checkpoint import OrbaxCheckpointer

        ckptr = OrbaxCheckpointer(os.path.join(output_dir, "checkpoints"))

    # ----- resume / init weights (train_net.py:208-233, net.py:50)
    start_iter = 0
    velocity = init_momentum_state(params).velocity
    if cfg.TRAIN.AUTO_RESUME and ckptr is not None:
        step = ckptr.latest_step()
        if step is not None:
            payload = ckptr.restore(
                step, target={"params": params, "velocity": velocity}
            )
            params = jax.tree_util.tree_map(jnp.asarray, payload["params"])
            if payload.get("velocity") is not None:
                velocity = jax.tree_util.tree_map(
                    jnp.asarray, payload["velocity"]
                )
            # the orbax step IS the resume iter; step == max_iters means a
            # completed run (the model_final analogue) and skips the loop
            start_iter = int(step)
            logger.info("Auto-resumed from orbax step %d", step)
    elif cfg.TRAIN.AUTO_RESUME:
        ckpt_path, start_iter_ = find_latest_checkpoint(output_dir)
        if ckpt_path:
            ck = load_checkpoint(ckpt_path)
            params = jax.tree_util.tree_map(jnp.asarray, ck["params"])
            if ck.get("velocity") is not None:
                velocity = jax.tree_util.tree_map(jnp.asarray, ck["velocity"])
            # model_final.pkl => training already complete (train_net.py:213)
            start_iter = ck.get("iter", max(start_iter_, 0))
            if start_iter_ < 0:
                start_iter = max(start_iter, max_iters)
            logger.info("Auto-resumed from %s at iter %d", ckpt_path, start_iter)
    if start_iter == 0 and cfg.TRAIN.WEIGHTS:
        params = load_reference_or_native(cfg.TRAIN.WEIGHTS, params, cfg)
        logger.info("Initialized student from %s", cfg.TRAIN.WEIGHTS)

    # ----- data
    is_rcnn = cfg.MODEL.TYPE in ("generalized_rcnn", "rpn", "rfcn")
    own_loader = loader is None
    if own_loader:
        roidb = combined_roidb_for_training(
            cfg.TRAIN.DATASETS, cfg.TRAIN.USE_FLIPPED,
            gt_min_area=cfg.TRAIN.GT_MIN_AREA,
            require_keypoints=cfg.MODEL.KEYPOINTS_ON,
        )
        if (
            is_rcnn and cfg.TRAIN.PROPOSAL_FILES
            and not cfg.MODEL.FASTER_RCNN
        ):
            # pure Fast R-CNN: attach the precomputed proposal set, one
            # file per dataset (ref: roidb.py combined_roidb_for_training
            # zips TRAIN.DATASETS with TRAIN.PROPOSAL_FILES)
            from sad_tpu.eval.rpn_generator import add_proposals_to_roidb

            if len(cfg.TRAIN.PROPOSAL_FILES) != len(cfg.TRAIN.DATASETS):
                raise ValueError(
                    "TRAIN.PROPOSAL_FILES must pair 1:1 with TRAIN.DATASETS "
                    f"(got {len(cfg.TRAIN.PROPOSAL_FILES)} files for "
                    f"{len(cfg.TRAIN.DATASETS)} datasets; ref roidb.py "
                    "combined_roidb_for_training asserts the same)"
                )
            for dname, pf in zip(
                cfg.TRAIN.DATASETS, cfg.TRAIN.PROPOSAL_FILES
            ):
                sub = [
                    e for e in roidb if e.get("dataset_name") == dname
                ]
                add_proposals_to_roidb(
                    sub, pf, crowd_thresh=cfg.TRAIN.CROWD_FILTER_THRESH
                )
        unlabeled = None
        if distill and cfg.DISTILLATION.UNLABEL_DISTILLATION:
            unlabeled = combined_roidb_for_training(
                cfg.DISTILLATION.UNLABEL_DATASETS, cfg.TRAIN.USE_FLIPPED,
                gt_min_area=cfg.TRAIN.GT_MIN_AREA,
            )
        builder = None
        if is_rcnn:
            from sad_tpu.data.rpn_minibatch import RCNNMinibatchBuilder

            builder = RCNNMinibatchBuilder(cfg)
        if cfg.DATA_LOADER.NUM_PROCESSES:
            from sad_tpu.data.mp_loader import MultiprocessTrainingLoader

            n_procs = cfg.DATA_LOADER.NUM_PROCESSES
            loader = MultiprocessTrainingLoader(
                cfg, roidb, teacher_cfg if distill else None, unlabeled,
                builder=builder,
                num_workers=None if n_procs < 0 else n_procs,
                skip_batches=start_iter,
            ).start(prefill=True)
        else:
            loader = TrainingLoader(
                cfg, roidb, teacher_cfg if distill else None, unlabeled,
                builder=builder,
                num_threads=cfg.DATA_LOADER.NUM_THREADS,
                skip_batches=start_iter,
            ).start(prefill=True)

    # ----- device mesh: with >1 chips, replicate params over the 'data'
    # axis and shard batches (the reference's per-GPU replication +
    # broadcast, as shardings; SURVEY.md §5.8). The data axis must divide
    # the global batch, so use gcd(batch, devices) devices — e.g. a 2-image
    # debug batch on an 8-chip host trains on 2 chips rather than silently
    # replicating on all 8.
    import math as _math

    batch_images = getattr(
        loader, "batch_images", cfg.TRAIN.IMS_PER_BATCH * cfg.NUM_GPUS
    )
    mesh = None
    n_data = _math.gcd(batch_images, jax.device_count())
    if n_data > 1:
        from sad_tpu.parallel import create_mesh
        from sad_tpu.parallel.mesh import replicated_sharding

        mesh = create_mesh(n_data=n_data, devices=jax.devices()[:n_data])
        rep = replicated_sharding(mesh)
        params = jax.device_put(params, rep)
        velocity = jax.device_put(velocity, rep)
        if teacher_params is not None:
            teacher_params = jax.device_put(teacher_params, rep)
        logger.info("Using mesh %s", mesh)

    if own_loader:
        # BlobsQueue equivalent: overlap next-batch H2D (and mesh sharding)
        # with the in-flight step (ref: loader.py:250-273)
        from sad_tpu.data.loader import DevicePrefetcher

        if mesh is not None:
            from sad_tpu.parallel.mesh import shard_batch_tree

            loader = DevicePrefetcher(
                loader, lambda b: shard_batch_tree(b, mesh)
            )
        else:
            loader = DevicePrefetcher(loader)

    # ----- jitted step
    # Metrics leave the device as ONE packed f32 vector, not a dict of
    # scalars: every float(scalar) would be a separate device-to-host copy.
    # The stacking happens INSIDE the jitted step so the loop pays exactly
    # one dispatch + one transfer per iteration.
    n_groups = cfg.NUM_GPUS
    metric_names: list = []

    def _pack(m):
        if not metric_names:
            metric_names.extend(sorted(m))
        return jnp.stack(
            [m[k].astype(jnp.float32) for k in metric_names]
        )

    if is_rcnn:
        from .rcnn_train import make_rcnn_train_step

        rcnn_raw = make_rcnn_train_step(cfg, student, n_groups=n_groups)

        def rcnn_packed(state, batch, lr, key):
            new_state, m = rcnn_raw(state, batch, lr, key)
            return new_state, _pack(m)

        rcnn_step = jax.jit(rcnn_packed, donate_argnums=(0,))
        # per-iter key by fold_in (NOT a sequential split chain): a resumed
        # run regenerates the exact key the uninterrupted run used at each
        # iteration, which makes resume bit-identical (the loader already
        # fast-forwards its batch schedule via skip_batches)
        rng_base = jax.random.PRNGKey(cfg.RNG_SEED + 7)
        rng_iter = iter(range(start_iter, 2 ** 62))

        def step_fn(state, _teacher_params, batch, lr):
            sub = jax.random.fold_in(rng_base, next(rng_iter))
            return rcnn_step(state, batch, lr, sub)

    else:
        sad_raw = make_train_step(
            cfg, student, teacher, n_groups=n_groups, teacher_cfg=teacher_cfg,
        )

        def sad_packed(state, teacher_params, batch, lr):
            new_state, m = sad_raw(state, teacher_params, batch, lr)
            return new_state, _pack(m)

        step_fn = jax.jit(sad_packed, donate_argnums=(0,))
    state = TrainState(params, velocity)
    from sad_tpu.utils.net_info import print_model_summary

    logger.info("Model parameter summary (net.py:224 print_net analogue):")
    print_model_summary(params, max_rows=12)
    stats_path = os.path.join(output_dir, "stats.jsonl")
    if start_iter == 0 and os.path.exists(stats_path):
        # fresh run into a reused dir: truncate, don't concatenate runs
        # (a resume appends, keeping one continuous series)
        os.remove(stats_path)
    stats = TrainingStats(max_iters, log_file=stats_path)
    snapshot_period = max(1, cfg.TRAIN.SNAPSHOT_ITERS // max(cfg.NUM_GPUS, 1))
    # Resume initializes cur_lr to the PREVIOUS iter's LR so that a schedule
    # step landing exactly on start_iter still triggers the momentum
    # correction the uninterrupted run would have applied at that boundary
    # (detector.py:624-648 semantics).
    cur_lr = get_lr_at_iter(cfg.SOLVER, max(start_iter - 1, 0))

    profiling = False
    pending = None

    def _consume_metrics(p_it, p_lr, p_metrics):
        # one D2H for the whole metric vector (see the packing note above)
        vals = np.asarray(p_metrics, np.float32)
        host = dict(zip(metric_names, (float(v) for v in vals)))
        stats.iter_toc()
        stats.update_iter_stats(p_it, host)
        will_log = (
            p_it % stats.log_period == 0 or p_it == stats.max_iter - 1
        )
        # device memory is read only on iterations that emit a log line
        stats.log_iter_stats(
            p_it, p_lr,
            extra=(
                {"queue": loader.queue_depth(), **device_memory_stats()}
                if will_log else None
            ),
        )
        if not np.isfinite(host["loss"]):
            save_checkpoint(
                os.path.join(output_dir, "model_nan_abort.pkl"),
                state.params, state.velocity, p_it,
                cfg_yaml=cfg_yaml,
            )
            raise FloatingPointError(
                f"Loss is {host['loss']} at iter {p_it}; aborting "
                "(train_net.py:186-189)"
            )

    try:
        for it in range(start_iter, max_iters):
            if cfg.PROFILE_DIR and it == cfg.PROFILE_START_ITER:
                jax.profiler.start_trace(cfg.PROFILE_DIR)
                profiling = True
                logger.info("profiler trace started -> %s", cfg.PROFILE_DIR)
            stats.iter_tic()
            new_lr = get_lr_at_iter(cfg.SOLVER, it)
            if new_lr != cur_lr:
                corr = lr_change_correction(cfg.SOLVER, cur_lr, new_lr)
                if corr is not None:
                    from sad_tpu.models import trainable_mask

                    mstate = rescale_momentum(
                        MomentumSGDState(state.velocity),
                        corr,
                        trainable_mask(state.params, cfg.TRAIN.FREEZE_AT,
                                       cfg.TRAIN.FREEZE_CONV_BODY),
                    )
                    state = TrainState(state.params, mstate.velocity)
                    logger.info("Scaled momentum by %.6f at iter %d", corr, it)
                cur_lr = new_lr

            batch = loader.get_next_batch()
            if mesh is not None and not own_loader:
                from sad_tpu.parallel.mesh import shard_batch_tree

                batch = shard_batch_tree(batch, mesh)
            state, metrics = step_fn(
                state, teacher_params, batch, jnp.float32(cur_lr)
            )
            # Lagged stats: converting metrics to host floats blocks on the
            # device (profiler-measured: float(loss) serialized every step);
            # process the PREVIOUS step's metrics while this one runs, so one
            # step is always in flight. The reference has the same laziness —
            # FetchBlob reads results of the already-finished RunNet.
            if pending is not None:
                p_it, p_lr, p_metrics = pending
                _consume_metrics(p_it, p_lr, p_metrics)
            pending = (it, cur_lr, metrics)

            if profiling and it == cfg.PROFILE_START_ITER + cfg.PROFILE_NUM_ITERS:
                jax.block_until_ready(metrics["loss"])
                jax.profiler.stop_trace()
                profiling = False
                logger.info("profiler trace stopped")

            if (it + 1) % snapshot_period == 0 and it + 1 < max_iters:
                if ckptr is not None:
                    # async: the save overlaps the next train steps
                    ckptr.save(it + 1, state.params, state.velocity)
                else:
                    save_checkpoint(
                        os.path.join(output_dir, f"model_iter{it}.pkl"),
                        state.params, state.velocity, it + 1,
                        cfg_yaml=cfg_yaml,
                    )
        if pending is not None:
            _consume_metrics(*pending)
        if ckptr is not None:
            if ckptr.latest_step() != max_iters:  # resume no-op: keep as-is
                ckptr.save(max_iters, state.params, state.velocity)
        else:
            save_checkpoint(
                os.path.join(output_dir, "model_final.pkl"),
                state.params, state.velocity, max_iters,
                cfg_yaml=cfg_yaml,
            )
    finally:
        if ckptr is not None:
            ckptr.wait()
            ckptr.close()
        if own_loader:
            loader.shutdown()
    return state


def device_memory_stats() -> Dict[str, float]:
    """Peak device memory in MB (the reference's caffe2_gpu_memory_tracking
    analogue, train_net.py:106-108)."""
    try:
        st = jax.devices()[0].memory_stats() or {}
        peak = st.get("peak_bytes_in_use", 0)
        return {"mem_peak_mb": round(peak / 1e6, 1)} if peak else {}
    except Exception:
        return {}


def load_reference_or_native(path: str, params_template, cfg=None):
    """Dispatch on checkpoint format: native sad_tpu pickle vs reference
    Caffe2 blob pickle (net.py:50-146) vs an orbax run directory (either
    OUTPUT_DIR/checkpoints or the OUTPUT_DIR that contains it — lets
    test_net evaluate straight from a TRAIN.CHECKPOINT_BACKEND=orbax run,
    which writes no model_final.pkl). Pass cfg so flattening-FC kernels
    (fc6 / mask_fcn_logits) get their CHW->HWC input-row permutation."""
    import pickle

    if os.path.isdir(path):
        from .orbax_checkpoint import OrbaxCheckpointer

        ckpt_dir = path
        sub = os.path.join(path, "checkpoints")
        if os.path.isdir(sub):
            ckpt_dir = sub
        ck = OrbaxCheckpointer(ckpt_dir)
        step = ck.latest_step()
        if step is None:
            raise FileNotFoundError(f"No orbax checkpoints under {ckpt_dir}")
        payload = ck.restore(step)
        logger.info("Loaded orbax step %d from %s", step, ckpt_dir)
        return jax.tree_util.tree_map(jnp.asarray, payload["params"])

    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if isinstance(data, dict) and "params" in data:
        return jax.tree_util.tree_map(jnp.asarray, data["params"])
    from .checkpoint import fc_flatten_resolutions, reference_blobs_to_flax

    blobs = data.get("blobs", data)
    params, loaded, skipped = reference_blobs_to_flax(
        blobs, params_template,
        fc_resolutions=fc_flatten_resolutions(cfg) if cfg is not None else None,
    )
    logger.info(
        "Reference weights: loaded %d blobs, skipped %d params",
        len(loaded), len(skipped),
    )
    return jax.tree_util.tree_map(jnp.asarray, params)
