"""Jitted training steps: plain RetinaNet and joint teacher+student SAD.

Replaces the reference's data-parallel graph construction
(optimizer.py:33-130 + model_builder.py:373-411) with one pure function jitted
over a device mesh:

- The reference replicates the graph per GPU under name scopes and allreduces
  gradients; here the batch is sharded over the 'data' mesh axis and XLA
  inserts the psum because the loss sums over the whole batch.
- The reference computes loss normalizers (retnet_fg_num, PowSum) *per GPU*
  over its 2-image minibatch, and scales every loss by 1/NUM_GPUS
  (detector.py:650-655). We reproduce that math exactly by splitting the
  global batch into G "groups" of TRAIN.IMS_PER_BATCH images: normalizers are
  per-group, loss scale is 1/G. With G == number of data shards this is
  bit-compatible with the reference's N-GPU run (and stays mathematically
  identical for any G).
- The frozen teacher runs inside the same step on its own pixel-normalized
  input (minibatch.py:74-82) under stop_gradient; the distill loss's custom
  VJP sends it no gradient anyway (the reference gradient maker passes only
  GI(0), sigmoid_adaptive_distillation_loss_op.cc:99-112).

Batch pytree (static shapes, NHWC):
  data:          (B, H, W, 3) float32 — student-normalized pixels
  teacher_data:  (B, H, W, 3) float32 — teacher-normalized pixels (SAD only)
  labels:        {lvl: (B, H_l, W_l, A) int32}
  bbox_targets:  {lvl: (B, H_l, W_l, A, 4) float32}
  fg_mask:       {lvl: (B, H_l, W_l, A) bool}
  fg_num:        (G,) float32 — per-group fg counts (retinanet.py:111-158)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from sad_tpu.config import Config
from sad_tpu.models import RetinaNet, bias_mask, trainable_mask
from sad_tpu.ops import (
    pow_sum,
    select_smooth_l1_loss,
    sigmoid_adaptive_distill_loss,
    sigmoid_focal_loss,
)

from .optimizer import MomentumSGDState, momentum_sgd_update


class TrainState(NamedTuple):
    params: Any
    velocity: Any  # momentum pytree


def _group_view(x: jnp.ndarray, n_groups: int) -> jnp.ndarray:
    """(B, ...) -> (G, B/G, ...)."""
    return x.reshape((n_groups, x.shape[0] // n_groups) + x.shape[1:])


def _split_anchor_axis(x: jnp.ndarray, num_anchors: int) -> jnp.ndarray:
    """(..., A*K) -> (..., A, K)."""
    return x.reshape(x.shape[:-1] + (num_anchors, x.shape[-1] // num_anchors))


def retinanet_losses(
    cfg: Config,
    outputs: Dict[str, Dict[int, jnp.ndarray]],
    batch: Dict[str, Any],
    n_groups: int,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Focal + select-smooth-L1 over all levels with per-group normalizers
    (ref: retinanet_heads.py:248-311)."""
    a = cfg.num_anchors_per_cell()
    loss_scale = 1.0 / n_groups  # GetLossScale (detector.py:650-655)
    metrics: Dict[str, jnp.ndarray] = {}
    total = jnp.float32(0.0)
    fg_num = batch["fg_num"]  # (G,)

    for lvl in cfg.fpn_levels():
        logits = _split_anchor_axis(outputs["cls_logits"][lvl], a)
        labels = batch["labels"][lvl]
        bbox_pred = _split_anchor_axis(outputs["bbox_pred"][lvl], a)
        bbox_tgt = batch["bbox_targets"][lvl]
        fg_mask = batch["fg_mask"][lvl]

        if cfg.RETINANET.SOFTMAX:
            # SoftmaxFocalLoss path (retinanet_heads.py:295-305); the class
            # axis includes background at index 0
            from sad_tpu.ops.detectron_ops import softmax_focal_loss

            focal = jax.vmap(
                lambda x, t, s: softmax_focal_loss(
                    x, t, s,
                    cfg.RETINANET.LOSS_GAMMA, cfg.RETINANET.LOSS_ALPHA,
                    loss_scale,
                )
            )(_group_view(logits, n_groups), _group_view(labels, n_groups), fg_num)
        else:
            focal = jax.vmap(
                lambda x, t, s: sigmoid_focal_loss(
                    x, t, s,
                    cfg.RETINANET.LOSS_GAMMA, cfg.RETINANET.LOSS_ALPHA, loss_scale,
                )
            )(_group_view(logits, n_groups), _group_view(labels, n_groups), fg_num)
        bbox = jax.vmap(
            lambda p, t, m, s: select_smooth_l1_loss(
                p, t, m, s,
                cfg.RETINANET.BBOX_REG_BETA,
                loss_scale * cfg.RETINANET.BBOX_REG_WEIGHT,
            )
        )(
            _group_view(bbox_pred, n_groups),
            _group_view(bbox_tgt, n_groups),
            _group_view(fg_mask, n_groups),
            fg_num,
        )
        metrics[f"fl_fpn{lvl}"] = jnp.sum(focal)
        metrics[f"retnet_loss_bbox_fpn{lvl}"] = jnp.sum(bbox)
        total = total + jnp.sum(focal) + jnp.sum(bbox)
    return total, metrics


def distill_losses(
    cfg: Config,
    student_out: Dict[str, Dict[int, jnp.ndarray]],
    teacher_probs: Dict[int, jnp.ndarray],
    batch: Dict[str, Any],
    n_groups: int,
) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    """Adaptive distillation losses over all levels
    (ref: retinanet_heads.py:313-352)."""
    d = cfg.DISTILLATION
    a = cfg.num_anchors_per_cell()
    loss_scale = (1.0 / n_groups) * d.TEMPERATURE * d.TEMPERATURE
    metrics: Dict[str, jnp.ndarray] = {}
    total = jnp.float32(0.0)

    # normalizer: per-group PowSum over all levels' teacher probs, or fg count
    if d.ADAPTIVE_NORMALIZER:
        norms = jax.vmap(
            lambda *probs: pow_sum(probs, d.LOGITS_POWER)
        )(*[_group_view(teacher_probs[lvl], n_groups) for lvl in cfg.fpn_levels()])
        metrics["distill_normalizer"] = jnp.mean(norms)
    else:
        norms = batch["fg_num"]

    for lvl in cfg.fpn_levels():
        logits = _split_anchor_axis(student_out["cls_logits"][lvl], a)
        t_prob = _split_anchor_axis(teacher_probs[lvl], a)
        labels = batch["labels"][lvl]
        dl = jax.vmap(
            lambda x, tp, lb, nm: sigmoid_adaptive_distill_loss(
                x, tp, lb, nm,
                d.LOSS_GAMMA, d.LOSS_ALPHA, d.LOSS_BETA, d.IGNORED_LABEL,
                loss_scale,
            )
        )(
            _group_view(logits, n_groups),
            _group_view(t_prob, n_groups),
            _group_view(labels, n_groups),
            norms,
        )
        metrics[f"fl_distill_fpn{lvl}"] = jnp.sum(dl)
        total = total + jnp.sum(dl)
    return total, metrics


def make_train_step(
    cfg: Config,
    student_model: RetinaNet,
    teacher_model: Optional[RetinaNet] = None,
    n_groups: Optional[int] = None,
    teacher_cfg: Optional[Config] = None,
) -> Callable:
    """Build the jittable train step.

    Signature of the returned fn:
      step(state: TrainState, teacher_params|None, batch, lr) ->
        (new_state, metrics)
    Distillation is on iff teacher_model is not None.

    Batches carry either host-normalized f32 'data' (+ 'teacher_data'), or
    a shared raw uint8 canvas 'data_u8' + 'content_hw' that is normalized
    per stream ON DEVICE (ops/image_norm; 4-8x less H2D). teacher_cfg
    supplies the teacher's pixel normalization in u8 mode (the reference
    normalizes both streams on the host, minibatch.py:74-82).
    """
    solver = cfg.SOLVER

    def _stream_inputs(batch):
        if "data_u8" in batch:
            from sad_tpu.ops.image_norm import (
                content_mask,
                normalize_u8_on_device,
            )

            u8 = batch["data_u8"]
            mask = content_mask(u8.shape, batch["content_hw"])
            s_data = normalize_u8_on_device(
                u8, cfg.PIXEL_MEANS, cfg.PIXEL_DIV, cfg.PIXEL_STD, mask=mask
            )
            t_data = None
            if teacher_model is not None:
                tc = teacher_cfg if teacher_cfg is not None else cfg
                t_data = normalize_u8_on_device(
                    u8, tc.PIXEL_MEANS, tc.PIXEL_DIV, tc.PIXEL_STD, mask=mask
                )
            return s_data, t_data
        return batch["data"], batch.get("teacher_data")

    def step(state: TrainState, teacher_params, batch, lr):
        G = n_groups if n_groups is not None else batch["fg_num"].shape[0]
        s_data, t_data = _stream_inputs(batch)

        teacher_probs = None
        if teacher_model is not None:
            t_out = teacher_model.apply({"params": teacher_params}, t_data)
            teacher_probs = {
                lvl: jax.lax.stop_gradient(p) for lvl, p in t_out["cls_prob"].items()
            }

        def loss_fn(params):
            out = student_model.apply({"params": params}, s_data)
            total, metrics = retinanet_losses(cfg, out, batch, G)
            if teacher_probs is not None:
                d_total, d_metrics = distill_losses(
                    cfg, out, teacher_probs, batch, G
                )
                total = total + d_total
                metrics.update(d_metrics)
            metrics["loss"] = total
            return total, metrics

        grads, metrics = jax.grad(loss_fn, has_aux=True)(state.params)
        t_mask = trainable_mask(
            state.params, cfg.TRAIN.FREEZE_AT, cfg.TRAIN.FREEZE_CONV_BODY
        )
        b_mask = bias_mask(state.params)
        new_params, new_momentum = momentum_sgd_update(
            state.params,
            grads,
            MomentumSGDState(velocity=state.velocity),
            lr,
            momentum=solver.MOMENTUM,
            weight_decay=solver.WEIGHT_DECAY,
            trainable=t_mask,
            is_bias=b_mask,
        )
        metrics["retnet_fg_num"] = jnp.sum(batch["fg_num"])
        return TrainState(new_params, new_momentum.velocity), metrics

    return step
