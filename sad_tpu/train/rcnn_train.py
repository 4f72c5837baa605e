"""Faster/Mask R-CNN end-to-end training step.

Capability-equivalent to the reference's generalized_rcnn training graph
(model_builder.py:74-92 + rpn_heads.py/FPN.py RPN losses +
fast_rcnn_heads.py losses + the GenerateProposalLabels Python op), as one
jitted function: backbone -> RPN losses -> on-device proposal generation ->
on-device fg/bg sampling (sad_tpu.ops.proposals.sample_proposal_labels) ->
multilevel RoIAlign -> box head losses -> momentum SGD.

Loss wiring preserved (all group-exact: the reference's per-GPU losses
scaled 1/NUM_GPUS + gradient allreduce-SUM = average of per-GPU terms;
see each loss function's docstring):
- RPN cls: sum sigmoid-CE over sampled anchors / (RPN_BATCH_SIZE_PER_IM *
  total images) (FPN.py:410-418),
- RPN bbox: SmoothL1 with inside/outside weights, beta=1/9, /dim0
  (FPN.py:422-431),
- box head: softmax CE per-group mean over sampled RoIs + SmoothL1 with
  class-specific weights (fast_rcnn_heads.py add_fast_rcnn_losses).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from sad_tpu.config import Config
from sad_tpu.models import bias_mask, trainable_mask
from sad_tpu.ops.losses import smooth_l1_loss
from sad_tpu.ops.proposals import (
    collect_and_distribute_fpn_proposals,
    multilevel_roi_align,
    sample_proposal_labels,
    sampled_fg_cap,
)

from .optimizer import MomentumSGDState, momentum_sgd_update
from .train_step import TrainState

from sad_tpu.data.anchors import field_of_anchors, generate_cell_anchors
import numpy as np


def _rfcn_targets(sampled, r):
    """cls-agnostic (R, 8) targets: fg class targets collapse to column 4:8
    (box_annotator/rfcn convention: [bg 4, fg 4])."""
    t = sampled["bbox_targets"].reshape(r, -1, 4)
    w = sampled["bbox_inside_weights"].reshape(r, -1, 4)
    fg_t = (t * w).sum(axis=1)  # the one active class row
    return jnp.concatenate([jnp.zeros_like(fg_t), fg_t], axis=1)


def _rfcn_weights(sampled, r):
    w = sampled["bbox_inside_weights"].reshape(r, -1, 4)
    fg_w = (w.sum(axis=1) > 0).astype(jnp.float32)
    return jnp.concatenate([jnp.zeros_like(fg_w), fg_w], axis=1)

FLT_MIN = 1.1754944e-38


def rpn_losses(cfg: Config, logits, deltas, batch, n_groups: int):
    """Per-level RPN losses (FPN.py:391-431).

    Reference totals after the 1/NUM_GPUS loss scale and the gradient
    allreduce-SUM: cls = sum_ce / (NUM_GPUS * RPN_BATCH_SIZE_PER_IM *
    IMS_PER_BATCH) and bbox = sum_sl1 / (NUM_GPUS * IMS_PER_BATCH) — both
    denominators are static, so the batch-global forms below (B = total
    images = n_groups * IMS_PER_BATCH) are exactly equivalent.
    """
    del n_groups  # denominators are static; global forms are group-exact
    metrics = {}
    total = jnp.float32(0.0)
    for lvl in sorted(logits):
        x = logits[lvl].astype(jnp.float32)
        t = batch["rpn_labels"][lvl]
        # sum-CE with -1 ignored (SigmoidCrossEntropyLoss normalize=0)
        ge = (x >= 0).astype(jnp.float32)
        tf = t.astype(jnp.float32)
        ce = (-x * (tf - ge) + jnp.log(1.0 + jnp.exp(x - 2.0 * x * ge)))
        ce = jnp.where(t == -1, 0.0, ce)
        cls = (
            jnp.sum(ce, dtype=jnp.float32)
            / (cfg.TRAIN.RPN_BATCH_SIZE_PER_IM * x.shape[0])
        )
        a = t.shape[-1]
        d = deltas[lvl].reshape(deltas[lvl].shape[:-1] + (a, 4))
        # smooth_l1_loss divides by dim0 = B; the reference's SmoothL1Loss
        # divides by its per-GPU dim0 = IMS_PER_BATCH and scales 1/NUM_GPUS
        bbox = smooth_l1_loss(
            d,
            batch["rpn_bbox_targets"][lvl],
            batch["rpn_bbox_inside_weights"][lvl],
            batch["rpn_bbox_outside_weights"][lvl],
            beta=1.0 / 9.0,
            scale=1.0,
        )
        metrics[f"loss_rpn_cls_fpn{lvl}"] = cls
        metrics[f"loss_rpn_bbox_fpn{lvl}"] = bbox
        total = total + cls + bbox
    return total, metrics


def fast_rcnn_losses(cfg: Config, cls_score, labels, bbox_pred, bbox_targets,
                     inside_w, outside_w, valid, n_groups: int,
                     n_images: int = 0):
    """Box-head losses (fast_rcnn_heads.py add_fast_rcnn_losses):
    SoftmaxWithLoss (mean over RoIs) + SmoothL1Loss.

    With cfg.TRAIN.OHEM (fast_rcnn_heads.py:70-109): per-RoI cls+bbox losses
    rank the RoIs per image, only the hardest TRAIN.OHEM_ROI_PER_IMG keep a
    weight of 1, and the reduced losses use those weights (static shapes: 0/1
    weights instead of the reference's label surgery).

    Group semantics: the reference computes per-GPU means scaled by
    1/NUM_GPUS and the allreduce SUMS gradients, so the effective total is
    the AVERAGE of per-GPU means. cls uses per-group dynamic counts
    (rows are n_groups consecutive blocks); bbox's SmoothL1Loss denominator
    is its static dim0, so the batch-global form is exactly equivalent.
    bbox is additionally scaled by MODEL.BBOX_REG_WEIGHT_SCALE
    (detector.py GetBBoxLossScale)."""
    logp = jax.nn.log_softmax(cls_score.astype(jnp.float32), axis=-1)
    t = jnp.maximum(labels, 0)
    nll = -jnp.take_along_axis(logp, t[:, None], axis=-1)[:, 0]
    live = valid & (labels >= 0)
    nll = jnp.where(live, nll, 0.0)

    if cfg.TRAIN.OHEM and n_images:
        from sad_tpu.ops.detectron_ops import smooth_l1_loss_per_roi

        per_box = smooth_l1_loss_per_roi(
            bbox_pred, bbox_targets, inside_w, outside_w
        )
        per_total = jnp.where(live, nll + per_box, -1.0)  # padding ranks last
        k = min(cfg.TRAIN.OHEM_ROI_PER_IMG, per_total.size // n_images)

        def keep_one(row):
            thresh = jax.lax.top_k(row, k)[0][-1]
            rank = jnp.argsort(jnp.argsort(-row))
            return ((row >= thresh) & (rank < k)).astype(jnp.float32)

        keep = jax.vmap(keep_one)(
            per_total.reshape(n_images, -1)
        ).reshape(-1)
        keep = keep * live.astype(jnp.float32)
        # per-group weighted means, averaged (the reference's per-GPU
        # SoftmaxWithLoss-with-weights x 1/G + allreduce-SUM). Counts are
        # usually equal (top-k keeps exactly OHEM_ROI_PER_IMG per image)
        # but `keep * live` can shrink a group when an image has fewer
        # live rois than k, so compute per-group like the plain path.
        keep_sum_g = jnp.sum(
            (nll * keep).reshape(n_groups, -1), axis=1, dtype=jnp.float32
        )
        keep_cnt_g = jnp.maximum(
            jnp.sum(keep.reshape(n_groups, -1), axis=1), 1.0
        )
        cls_loss = jnp.sum(keep_sum_g / keep_cnt_g) / n_groups
        bbox_loss = smooth_l1_loss(
            bbox_pred, bbox_targets, inside_w, outside_w * keep[:, None],
            beta=1.0, scale=cfg.MODEL.BBOX_REG_WEIGHT_SCALE,
        )
        accuracy = jnp.sum(
            ((jnp.argmax(cls_score, -1) == labels) & valid).astype(jnp.float32)
        ) / jnp.maximum(jnp.sum(live.astype(jnp.float32)), 1.0)
        return cls_loss + bbox_loss, {
            "loss_cls": cls_loss,
            "loss_bbox": bbox_loss,
            "accuracy_cls": accuracy,
        }

    live_f = live.astype(jnp.float32)
    n_valid = jnp.maximum(jnp.sum(live_f), 1.0)
    # per-group mean (nll is already zeroed at non-live rows), then average
    # over groups — the reference's Σ_g (1/G)·mean_g exactly
    sum_g = jnp.sum(nll.reshape(n_groups, -1), axis=1, dtype=jnp.float32)
    cnt_g = jnp.maximum(jnp.sum(live_f.reshape(n_groups, -1), axis=1), 1.0)
    cls_loss = jnp.sum(sum_g / cnt_g) / n_groups

    # SmoothL1Loss normalizes by its static dim0, so per-GPU-mean x 1/G
    # collapses exactly to the batch-global mean over dim0 (R)
    bbox_loss = smooth_l1_loss(
        bbox_pred, bbox_targets, inside_w, outside_w, beta=1.0,
        scale=cfg.MODEL.BBOX_REG_WEIGHT_SCALE,
    )
    accuracy = jnp.sum(
        ((jnp.argmax(cls_score, -1) == labels) & valid).astype(jnp.float32)
    ) / n_valid
    return cls_loss + bbox_loss, {
        "loss_cls": cls_loss,
        "loss_bbox": bbox_loss,
        "accuracy_cls": accuracy,
    }


def make_rcnn_train_step(
    cfg: Config, model, n_groups: Optional[int] = None
) -> Callable:
    """step(state, batch, lr, rng) -> (new_state, metrics).

    Batch pytree (host loader + rpn_minibatch.add_rpn_blobs_to_batch):
      data (B,H,W,3), im_hw (B,2),
      rpn_labels/bbox_targets/inside/outside per level,
      gt_boxes (B,G,4), gt_classes (B,G).
    """
    solver = cfg.SOLVER
    is_fpn = cfg.FPN.FPN_ON and cfg.FPN.MULTILEVEL_RPN
    rpn_levels = tuple(range(cfg.FPN.RPN_MIN_LEVEL, cfg.FPN.RPN_MAX_LEVEL + 1))
    roi_levels = tuple(range(cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL + 1))
    ss_level = int(np.log2(cfg.RPN.STRIDE))

    def _sample(rng_i, boxes, valid, gt_boxes, gt_classes):
        return sample_proposal_labels(
            rng_i, boxes, valid, gt_boxes, gt_classes,
            cfg.TRAIN.BATCH_SIZE_PER_IM, cfg.TRAIN.FG_FRACTION,
            cfg.TRAIN.FG_THRESH, cfg.TRAIN.BG_THRESH_HI,
            cfg.TRAIN.BG_THRESH_LO, cfg.MODEL.NUM_CLASSES,
            cfg.MODEL.BBOX_REG_WEIGHTS,
        )

    def step(state: TrainState, batch, lr, rng):
        G = n_groups or cfg.NUM_GPUS

        # pure Fast R-CNN: sample from precomputed proposals (selective
        # search / RPN-stage files, ref roi_data/fast_rcnn.py via
        # GenerateProposalLabels on entry['boxes']); RPN head + losses are
        # skipped entirely
        precomputed = (
            not cfg.MODEL.FASTER_RCNN and "proposal_boxes" in batch
        )

        def loss_fn(params):
            b = batch["data"].shape[0]
            if is_fpn:
                feats = model.apply(
                    {"params": params}, batch["data"], method="backbone"
                )
            else:
                # single-scale (VGG/C4/R-FCN) path: one feature map at
                # RPN.STRIDE (rpn_heads.py:55-123)
                feat = model.apply(
                    {"params": params}, batch["data"], method="backbone"
                )
            if precomputed:
                total = jnp.float32(0.0)
                metrics = {}
            else:
                if is_fpn:
                    rpn_feats = {l: feats[l] for l in rpn_levels if l in feats}
                    logits, deltas = model.apply(
                        {"params": params}, rpn_feats,
                        method=lambda m, f: m.rpn(f),
                    )
                else:
                    ss_logits, ss_deltas = model.apply(
                        {"params": params}, feat, method="rpn_forward"
                    )
                    logits = {ss_level: ss_logits}
                    deltas = {ss_level: ss_deltas}
                total, metrics = rpn_losses(cfg, logits, deltas, batch, G)

            rngs = jax.random.split(rng, b)
            if precomputed:
                sampled = jax.vmap(
                    lambda bx, va, gb, gc, ri: _sample(ri, bx, va, gb, gc)
                )(
                    batch["proposal_boxes"], batch["proposal_valid"],
                    batch["gt_boxes"], batch["gt_classes"], rngs,
                )
            else:
                # ---- proposals (train-mode top-Ns) + on-device sampling.
                # Candidates are built per (level, image) under vmap; the
                # greedy NMS over ALL (level x image) problems happens in ONE
                # call (ops/nms.greedy_nms) — identical per-problem results.
                from sad_tpu.ops.proposals import (
                    nms_levels_batched,
                    proposal_candidates,
                )

                def _candidates_all_images(logits_lvl, deltas_lvl, cell, stride):
                    h, w = logits_lvl.shape[1:3]
                    na = logits_lvl.shape[-1]
                    anchors = jnp.asarray(
                        field_of_anchors(cell, stride, h, w), jnp.float32
                    )
                    scores = jax.nn.sigmoid(jax.lax.stop_gradient(logits_lvl))
                    d = jax.lax.stop_gradient(
                        deltas_lvl.reshape(b, h, w, na, 4)
                    )
                    return jax.vmap(
                        lambda s, dd, ihw: proposal_candidates(
                            s, dd, anchors, ihw,
                            cfg.TRAIN.RPN_PRE_NMS_TOP_N,
                            float(cfg.TRAIN.RPN_MIN_SIZE),
                            exact_topk=cfg.RPN.EXACT_TOPK,
                        )
                    )(scores, d, batch["im_hw"])  # (B,k,4), (B,k), (B,k)

                prop_levels = []
                if not is_fpn:
                    stride = float(cfg.RPN.STRIDE)
                    cell = np.concatenate(
                        [
                            generate_cell_anchors(stride, (s,), (ar,))
                            for s in cfg.RPN.SIZES
                            for ar in cfg.RPN.ASPECT_RATIOS
                        ]
                    )
                    prop_levels.append(
                        (ss_level,)
                        + _candidates_all_images(
                            logits[ss_level], deltas[ss_level], cell, stride
                        )
                    )
                else:
                    for lvl in rpn_feats:
                        stride = 2.0 ** lvl
                        size = cfg.FPN.RPN_ANCHOR_START_SIZE * (
                            2 ** (lvl - cfg.FPN.RPN_MIN_LEVEL)
                        )
                        cell = np.concatenate(
                            [
                                generate_cell_anchors(stride, (size,), (ar,))
                                for ar in cfg.FPN.RPN_ASPECT_RATIOS
                            ]
                        )
                        prop_levels.append(
                            (lvl,)
                            + _candidates_all_images(
                                logits[lvl], deltas[lvl], cell, stride
                            )
                        )

                lv_b, lv_s, lv_v = nms_levels_batched(
                    prop_levels,
                    cfg.TRAIN.RPN_NMS_THRESH, cfg.TRAIN.RPN_POST_NMS_TOP_N,
                )

                if not is_fpn:
                    sampled = jax.vmap(
                        lambda bx, va, gb, gc, ri: _sample(ri, bx, va, gb, gc)
                    )(
                        lv_b[ss_level], lv_v[ss_level],
                        batch["gt_boxes"], batch["gt_classes"], rngs,
                    )
                else:
                    def per_image(lvb, lvs, lvv, gb, gc, ri):
                        boxes, _scores, valid, _ = (
                            collect_and_distribute_fpn_proposals(
                                lvb, lvs, lvv,
                                cfg.TRAIN.RPN_POST_NMS_TOP_N,
                                cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
                            )
                        )
                        return _sample(ri, boxes, valid, gb, gc)

                    sampled = jax.vmap(per_image)(
                        lv_b, lv_s, lv_v,
                        batch["gt_boxes"], batch["gt_classes"], rngs,
                    )

            r = sampled["rois"].shape[1]
            batch_col = jnp.repeat(jnp.arange(b, dtype=jnp.float32), r)[:, None]
            flat_rois = jnp.concatenate(
                [batch_col, sampled["rois"].reshape(-1, 4)], axis=1
            )
            if not is_fpn:
                ss_mask_on = (
                    cfg.MODEL.MASK_ON and cfg.MODEL.TYPE != "rfcn"
                    and "gt_mask_rasters" in batch
                )
                ss_share = ss_mask_on and "v0upshare" in cfg.MRCNN.ROI_MASK_HEAD
                if ss_share:
                    # v0upshare: reuse the box branch's res5 RoI features for
                    # the mask head (ref: mask_rcnn_heads.py:173-213)
                    cls_score, bbox_pred, res5_sp = model.apply(
                        {"params": params}, feat, flat_rois, True,
                        method="box_forward",
                    )
                else:
                    cls_score, bbox_pred = model.apply(
                        {"params": params}, feat, flat_rois,
                        method="box_forward",
                    )
                r_rois = cls_score.shape[0]
                if cfg.MODEL.TYPE == "rfcn":
                    # R-FCN bbox head is cls-agnostic (R, 8): [bg 4, fg 4]
                    tgt = _rfcn_targets(sampled, r_rois)
                    in_w = out_w = _rfcn_weights(sampled, r_rois)
                else:
                    tgt = sampled["bbox_targets"].reshape(r_rois, -1)
                    in_w = sampled["bbox_inside_weights"].reshape(r_rois, -1)
                    out_w = sampled["bbox_outside_weights"].reshape(r_rois, -1)
                box_total, box_metrics = fast_rcnn_losses(
                    cfg, cls_score, sampled["labels"].reshape(-1),
                    bbox_pred, tgt, in_w, out_w,
                    sampled["valid"].reshape(-1), G, n_images=b,
                )
                total = total + box_total
                metrics.update(box_metrics)
                if ss_mask_on:
                    # C4 mask heads (v0upshare shares the box res5; v0up
                    # recomputes its own res5 on the mask RoIs). As in the
                    # FPN path, only the leading fg_cap slots per image can
                    # be fg, so the mask head runs on that slice (reference
                    # semantics: mask targets are fg-only).
                    from .mask_keypoint import mask_loss, mask_targets_on_device

                    fg_cap = sampled_fg_cap(
                        cfg.TRAIN.BATCH_SIZE_PER_IM, cfg.TRAIN.FG_FRACTION
                    )
                    fg_is_fg = sampled["is_fg"][:, :fg_cap].reshape(-1)
                    fg_labels = sampled["labels"][:, :fg_cap].reshape(-1)
                    if ss_share:
                        rr = res5_sp.shape[0] // b
                        res5_fg = res5_sp.reshape(
                            (b, rr) + res5_sp.shape[1:]
                        )[:, :fg_cap].reshape(
                            (b * fg_cap,) + res5_sp.shape[1:]
                        )
                        mlogits = model.apply(
                            {"params": params}, res5_fg,
                            method="mask_from_res5",
                        )
                    else:
                        fg_col = jnp.repeat(
                            jnp.arange(b, dtype=jnp.float32), fg_cap
                        )[:, None]
                        flat_fg_rois = jnp.concatenate(
                            [fg_col,
                             sampled["rois"][:, :fg_cap].reshape(-1, 4)],
                            axis=1,
                        )
                        mlogits = model.apply(
                            {"params": params}, feat, flat_fg_rois,
                            method="mask_heads",
                        )
                    m_res = mlogits.shape[1]

                    def ss_mask_tgt(i):
                        return mask_targets_on_device(
                            batch["gt_mask_rasters"][i],
                            sampled["rois"][i, :fg_cap],
                            sampled["matched_gt"][i, :fg_cap],
                            m_res,
                            batch["gt_mask_stride"],
                        )

                    mtargets = jax.vmap(ss_mask_tgt)(jnp.arange(b)).reshape(
                        (-1, m_res, m_res)
                    )
                    ml = mask_loss(
                        cfg, mlogits, mtargets, fg_labels, fg_is_fg, G,
                    )
                    total = total + ml
                    metrics["loss_mask"] = ml
                metrics["loss"] = total
                return total, metrics
            from sad_tpu.ops.proposals import map_rois_to_fpn_levels

            lvls = map_rois_to_fpn_levels(
                flat_rois[:, 1:], cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
                cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL,
            )
            roi_feat_maps = {l: feats[l] for l in roi_levels if l in feats}
            roi_feats = multilevel_roi_align(
                roi_feat_maps,
                flat_rois,
                lvls,
                sampled["valid"].reshape(-1),
                cfg.FAST_RCNN.ROI_XFORM_RESOLUTION,
                cfg.FAST_RCNN.ROI_XFORM_SAMPLING_RATIO,
                slots_per_im=r,  # flat_rois is image-major by construction
            )
            cls_score, bbox_pred = model.apply(
                {"params": params}, roi_feats,
                method=lambda m, f: m.box_head(f),
            )
            # ---- mask / keypoint heads on the fg-sampled rois.
            # sample_proposal_labels sorts kept-fg rois into the leading
            # slots (priority 2+u > bg 1+u > demoted fg 0.5), so the first
            # fg_cap slots per image provably contain every fg roi; the
            # aux heads run only on that slice — the reference computes
            # mask/keypoint targets for fg rois only (roi_data/
            # mask_rcnn.py:38-52) — which cuts the aux RoIAlign + head
            # work 1/FG_FRACTION-fold at identical loss values (non-fg
            # slots carry zero weight in both losses).
            aux_total = jnp.float32(0.0)
            aux_metrics = {}
            box_fg_cap = sampled_fg_cap(
                cfg.TRAIN.BATCH_SIZE_PER_IM, cfg.TRAIN.FG_FRACTION
            )
            # Static aux-branch RoI slot counts (MRCNN/KRCNN.ROI_SLOTS_PER_IM,
            # a static-shape extension): the default (-1) pays the
            # reference's WORST CASE — box_fg_cap slots per image, 128 at
            # reference settings — every step, where the reference's dynamic
            # shapes pay only the actual fg count. Aux cost is linear in
            # these caps; fg rois beyond a cap keep box
            # supervision but get no mask/keypoint loss.
            def _aux_cap(knob):
                return box_fg_cap if knob <= 0 else min(knob, box_fg_cap)

            mask_cap = _aux_cap(cfg.MRCNN.ROI_SLOTS_PER_IM)
            kp_cap = _aux_cap(cfg.KRCNN.ROI_SLOTS_PER_IM)
            need_aux = (
                (cfg.MODEL.MASK_ON and "gt_mask_rasters" in batch)
                or (cfg.MODEL.KEYPOINTS_ON and "gt_keypoints" in batch)
            )
            if need_aux:
                # shared prep at the larger cap; each branch slices its
                # prefix (fg slots are priority-sorted, so a prefix slice is
                # exactly "the first-k fg rois")
                fg_cap = max(
                    mask_cap if cfg.MODEL.MASK_ON else 1,
                    kp_cap if cfg.MODEL.KEYPOINTS_ON else 1,
                )
                fg_rois = sampled["rois"][:, :fg_cap]
                fg_is_fg = sampled["is_fg"][:, :fg_cap].reshape(-1)
                fg_labels = sampled["labels"][:, :fg_cap].reshape(-1)
                fg_col = jnp.repeat(
                    jnp.arange(b, dtype=jnp.float32), fg_cap
                )[:, None]
                flat_fg_rois = jnp.concatenate(
                    [fg_col, fg_rois.reshape(-1, 4)], axis=1
                )
                fg_lvls = map_rois_to_fpn_levels(
                    flat_fg_rois[:, 1:],
                    cfg.FPN.ROI_MIN_LEVEL, cfg.FPN.ROI_MAX_LEVEL,
                    cfg.FPN.ROI_CANONICAL_SCALE, cfg.FPN.ROI_CANONICAL_LEVEL,
                )

                def _branch_slice(cap):
                    """Per-branch prefix views at this branch's cap."""
                    if cap == fg_cap:
                        return flat_fg_rois, fg_lvls, fg_is_fg, fg_labels
                    sel = (
                        jnp.arange(b)[:, None] * fg_cap + jnp.arange(cap)
                    ).reshape(-1)
                    return (
                        flat_fg_rois[sel], fg_lvls[sel], fg_is_fg[sel],
                        fg_labels[sel],
                    )
            if cfg.MODEL.MASK_ON and "gt_mask_rasters" in batch:
                from .mask_keypoint import mask_loss, mask_targets_on_device

                m_rois, m_lvls, m_is_fg, m_labels = _branch_slice(mask_cap)
                mfeats = multilevel_roi_align(
                    roi_feat_maps,
                    m_rois, m_lvls, m_is_fg,
                    cfg.MRCNN.ROI_XFORM_RESOLUTION,
                    cfg.MRCNN.ROI_XFORM_SAMPLING_RATIO,
                    slots_per_im=mask_cap,  # _branch_slice is image-major
                )
                mlogits = model.apply(
                    {"params": params}, mfeats,
                    method=lambda m, f: m.mask_head(f),
                )
                def mask_tgt(i):
                    return mask_targets_on_device(
                        batch["gt_mask_rasters"][i],
                        sampled["rois"][i, :mask_cap],
                        sampled["matched_gt"][i, :mask_cap],
                        cfg.MRCNN.RESOLUTION,
                        batch["gt_mask_stride"],
                    )
                mtargets = jax.vmap(mask_tgt)(jnp.arange(b)).reshape(
                    (-1,) + (cfg.MRCNN.RESOLUTION,) * 2
                )
                # logits are at 2x the RoI xform res (deconv); targets match
                # MRCNN.RESOLUTION by construction
                ml = mask_loss(
                    cfg, mlogits, mtargets, m_labels, m_is_fg, G,
                )
                aux_total = aux_total + ml
                aux_metrics["loss_mask"] = ml
            if cfg.MODEL.KEYPOINTS_ON and "gt_keypoints" in batch:
                from .mask_keypoint import keypoint_loss, keypoint_targets_on_device

                k_rois, k_lvls, k_is_fg, _k_labels = _branch_slice(kp_cap)
                kfeats = multilevel_roi_align(
                    roi_feat_maps,
                    k_rois, k_lvls, k_is_fg,
                    cfg.KRCNN.ROI_XFORM_RESOLUTION,
                    cfg.KRCNN.ROI_XFORM_SAMPLING_RATIO,
                    slots_per_im=kp_cap,  # _branch_slice is image-major
                )
                klogits = model.apply(
                    {"params": params}, kfeats,
                    method=lambda m, f: m.kps_head(f),
                )
                s_hm = klogits.shape[1]
                def kp_tgt(i):
                    return keypoint_targets_on_device(
                        batch["gt_keypoints"][i],
                        sampled["rois"][i, :kp_cap],
                        sampled["matched_gt"][i, :kp_cap],
                        s_hm,
                    )
                hl, hv = jax.vmap(kp_tgt)(jnp.arange(b))
                kl = keypoint_loss(
                    cfg, klogits,
                    hl.reshape(-1, hl.shape[-1]),
                    hv.reshape(-1, hv.shape[-1]),
                    k_is_fg, G, n_images=b,
                )
                aux_total = aux_total + kl
                aux_metrics["loss_kps"] = kl

            box_total, box_metrics = fast_rcnn_losses(
                cfg,
                cls_score,
                sampled["labels"].reshape(-1),
                bbox_pred,
                sampled["bbox_targets"].reshape(cls_score.shape[0], -1),
                sampled["bbox_inside_weights"].reshape(cls_score.shape[0], -1),
                sampled["bbox_outside_weights"].reshape(cls_score.shape[0], -1),
                sampled["valid"].reshape(-1),
                G,
                n_images=b,
            )
            total = total + box_total + aux_total
            metrics.update(box_metrics)
            metrics.update(aux_metrics)
            metrics["loss"] = total
            return total, metrics

        grads, metrics = jax.grad(loss_fn, has_aux=True)(state.params)
        t_mask = trainable_mask(
            state.params, cfg.TRAIN.FREEZE_AT, cfg.TRAIN.FREEZE_CONV_BODY
        )
        b_mask = bias_mask(state.params)
        new_params, new_mom = momentum_sgd_update(
            state.params, grads, MomentumSGDState(state.velocity), lr,
            momentum=solver.MOMENTUM, weight_decay=solver.WEIGHT_DECAY,
            trainable=t_mask, is_bias=b_mask,
        )
        return TrainState(new_params, new_mom.velocity), metrics

    return step
