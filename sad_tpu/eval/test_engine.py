"""Dataset inference engine + pseudo-label generation.

Capability-equivalent to detectron/lib/core/test_engine.py:51-261 and the
semi-supervised pseudo-label flow (SURVEY.md §3.4), redesigned:

- the reference loops one image at a time on the host and shards a dataset
  across GPU subprocesses (test_engine.py:115-153, subprocess.py:39); here
  images are batched onto fixed canvases and decoded fully on device — one
  jitted program per canvas orientation, N images per call. Multi-chip
  inference = shard the batch over the mesh 'data' axis, not subprocesses.
- detections come back as fixed (N, 100) arrays and are converted to
  COCO-format dicts for evaluation (json_dataset_evaluator equivalent in
  sad_tpu.eval.coco_eval).
- `generate_pseudo_labels` writes a COCO-format annotation json from teacher
  detections over an unlabeled dataset — the reference reuses test_net with
  TEST.DATASETS=('coco_2017_unlabel',) and distributes pre-made jsons
  (dataset_catalog.py:201-218); here it is a first-class API.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sad_tpu.config import Config
from sad_tpu.data.dataset import CocoDataset
from sad_tpu.data.minibatch import (
    canvas_shapes,
    compute_im_scale,
    load_image_bgr,
    prep_image,
)
from sad_tpu.models import RetinaNet
from sad_tpu.utils.logging import setup_logging
from sad_tpu.utils.timer import Timer

from .coco_eval import COCOEvaluator
from .inference import make_inference_fn

logger = setup_logging(__name__)


def _test_canvas_shapes(cfg: Config):
    cs = cfg.FPN.COARSEST_STRIDE
    short = int(cs * np.ceil(max(cfg.TEST.SCALES) / float(cs)))
    long = int(cs * np.ceil(cfg.TEST.MAX_SIZE / float(cs)))
    long = max(long, short)
    return (short, long), (long, short)


def prepare_test_batch(
    cfg: Config,
    entries: List[dict],
    canvas,
    target_scale: int = 0,
    target_max_size: int = 0,
    hflip: bool = False,
    as_uint8: bool = False,
) -> Dict:
    """Images on the static canvas. target_scale/max_size override
    TEST.SCALES[0]/MAX_SIZE for TTA passes (clamped so the content still
    fits the canvas); hflip mirrors the CONTENT (not the canvas), so net
    coords stay within the im_hw extent.

    as_uint8=True ships raw uint8 canvases + per-image content extents
    ('content_hw'); the jitted inference normalizes on device
    (eval/inference.device_normalize) — 4x less host->device traffic,
    bit-identical results."""
    ch, cw = canvas
    n = len(entries)
    data = np.zeros((n, ch, cw, 3), np.uint8 if as_uint8 else np.float32)
    im_hw = np.zeros((n, 2), np.float32)
    content_hw = np.zeros((n, 2), np.float32)
    scales = np.zeros((n,), np.float32)
    for i, e in enumerate(entries):
        im_bgr = load_image_bgr(e["image"], False)
        scale = compute_im_scale(
            e["height"], e["width"],
            target_scale or cfg.TEST.SCALES[0],
            target_max_size or cfg.TEST.MAX_SIZE,
        )
        scale = min(scale, ch / float(e["height"]), cw / float(e["width"]))
        if as_uint8:
            from sad_tpu.data.minibatch import resize_bgr_u8

            im = resize_bgr_u8(im_bgr, scale)
        else:
            im = prep_image(
                im_bgr, scale, cfg.PIXEL_MEANS, cfg.PIXEL_DIV, cfg.PIXEL_STD
            )
        if hflip:
            im = im[:, ::-1]
        h, w = im.shape[:2]
        data[i, :h, :w] = im
        im_hw[i] = (e["height"], e["width"])
        content_hw[i] = (h, w)
        scales[i] = scale
    return {
        "data": data, "im_hw": im_hw, "im_scale": scales,
        "content_hw": content_hw,
    }


def _make_infer_fn(cfg: Config, model):
    """Dispatch by model type (ref: im_detect_all branching, test.py:52-58)."""
    if cfg.MODEL.TYPE in ("generalized_rcnn", "rpn"):
        from .rcnn_inference import make_rcnn_inference_fn

        fn = make_rcnn_inference_fn(cfg, model)

        def infer(params, data, im_hw, im_scale, content_hw=None,
                  proposals=None, prop_valid=None):
            if proposals is not None:
                return fn(params, data, im_hw, im_scale, content_hw,
                          proposals, prop_valid)
            return fn(params, data, im_hw, im_scale, content_hw)

        return infer
    return make_inference_fn(cfg, model)


def run_inference_on_roidb(
    cfg: Config,
    model,
    params,
    roidb: List[dict],
    contiguous_to_json: Dict[int, int],
    batch_size: int = 8,
    vis_dir: Optional[str] = None,
) -> List[Dict]:
    """Returns COCO-format detection dicts for every image.

    Test-time augmentation (ref: test.py im_detect_bbox_aug:195-276,
    im_detect_mask_aug:410-478, im_detect_keypoints_aug:582-665): with
    TEST.BBOX_AUG.ENABLED the box pass runs once per transform, candidates
    are UNION-merged per image and re-NMSed on the host; with
    TEST.MASK_AUG/KPS_AUG.ENABLED the mask/keypoint heads re-run per
    transform on the final boxes and the soft outputs are combined by the
    configured heuristic."""
    if cfg.KRCNN.KEYPOINT_CONFIDENCE not in ("bbox", "logit", "prob"):
        # fail before inference, not on the first emitted detection
        raise ValueError(
            "KRCNN.KEYPOINT_CONFIDENCE must be 'logit', 'prob', or "
            f"'bbox'; got {cfg.KRCNN.KEYPOINT_CONFIDENCE!r}"
        )
    infer = _make_infer_fn(cfg, model)
    is_rcnn = cfg.MODEL.TYPE == "generalized_rcnn"
    # pure Fast R-CNN: precomputed proposals attached to the roidb
    # (ref: test.py im_detect_all passes entry['boxes'] when not FASTER_RCNN)
    precomputed = (
        is_rcnn and not cfg.MODEL.FASTER_RCNN
        and any("proposal_boxes" in e for e in roidb)
    )
    prop_cap = max(cfg.TEST.PROPOSAL_LIMIT, 1)
    bbox_aug = cfg.TEST.BBOX_AUG.ENABLED and is_rcnn
    mask_aug = cfg.MODEL.MASK_ON and cfg.TEST.MASK_AUG.ENABLED and is_rcnn
    kps_aug = (
        cfg.MODEL.KEYPOINTS_ON and cfg.TEST.KPS_AUG.ENABLED
        and is_rcnn and cfg.FPN.FPN_ON
    )
    aux_fn = None
    if bbox_aug or mask_aug or kps_aug:
        from .test_augmentation import (
            aux_aug_transforms,
            bbox_aug_transforms,
            combine_heatmaps,
            combine_soft_masks,
            flip_heatmaps,
            flip_mask_probs,
            merge_aug_detections,
            postprocess_detections,
        )

        if cfg.MODEL.MASK_ON or cfg.MODEL.KEYPOINTS_ON:
            from .rcnn_inference import make_aux_on_boxes_fn

            aux_fn = make_aux_on_boxes_fn(cfg, model)

    def _flip_boxes_imframe(bx, entries_):
        """flip_boxes in image coords (ref: boxes.py flip_boxes)."""
        out_ = bx.copy()
        for j_, e_ in enumerate(entries_):
            w_ = float(e_["width"])
            x1 = bx[j_, :, 0].copy()
            x2 = bx[j_, :, 2].copy()
            out_[j_, :, 0] = w_ - x2 - 1.0
            out_[j_, :, 2] = w_ - x1 - 1.0
        return out_

    # multi-chip inference: shard the image batch over the mesh 'data' axis
    # (replacing the reference's per-GPU subprocess sharding,
    # test_engine.py:115-153 + subprocess.py:39). XLA partitions the jitted
    # program; params are replicated by sharding.
    mesh = None
    if jax.device_count() > 1 and batch_size % jax.device_count() == 0:
        from sad_tpu.parallel import create_mesh
        from sad_tpu.parallel.mesh import replicated_sharding, shard_batch_tree

        mesh = create_mesh()
        params = jax.device_put(params, replicated_sharding(mesh))
        logger.info("inference over mesh %s", mesh)

    def _put(host):
        arrs = {k: jnp.asarray(v) for k, v in host.items()}
        if mesh is not None:
            return shard_batch_tree(arrs, mesh)
        return arrs

    land, port = _test_canvas_shapes(cfg)
    groups = {"l": [], "p": []}
    for e in roidb:
        groups["l" if e["width"] >= e["height"] else "p"].append(e)

    detections: List[Dict] = []
    timer = Timer()
    for key, canvas in (("l", land), ("p", port)):
        entries = groups[key]
        if not entries:
            continue
        for i in range(0, len(entries), batch_size):
            chunk = entries[i : i + batch_size]
            # pad the final chunk to the static batch size
            pad = batch_size - len(chunk)
            batch_entries = chunk + [chunk[-1]] * pad
            host = prepare_test_batch(
                cfg, batch_entries, canvas, as_uint8=True
            )
            if precomputed:
                from sad_tpu.data.rpn_minibatch import pad_proposals

                props, pvalid = pad_proposals(
                    batch_entries, prop_cap, host["im_scale"]
                )
                host = dict(host, proposals=props, prop_valid=pvalid)
            timer.tic()
            dev = _put(host)
            out = infer(
                params, dev["data"], dev["im_hw"], dev["im_scale"],
                dev["content_hw"],
                *((dev["proposals"], dev["prop_valid"])
                  if precomputed else ()),
            )
            boxes = np.asarray(out["boxes"])
            scores = np.asarray(out["scores"])
            classes = np.asarray(out["classes"])
            valid = np.asarray(out["valid"])
            mask_prob = (
                np.asarray(out["mask_prob"]) if "mask_prob" in out else None
            )
            kps_heatmaps = (
                np.asarray(out["kps_heatmaps"]) if "kps_heatmaps" in out else None
            )
            if bbox_aug:
                # extra box passes, one per transform (base pass is index 0)
                t_list = bbox_aug_transforms(cfg)
                outs_t = [
                    {"boxes": boxes, "scores": scores,
                     "classes": classes, "valid": valid}
                ]
                flips = [bool(t_list[0]["hflip"])]
                for t in t_list[1:]:
                    if t.get("aspect_ratio", 1.0) != 1.0:
                        raise NotImplementedError(
                            "aspect-ratio TTA not supported on static canvases"
                        )
                    host_t = prepare_test_batch(
                        cfg, batch_entries, canvas,
                        int(t["scale"]), int(t["max_size"]), t["hflip"],
                        as_uint8=True,
                    )
                    if precomputed:
                        from sad_tpu.data.rpn_minibatch import pad_proposals

                        pt, pvt = pad_proposals(
                            batch_entries, prop_cap, host_t["im_scale"],
                            hflip=bool(t["hflip"]),
                        )
                        host_t = dict(host_t, proposals=pt, prop_valid=pvt)
                    dev_t = _put(host_t)
                    o = infer(
                        params, dev_t["data"], dev_t["im_hw"],
                        dev_t["im_scale"], dev_t["content_hw"],
                        *((dev_t["proposals"], dev_t["prop_valid"])
                          if precomputed else ()),
                    )
                    outs_t.append(
                        {kk: np.asarray(o[kk])
                         for kk in ("boxes", "scores", "classes", "valid")}
                    )
                    flips.append(bool(t["hflip"]))
                kmax = boxes.shape[1]
                nb = np.zeros_like(boxes)
                ns = np.zeros_like(scores)
                nc = np.zeros_like(classes)
                nv = np.zeros(valid.shape, bool)
                for j, e in enumerate(chunk):
                    per = [
                        {"boxes": o["boxes"][j], "scores": o["scores"][j],
                         "classes": o["classes"][j],
                         "valid": o["valid"][j].astype(bool)}
                        for o in outs_t
                    ]
                    merged = merge_aug_detections(
                        per, im_w=float(e["width"]), flipped_flags=flips
                    )
                    fb, fs, fc = postprocess_detections(
                        cfg, merged["boxes"], merged["scores"],
                        merged["classes"], merged["valid"].astype(bool),
                        cfg.MODEL.NUM_CLASSES,
                    )
                    m = min(len(fs), kmax)
                    order = np.argsort(-fs)[:m]
                    nb[j, :m] = fb[order]
                    ns[j, :m] = fs[order]
                    nc[j, :m] = fc[order]
                    nv[j, :m] = True
                boxes, scores, classes, valid = nb, ns, nc, nv
                if aux_fn is not None:
                    # masks/keypoints must follow the MERGED boxes
                    dev_aux = _put({
                        "data": host["data"],
                        "net": (boxes * host["im_scale"][:, None, None]
                                ).astype(np.float32),
                        "valid": valid,
                        "content_hw": host["content_hw"],
                    })
                    aux0 = aux_fn(
                        params, dev_aux["data"], dev_aux["net"],
                        dev_aux["valid"], dev_aux["content_hw"],
                    )
                    if "mask_prob" in aux0:
                        mask_prob = np.asarray(aux0["mask_prob"])
                    if "kps_heatmaps" in aux0:
                        kps_heatmaps = np.asarray(aux0["kps_heatmaps"])
            if mask_aug and mask_prob is not None:
                if cfg.TEST.MASK_AUG.SCALE_SIZE_DEP:
                    # the reference asserts this out too (test.py:421)
                    raise NotImplementedError(
                        "Size dependent scaling not implemented for masks"
                    )
                stacks = [mask_prob]
                for t in aux_aug_transforms(cfg.TEST.MASK_AUG, cfg):
                    host_t = prepare_test_batch(
                        cfg, batch_entries, canvas,
                        int(t["scale"]), int(t["max_size"]), t["hflip"],
                        as_uint8=True,
                    )
                    bx = (
                        _flip_boxes_imframe(boxes, batch_entries)
                        if t["hflip"] else boxes
                    )
                    dev_t = _put({
                        "data": host_t["data"],
                        "net": (bx * host_t["im_scale"][:, None, None]
                                ).astype(np.float32),
                        "valid": valid,
                        "content_hw": host_t["content_hw"],
                    })
                    o = aux_fn(
                        params, dev_t["data"], dev_t["net"], dev_t["valid"],
                        dev_t["content_hw"],
                    )
                    mp = np.asarray(o["mask_prob"])
                    stacks.append(flip_mask_probs(mp) if t["hflip"] else mp)
                mask_prob = combine_soft_masks(stacks, cfg.TEST.MASK_AUG.HEUR)
            if kps_aug and kps_heatmaps is not None:
                stacks = [kps_heatmaps]
                ds_flags, us_flags = [False], [False]  # identity pass
                for t in aux_aug_transforms(cfg.TEST.KPS_AUG, cfg):
                    host_t = prepare_test_batch(
                        cfg, batch_entries, canvas,
                        int(t["scale"]), int(t["max_size"]), t["hflip"],
                        as_uint8=True,
                    )
                    bx = (
                        _flip_boxes_imframe(boxes, batch_entries)
                        if t["hflip"] else boxes
                    )
                    dev_t = _put({
                        "data": host_t["data"],
                        "net": (bx * host_t["im_scale"][:, None, None]
                                ).astype(np.float32),
                        "valid": valid,
                        "content_hw": host_t["content_hw"],
                    })
                    o = aux_fn(
                        params, dev_t["data"], dev_t["net"], dev_t["valid"],
                        dev_t["content_hw"],
                    )
                    hm = np.asarray(o["kps_heatmaps"])
                    stacks.append(flip_heatmaps(hm) if t["hflip"] else hm)
                    ds_flags.append(bool(t["ds"]))
                    us_flags.append(bool(t["us"]))
                if cfg.TEST.KPS_AUG.SCALE_SIZE_DEP:
                    from .test_augmentation import combine_heatmaps_size_dep

                    kps_heatmaps = combine_heatmaps_size_dep(
                        stacks, ds_flags, us_flags, boxes,
                        cfg.TEST.KPS_AUG.HEUR, cfg.TEST.KPS_AUG.AREA_TH,
                    )
                else:
                    kps_heatmaps = combine_heatmaps(
                        stacks, cfg.TEST.KPS_AUG.HEUR
                    )
            timer.toc()
            for j, e in enumerate(chunk):
                vis_segms = [None] * len(boxes[j])
                vis_kps = [None] * len(boxes[j])
                kp_xy = {}
                kp_keep = None
                if kps_heatmaps is not None:
                    # decode all kept rois at once; optional OKS-NMS over
                    # them (test.py keypoint_results + KRCNN.NMS_OKS)
                    from sad_tpu.utils.keypoints import (
                        heatmaps_to_keypoints,
                        nms_oks,
                    )

                    vidx = [k for k, v in enumerate(valid[j]) if v]
                    if vidx:
                        xy_all = heatmaps_to_keypoints(
                            kps_heatmaps[j][vidx], boxes[j][vidx],
                            min_size=cfg.KRCNN.INFERENCE_MIN_SIZE,
                        )
                        kp_xy = dict(zip(vidx, xy_all))
                        if cfg.KRCNN.NMS_OKS:
                            keep = nms_oks(xy_all, boxes[j][vidx], 0.3)
                            kp_keep = {vidx[q] for q in keep}
                for k, (b, s, c, v) in enumerate(
                    zip(boxes[j], scores[j], classes[j], valid[j])
                ):
                    if not v:
                        continue
                    if kp_keep is not None and k not in kp_keep:
                        continue
                    x1, y1, x2, y2 = (float(t) for t in b)
                    det = {
                        "image_id": e["id"],
                        "category_id": contiguous_to_json[int(c)],
                        # xyxy (legacy +1 extents) -> COCO xywh
                        "bbox": [x1, y1, x2 - x1 + 1.0, y2 - y1 + 1.0],
                        "score": float(s),
                    }
                    if kps_heatmaps is not None:
                        # COCO keypoints triplets + result score per
                        # KRCNN.KEYPOINT_CONFIDENCE (json_dataset_evaluator
                        # _coco_kp_results_one_category:376-409)
                        xy = kp_xy[k]
                        trip = []
                        for ki in range(xy.shape[1]):
                            trip += [float(xy[0, ki]), float(xy[1, ki]), 1]
                        det["keypoints"] = trip
                        # keypoint-task score kept SEPARATE from the box
                        # score: the reference rescoring applies only when
                        # writing keypoint results
                        # (json_dataset_evaluator:376-409); bbox/segm
                        # results keep the box score
                        conf = cfg.KRCNN.KEYPOINT_CONFIDENCE
                        if conf == "logit":
                            det["kps_score"] = float(xy[2].mean())
                        elif conf == "prob":
                            det["kps_score"] = float(xy[3].mean())
                        else:
                            det["kps_score"] = float(s)
                    if mask_prob is not None:
                        # paste the roi-frame mask into the image frame and
                        # RLE-encode (segm_results, test.py + segms utils)
                        from sad_tpu.utils.segms import (
                            mask_to_rle,
                            paste_mask_into_image,
                        )

                        mp = mask_prob[j, k, :, :, int(c)]
                        full = paste_mask_into_image(
                            mp, b, int(e["height"]), int(e["width"]),
                            cfg.MRCNN.THRESH_BINARIZE,
                        )
                        det["segmentation"] = mask_to_rle(full)
                        vis_segms[k] = full
                    if "keypoints" in det:
                        # the (4, K) decode rows — vis thresholds on the
                        # logit row like the reference's vis_keypoints
                        vis_kps[k] = kp_xy.get(k)
                    detections.append(det)
                if vis_dir is not None:
                    # per-image detection render incl. mask overlays and
                    # keypoint skeletons (ref: test_engine.py:231-244 cfg.VIS
                    # dumps -> vis.py vis_one_image; threshold cfg.VIS_TH)
                    from sad_tpu.utils.vis import vis_one_image

                    im_bgr = load_image_bgr(e["image"], False)
                    base = os.path.splitext(
                        os.path.basename(e["image"])
                    )[0]
                    os.makedirs(vis_dir, exist_ok=True)
                    vis_one_image(
                        im_bgr[:, :, ::-1], boxes[j], scores[j], classes[j],
                        valid[j], thresh=cfg.VIS_TH,
                        out_path=os.path.join(vis_dir, base + ".png"),
                        segms=vis_segms, keypoints=vis_kps,
                    )
            if (i // batch_size) % 10 == 0:
                logger.info(
                    "inference %s: %d/%d (avg %.3fs/batch)",
                    key, i + len(chunk), len(entries), timer.average_time,
                )
    return detections



def _dump_results_json(output_dir, results):
    """Persist the metrics dict next to bbox_results.json so CLI drivers and
    the dress rehearsal can consume APs without parsing logs."""
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "results.json"), "w") as f:
            json.dump({k: float(v) for k, v in results.items()}, f, indent=1)


def test_net_on_dataset(
    cfg: Config,
    model: RetinaNet,
    params,
    dataset_name: Optional[str] = None,
    batch_size: int = 8,
    output_dir: Optional[str] = None,
    im_range: Optional[Tuple[int, int]] = None,
) -> Dict[str, float]:
    """Run inference + COCO evaluation on cfg.TEST.DATASETS[0].

    im_range=(start, end) evaluates only that slice of the dataset's images
    (ref test_net.py --range, the reference's subprocess-sharding unit)."""
    name = dataset_name or cfg.TEST.DATASETS[0]
    ds = CocoDataset(name)
    roidb = ds.get_roidb(include_gt=False)
    if im_range is not None:
        roidb = roidb[im_range[0] : im_range[1]]
    if cfg.TEST.PROPOSAL_FILES and not cfg.MODEL.FASTER_RCNN:
        from .rpn_generator import add_proposals_to_roidb

        # proposal files pair positionally with TEST.DATASETS; a wrong file
        # would silently yield zero proposals per image (image-id mismatch),
        # so refuse rather than guess
        if name not in cfg.TEST.DATASETS:
            raise ValueError(
                f"TEST.PROPOSAL_FILES is set but dataset {name!r} is not in "
                f"TEST.DATASETS {cfg.TEST.DATASETS} — cannot pick its "
                "proposal file"
            )
        idx = list(cfg.TEST.DATASETS).index(name)
        if idx >= len(cfg.TEST.PROPOSAL_FILES):
            raise ValueError(
                "TEST.PROPOSAL_FILES must pair 1:1 with TEST.DATASETS "
                f"(got {len(cfg.TEST.PROPOSAL_FILES)} files, dataset "
                f"{name!r} is index {idx})"
            )
        add_proposals_to_roidb(
            roidb, cfg.TEST.PROPOSAL_FILES[idx],
            top_k=cfg.TEST.PROPOSAL_LIMIT,
        )
    vis_dir = (
        os.path.join(output_dir or "/tmp/sad_tpu_vis", "vis")
        if cfg.VIS else None
    )
    dets = run_inference_on_roidb(
        cfg, model, params, roidb, ds.contiguous_to_json, batch_size,
        vis_dir=vis_dir,
    )
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "bbox_results.json"), "w") as f:
            json.dump(dets, f)
    # evaluator dispatch by dataset name (ref: task_evaluation.py:256-266
    # _use_cityscapes/_use_voc/_use_vid_evaluator)
    if "cityscapes_" in name and cfg.MODEL.MASK_ON:
        from .cityscapes_eval import evaluate_masks as cs_evaluate

        # dets carry json category ids (mapped in run_inference_on_roidb)
        id_to_name = {c["id"]: c["name"] for c in ds.dataset["categories"]}
        cs_evaluate(
            roidb, dets, id_to_name,
            output_dir or "/tmp/sad_tpu_cityscapes",
        )
    if name.startswith("vid"):
        from .vid_eval import evaluate_vid_detections

        results = evaluate_vid_detections(ds.dataset, dets)
        _dump_results_json(output_dir, results)
        return results
    if name.startswith("voc_") and not cfg.TEST.FORCE_JSON_DATASET_EVAL:
        # official VOC protocol for voc_* datasets; 11-point AP before 2010
        # (ref: task_evaluation.py _use_json_dataset_evaluator +
        # voc_dataset_evaluator.py)
        from .voc_eval import voc_eval_boxes

        year = name.split("_")[1]
        results = voc_eval_boxes(
            ds.dataset, dets,
            use_07_metric=year.isdigit() and int(year) < 2010,
        )
        _dump_results_json(output_dir, results)
        return results
    results = COCOEvaluator(ds.dataset).evaluate(dets, verbose=True)
    if cfg.MODEL.MASK_ON and dets and "segmentation" in dets[0]:
        segm = COCOEvaluator(ds.dataset, iou_type="segm").evaluate(
            dets, verbose=True
        )
        results.update({f"segm_{k}": v for k, v in segm.items()})
    if cfg.MODEL.KEYPOINTS_ON and any("keypoints" in d for d in dets):
        # keypoint task eval ranked by the keypoint-confidence score
        # (json_dataset_evaluator _do_keypoint_eval + the per-result score
        # selection at :376-409)
        kp_dets = [
            dict(d, score=d.get("kps_score", d["score"]))
            for d in dets
            if "keypoints" in d
        ]
        kps = COCOEvaluator(ds.dataset, iou_type="keypoints").evaluate(
            kp_dets, verbose=True
        )
        results.update({f"keypoints_{k}": v for k, v in kps.items()})
    _dump_results_json(output_dir, results)
    return results


def generate_pseudo_labels(
    cfg: Config,
    model: RetinaNet,
    params,
    dataset_name: str,
    out_json: str,
    score_thresh: float = 0.5,
    batch_size: int = 8,
) -> str:
    """Teacher pseudo-label generation over an unlabeled dataset.

    Writes a COCO-format annotation json consumable as a catalog entry
    (DISTILLATION.UNLABEL_DATASETS) — the reference's §3.4 flow, batched."""
    ds = CocoDataset(dataset_name)
    roidb = ds.get_roidb(include_gt=False)
    dets = run_inference_on_roidb(
        cfg, model, params, roidb, ds.contiguous_to_json, batch_size
    )
    anns = []
    for i, d in enumerate(dets):
        if d["score"] < score_thresh:
            continue
        x, y, w, h = d["bbox"]
        anns.append(
            {
                "id": i + 1,
                "image_id": d["image_id"],
                "category_id": d["category_id"],
                "bbox": d["bbox"],
                "area": float(w * h),
                "iscrowd": 0,
                "score": d["score"],  # retained for filtering/inspection
            }
        )
    out = {
        "images": ds.dataset["images"],
        "categories": ds.dataset["categories"],
        "annotations": anns,
    }
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(out, f)
    logger.info(
        "Wrote %d pseudo annotations for %d images -> %s",
        len(anns), len(ds.dataset["images"]), out_json,
    )
    return out_json
