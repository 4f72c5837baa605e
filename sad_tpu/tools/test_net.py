"""Evaluate a model on TEST.DATASETS (ref: detectron/tools/test_net.py).

Also the pseudo-label generator: with --pseudo-out, teacher detections over
TEST.DATASETS[0] become a COCO-format annotation json (SURVEY.md §3.4).

Usage:
  python -m sad_tpu.tools.test_net --cfg cfg.yaml --weights model.pkl
  python -m sad_tpu.tools.test_net --cfg teacher.yaml --weights t.pkl \
      --pseudo-out pseudo.json
"""

from __future__ import annotations

import argparse

import jax

from sad_tpu.config import load_cfg
from sad_tpu.config.config import get_output_dir
from sad_tpu.data.minibatch import canvas_shapes
from sad_tpu.models import create_model
from sad_tpu.models.model_builder import init_model_params
from sad_tpu.train.train_loop import load_reference_or_native
from sad_tpu.utils.env import enable_compile_cache
from sad_tpu.utils.logging import setup_logging

logger = setup_logging("test_net")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--weights", default=None)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--pseudo-out", default=None)
    p.add_argument("--pseudo-score-thresh", type=float, default=0.5)
    p.add_argument(
        "--wait", action="store_true",
        help="wait for the weights file to exist (ref test_net.py --wait)",
    )
    p.add_argument(
        "--vis", action="store_true",
        help="visualize detections (sets VIS True)",
    )
    p.add_argument(
        "--range", dest="im_range", type=int, nargs=2, default=None,
        metavar=("START", "END"),
        help="evaluate images [START, END) of the dataset "
             "(ref test_net.py --range)",
    )
    p.add_argument(
        "--multi-gpu-testing", action="store_true",
        help="accepted for reference-CLI parity; inference is already "
             "batched over every local device via the data mesh (no "
             "subprocess sharding needed)",
    )
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    enable_compile_cache()
    opts = list(args.opts or [])
    if args.vis:
        opts += ["VIS", "True"]
    cfg = load_cfg(args.cfg_file, opts or None)
    if args.multi_gpu_testing:
        logger.info(
            "--multi-gpu-testing: batched mesh inference covers all "
            "local devices (%d)", jax.local_device_count(),
        )
    model = create_model(cfg)
    (h, w), _ = canvas_shapes(cfg)
    params = init_model_params(model, jax.random.PRNGKey(0), (1, h, w, 3))
    weights = args.weights or cfg.TEST.WEIGHTS
    if args.wait and weights:
        import os
        import time

        while not os.path.exists(weights):
            logger.info("Waiting for %s to exist...", weights)
            time.sleep(10)
    if weights:
        params = load_reference_or_native(weights, params, cfg)
        logger.info("Loaded weights: %s", weights)

    if args.pseudo_out:
        from sad_tpu.eval.test_engine import generate_pseudo_labels

        generate_pseudo_labels(
            cfg, model, params, cfg.TEST.DATASETS[0], args.pseudo_out,
            score_thresh=args.pseudo_score_thresh,
            batch_size=args.batch_size,
        )
    elif cfg.MODEL.TYPE == "rpn":
        # RPN-only: dump proposals + recall metrics (ref: test_engine.py
        # RPN_ONLY branch -> rpn_generator + evaluate_box_proposals)
        from sad_tpu.data.dataset import CocoDataset
        from sad_tpu.eval.rpn_generator import (
            evaluate_box_proposals,
            generate_rpn_on_dataset,
        )

        out_dir = get_output_dir(cfg, training=False)
        props = generate_rpn_on_dataset(
            cfg, model, params, batch_size=args.batch_size,
            output_file=f"{out_dir}/rpn_proposals.pkl",
        )
        gt_roidb = CocoDataset(cfg.TEST.DATASETS[0]).get_roidb(include_gt=True)
        rec = evaluate_box_proposals(props, gt_roidb)
        logger.info(
            "Proposal AR=%.4f over %d gt boxes", rec["ar"], rec["num_pos"]
        )
    else:
        from sad_tpu.eval.test_engine import test_net_on_dataset

        results = test_net_on_dataset(
            cfg, model, params, batch_size=args.batch_size,
            output_dir=get_output_dir(cfg, training=False),
            im_range=tuple(args.im_range) if args.im_range else None,
        )
        logger.info("Results: %s", results)
        if cfg.EXPECTED_RESULTS:
            from sad_tpu.eval.task_evaluation import check_expected_results

            check_expected_results(
                cfg, {cfg.TEST.DATASETS[0]: {"box": results}}
            )


if __name__ == "__main__":
    main()
