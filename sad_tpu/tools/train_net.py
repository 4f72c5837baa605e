"""Train a RetinaNet / SAD distillation model (ref: detectron/tools/train_net.py).

Usage:
  python -m sad_tpu.tools.train_net --cfg student.yaml \
      [--teacher_cfg teacher.yaml] [--skip-test] [KEY VALUE ...]

Reference YAML configs load directly (the config surface is compatible).
"""

from __future__ import annotations

import argparse
import sys

from sad_tpu.config import load_cfg
from sad_tpu.config.config import get_output_dir
from sad_tpu.train.train_loop import train_model
from sad_tpu.utils.env import enable_compile_cache
from sad_tpu.utils.logging import setup_logging

logger = setup_logging("train_net")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    p.add_argument("--teacher_cfg", dest="teacher_cfg_file", default=None)
    p.add_argument("--skip-test", action="store_true")
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument(
        "--multi-gpu-testing", action="store_true",
        help="accepted for reference-CLI parity; post-training eval is "
             "already batched over every local device",
    )
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    enable_compile_cache()
    cfg = load_cfg(args.cfg_file, args.opts or None)
    teacher_cfg = (
        load_cfg(args.teacher_cfg_file) if args.teacher_cfg_file else None
    )
    if cfg.MODEL.TYPE == "distillation" and teacher_cfg is None:
        logger.error("MODEL.TYPE=distillation requires --teacher_cfg")
        sys.exit(1)

    state = train_model(cfg, teacher_cfg, max_iters=args.max_iters)
    logger.info("Training complete -> %s", get_output_dir(cfg, training=True))

    if not args.skip_test:
        from sad_tpu.eval.test_engine import test_net_on_dataset
        from sad_tpu.models import create_model

        model = create_model(cfg)
        results = test_net_on_dataset(
            cfg, model, state.params,
            output_dir=get_output_dir(cfg, training=False),
        )
        logger.info("Eval results: %s", results)
        if cfg.EXPECTED_RESULTS:
            # post-training quality gate (ref: lib/core/config.py:966-973 +
            # task_evaluation.check_expected_results) — a regression in the
            # train->eval loop fails the run loudly
            from sad_tpu.eval.task_evaluation import check_expected_results

            check_expected_results(
                cfg, {cfg.TEST.DATASETS[0]: {"box": results}}
            )


if __name__ == "__main__":
    main()
