"""Run inference on a directory of images and render detections
(ref: detectron/tools/infer_simple.py:93-135).

Usage:
  python -m sad_tpu.tools.infer_simple --cfg cfg.yaml --weights model.pkl \
      --image-dir imgs/ --output-dir out/ [--thresh 0.5]
"""

from __future__ import annotations

import argparse
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np

from sad_tpu.config import load_cfg
from sad_tpu.data.minibatch import canvas_shapes, compute_im_scale, prep_image
from sad_tpu.eval.inference import make_inference_fn
from sad_tpu.models import create_model
from sad_tpu.models.model_builder import init_model_params
from sad_tpu.train.train_loop import load_reference_or_native
from sad_tpu.utils.env import enable_compile_cache
from sad_tpu.utils.logging import setup_logging
from sad_tpu.utils.vis import vis_one_image

logger = setup_logging("infer_simple")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", dest="cfg_file", required=True)
    # --wts is the reference's name for the same flag
    p.add_argument("--weights", "--wts", dest="weights", default=None)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--thresh", type=float, default=0.5)
    p.add_argument("--ext", "--image-ext", dest="ext", default="jpg")
    # the reference takes a positional image-or-folder operand
    p.add_argument("im_or_folder", nargs="?", default=None)
    args = p.parse_args(argv)
    if args.image_dir is None:
        if args.im_or_folder is None:
            p.error("provide --image-dir or an im_or_folder operand")
        args.image_dir = args.im_or_folder

    enable_compile_cache()
    cfg = load_cfg(args.cfg_file)
    model = create_model(cfg)
    (h0, w0), _ = canvas_shapes(cfg)
    params = init_model_params(model, jax.random.PRNGKey(0), (1, h0, w0, 3))
    if args.weights or cfg.TEST.WEIGHTS:
        params = load_reference_or_native(args.weights or cfg.TEST.WEIGHTS, params, cfg)
    infer = make_inference_fn(cfg, model)

    cs = cfg.FPN.COARSEST_STRIDE
    short = int(cs * np.ceil(max(cfg.TEST.SCALES) / cs))
    long = max(int(cs * np.ceil(cfg.TEST.MAX_SIZE / cs)), short)
    os.makedirs(args.output_dir, exist_ok=True)

    from PIL import Image

    paths = (
        [args.image_dir]
        if os.path.isfile(args.image_dir)
        else sorted(glob.glob(os.path.join(args.image_dir, f"*.{args.ext}")))
    )
    for path in paths:
        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
        bgr = rgb[:, :, ::-1].copy()
        ih, iw = bgr.shape[:2]
        canvas = (short, long) if iw >= ih else (long, short)
        scale = compute_im_scale(ih, iw, cfg.TEST.SCALES[0], cfg.TEST.MAX_SIZE)
        im = prep_image(bgr, scale, cfg.PIXEL_MEANS, cfg.PIXEL_DIV, cfg.PIXEL_STD)
        data = np.zeros((1, canvas[0], canvas[1], 3), np.float32)
        data[0, : im.shape[0], : im.shape[1]] = im
        out = infer(
            params,
            jnp.asarray(data),
            jnp.asarray([[ih, iw]], jnp.float32),
            jnp.asarray([scale], jnp.float32),
        )
        out_path = os.path.join(
            args.output_dir, os.path.basename(path).rsplit(".", 1)[0] + "_det.png"
        )
        vis_one_image(
            rgb,
            np.asarray(out["boxes"][0]),
            np.asarray(out["scores"][0]),
            np.asarray(out["classes"][0]),
            np.asarray(out["valid"][0]),
            thresh=args.thresh,
            out_path=out_path,
        )
        n_det = int(np.asarray(out["valid"][0]).sum())
        logger.info("%s: %d detections -> %s", path, n_det, out_path)


if __name__ == "__main__":
    main()
