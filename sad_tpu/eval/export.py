"""Model export for serving: ahead-of-time serialized inference programs.

The reference's deployment story is Caffe2 NetDef protobuf export
(lib/utils/model_convert_utils.py net transforms for deploy); the JAX
analogue is `jax.export`: the jitted inference function (model + decode +
NMS, fixed shapes) serializes to a portable StableHLO artifact that a serving
binary reloads and calls without Python model code.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
from jax import export as jax_export

from sad_tpu.config import Config
from sad_tpu.utils.logging import setup_logging

logger = setup_logging(__name__)


def export_retinanet_inference(
    cfg: Config,
    model,
    params,
    batch_size: int,
    canvas_hw: Tuple[int, int],
    path: str,
) -> str:
    """Serialize the end-to-end RetinaNet inference program (params baked in)
    for (batch_size, H, W, 3) inputs. Returns the artifact path."""
    from .inference import make_inference_fn

    infer = make_inference_fn(cfg, model)
    h, w = canvas_hw

    def serve(images, im_hw, im_scale):
        return infer(params, images, im_hw, im_scale)

    exported = jax_export.export(jax.jit(serve))(
        jax.ShapeDtypeStruct((batch_size, h, w, 3), jnp.float32),
        jax.ShapeDtypeStruct((batch_size, 2), jnp.float32),
        jax.ShapeDtypeStruct((batch_size,), jnp.float32),
    )
    blob = exported.serialize()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
    logger.info(
        "Exported inference program (%d bytes, platforms=%s) -> %s",
        len(blob), exported.platforms, path,
    )
    return path


def load_exported(path: str) -> Callable:
    """Deserialize an exported program; returns fn(images, im_hw, im_scale)."""
    with open(path, "rb") as f:
        exported = jax_export.deserialize(f.read())

    def serve(images, im_hw, im_scale):
        return exported.call(images, im_hw, im_scale)

    return serve
