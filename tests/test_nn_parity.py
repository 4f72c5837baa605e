"""The in-repo module layer (sad_tpu/models/nn.py) against flax.linen.

The model files are imported a second time into a scratch package whose
``nn`` is flax.linen, so the same model source runs on both layers. Each
family must give the same parameter tree (names, shapes, dtypes) and, with
one set of parameters, the same outputs. flax is a test-only dependency;
the package itself never imports it.
"""

import importlib
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sad_tpu.config import Config
from sad_tpu.config.config import merge_cfg_from_dict
from sad_tpu.models import model_builder

linen = pytest.importorskip("flax.linen")

_PKG = "sad_tpu._models_on_flax"


def _flax_models():
    if _PKG not in sys.modules:
        pkg = types.ModuleType(_PKG)
        pkg.__path__ = [os.path.dirname(model_builder.__file__)]
        sys.modules[_PKG] = pkg
        sys.modules[_PKG + ".nn"] = linen
    return {
        m: importlib.import_module(f"{_PKG}.{m}")
        for m in ("retinanet", "rcnn", "single_scale")
    }


_RETINA = {
    "MODEL": {"TYPE": "retinanet", "NUM_CLASSES": 5},
    "FPN": {"FPN_ON": True, "RPN_MIN_LEVEL": 3, "RPN_MAX_LEVEL": 7,
            "EXTRA_CONV_LEVELS": True},
    "RETINANET": {"RETINANET_ON": True, "NUM_CONVS": 2},
    "RESNETS": {"CHANNEL_RATIO": 0.0625},
}
_FPN_RCNN = {
    "MODEL": {"TYPE": "generalized_rcnn", "NUM_CLASSES": 5,
              "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
    "FPN": {"FPN_ON": True, "MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True,
            "RPN_MIN_LEVEL": 2, "RPN_MAX_LEVEL": 6, "ROI_MIN_LEVEL": 2,
            "ROI_MAX_LEVEL": 5, "COARSEST_STRIDE": 64},
    "FAST_RCNN": {"MLP_HEAD_DIM": 32, "ROI_XFORM_RESOLUTION": 7},
    "MRCNN": {"DIM_REDUCED": 16},
    "KRCNN": {"CONV_HEAD_DIM": 16, "NUM_STACKED_CONVS": 2},
    "TEST": {"RPN_PRE_NMS_TOP_N": 50, "RPN_POST_NMS_TOP_N": 20},
    "RESNETS": {"CHANNEL_RATIO": 0.0625},
}
_C4 = {
    "MODEL": {"TYPE": "generalized_rcnn", "NUM_CLASSES": 5,
              "CONV_BODY": "ResNet.add_ResNet50_conv4_body"},
    "FAST_RCNN": {"ROI_BOX_HEAD": "ResNet.add_ResNet_roi_conv5_head",
                  "ROI_XFORM_RESOLUTION": 8},
    "TEST": {"RPN_PRE_NMS_TOP_N": 50, "RPN_POST_NMS_TOP_N": 20},
    "RPN": {"SIZES": (32, 64)},
    "RESNETS": {"CHANNEL_RATIO": 0.0625},
}
_VGG = {
    "MODEL": {"TYPE": "generalized_rcnn", "NUM_CLASSES": 5,
              "CONV_BODY": "VGG16.add_VGG16_conv5_body"},
    "FAST_RCNN": {"ROI_BOX_HEAD": "VGG16.add_VGG16_roi_fc_head",
                  "ROI_XFORM_RESOLUTION": 2},
    "TEST": {"RPN_PRE_NMS_TOP_N": 20, "RPN_POST_NMS_TOP_N": 4},
    "RPN": {"SIZES": (32,)},
}


def _merge(*ds):
    out = {}
    for d in ds:
        for k, v in d.items():
            out[k] = {**out.get(k, {}), **v} if isinstance(v, dict) else v
    return out


CASES = {
    "retinanet_R50": (_RETINA, 64),
    "retinanet_R101": (
        _merge(_RETINA, {"MODEL": {"CONV_BODY": "FPN.add_fpn_ResNet101_conv5_body"}}),
        64,
    ),
    "retinanet_X101": (
        _merge(_RETINA, {
            "MODEL": {"CONV_BODY": "FPN.add_fpn_ResNet101_conv5_body"},
            "RESNETS": {"NUM_GROUPS": 8, "WIDTH_PER_GROUP": 4,
                        "CHANNEL_RATIO": 0.25},
        }),
        64,
    ),
    "retinanet_R50_remat": (_merge(_RETINA, {"REMAT_BACKBONE": True}), 64),
    "faster_rcnn_fpn": (_FPN_RCNN, 64),
    "mask_rcnn_fpn": (_merge(_FPN_RCNN, {"MODEL": {"MASK_ON": True}}), 64),
    "keypoint_rcnn_fpn": (_merge(_FPN_RCNN, {"MODEL": {"KEYPOINTS_ON": True}}), 64),
    "faster_rcnn_c4_mask": (_merge(_C4, {"MODEL": {"MASK_ON": True},
                                         "MRCNN": {"DIM_REDUCED": 8,
                                                   "ROI_XFORM_RESOLUTION": 8,
                                                   "ROI_MASK_HEAD": "v0upshare"}}),
                            64),
    "vgg16": (_VGG, 32),
}


def _build(overrides):
    cfg = merge_cfg_from_dict(
        Config(), _merge(overrides, {"COMPUTE_DTYPE": "float32"})
    )
    ours = model_builder.create_model(cfg)
    mods = _flax_models()
    name = type(ours).__name__
    owner = {"RetinaNet": "retinanet", "GeneralizedRCNN": "rcnn",
             "SingleScaleRCNN": "single_scale"}[name]
    theirs = getattr(mods[owner], name)(
        ours.arch if name == "RetinaNet" else cfg
    )
    return cfg, ours, theirs


def _spec(tree):
    return jax.tree_util.tree_map(lambda a: (a.shape, a.dtype), tree)


@pytest.mark.parametrize("case", sorted(CASES))
def test_param_tree_and_outputs_match_flax(case):
    overrides, size = CASES[case]
    _, ours, theirs = _build(overrides)
    images = jax.random.normal(jax.random.PRNGKey(1), (2, size, size, 3))
    im_hw = jnp.full((2, 2), float(size))
    is_rcnn = type(ours).__name__ != "RetinaNet"
    args = (images, im_hw) if is_rcnn else (images,)
    kw = {"method": "init_all"} if is_rcnn else {}

    p_ours = ours.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    p_theirs = theirs.init(jax.random.PRNGKey(0), *args, **kw)["params"]
    assert _spec(p_ours) == _spec(p_theirs)

    out_ours = ours.apply({"params": p_ours}, *args)
    out_theirs = theirs.apply({"params": p_ours}, *args)
    flat_ours = jax.tree_util.tree_leaves_with_path(out_ours)
    flat_theirs = jax.tree_util.tree_leaves(out_theirs)
    assert len(flat_ours) == len(flat_theirs)
    for (path, a), b in zip(flat_ours, flat_theirs):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5,
            err_msg=jax.tree_util.keystr(path),
        )


def test_apply_with_method_name_and_callable():
    _, ours, theirs = _build(_merge(_FPN_RCNN, {"MODEL": {"MASK_ON": True}}))
    images = jnp.ones((1, 64, 64, 3))
    im_hw = jnp.full((1, 2), 64.0)
    params = ours.init(
        jax.random.PRNGKey(0), images, im_hw, method="init_all"
    )["params"]
    feats = jnp.ones((3, 14, 14, 16))
    by_name = ours.apply({"params": params}, feats, method="mask_heads")
    by_fn = ours.apply(
        {"params": params}, feats, method=lambda m, f: m.mask_head(f)
    )
    ref = theirs.apply({"params": params}, feats, method="mask_heads")
    np.testing.assert_allclose(by_name, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(by_fn, ref, rtol=1e-5, atol=1e-5)


def test_missing_parameter_raises():
    _, ours, _ = _build(_RETINA)
    with pytest.raises(KeyError, match="no parameter"):
        ours.apply({"params": {}}, jnp.zeros((1, 64, 64, 3)))
