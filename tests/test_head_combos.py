"""Every head/body combination of the in-repo YAMLs and of the reference's
YAML families must resolve through create_model and trace through
parameter init (which runs every head's forward wiring, R-CNN aux heads
included, via init_all).

The reference resolves head strings with get_func (model_builder.py:160);
our builder validates them in _check_head_strings_{fpn,c4}. This test closes
the 'R-CNN head-variant tail' — any get_func-resolvable combination a
loadable YAML names has to build, not just the flagship ones.

Tracing uses jax.eval_shape (abstract shapes, no compile), so full-depth
R-101/X-101 bodies stay cheap on the 1-core CPU runner.
"""

import glob
import os

import jax

from sad_tpu.config import Config, load_cfg
from sad_tpu.config.config import assert_and_infer_cfg, merge_cfg_from_dict
from sad_tpu.models import create_model
from sad_tpu.models.model_builder import init_model_params

REPO_CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")

_FPN = {"FPN_ON": True, "MULTILEVEL_RPN": True, "MULTILEVEL_ROIS": True,
        "RPN_MIN_LEVEL": 2, "RPN_MAX_LEVEL": 6, "ROI_MIN_LEVEL": 2,
        "ROI_MAX_LEVEL": 5, "COARSEST_STRIDE": 64}
# The head/body families the reference's loadable YAMLs name
# (12_2017_baselines, rpn, rfcn, VGG and C4 configs), by their strings.
REFERENCE_FAMILIES = {
    "faster_rcnn_fpn": {"MODEL": {"TYPE": "faster_rcnn",
                                  "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
                        "FPN": _FPN,
                        "FAST_RCNN": {"ROI_BOX_HEAD": "head_builder.add_roi_2mlp_head"}},
    "mask_rcnn_fpn": {"MODEL": {"TYPE": "mask_rcnn",
                                "CONV_BODY": "FPN.add_fpn_ResNet101_conv5_body"},
                      "FPN": _FPN,
                      "MRCNN": {"ROI_MASK_HEAD": "mask_rcnn_heads.mask_rcnn_fcn_head_v1up4convs"}},
    "keypoint_rcnn_fpn": {"MODEL": {"TYPE": "keypoint_rcnn",
                                    "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
                          "FPN": _FPN},
    "rpn_fpn": {"MODEL": {"TYPE": "rpn", "RPN_ONLY": True,
                          "CONV_BODY": "FPN.add_fpn_ResNet50_conv5_body"},
                "FPN": _FPN},
    "faster_rcnn_c4": {"MODEL": {"TYPE": "generalized_rcnn",
                                 "CONV_BODY": "ResNet.add_ResNet50_conv4_body"},
                       "FAST_RCNN": {"ROI_BOX_HEAD": "ResNet.add_ResNet_roi_conv5_head"}},
    "mask_rcnn_c4_v0upshare": {"MODEL": {"TYPE": "mask_rcnn",
                                         "CONV_BODY": "ResNet.add_ResNet50_conv4_body"},
                               "FAST_RCNN": {"ROI_BOX_HEAD": "ResNet.add_ResNet_roi_conv5_head"},
                               "MRCNN": {"ROI_MASK_HEAD": "mask_rcnn_heads.mask_rcnn_fcn_head_v0upshare",
                                         "ROI_XFORM_RESOLUTION": 14}},
    "mask_rcnn_c4_v0up": {"MODEL": {"TYPE": "mask_rcnn",
                                    "CONV_BODY": "ResNet.add_ResNet101_conv4_body"},
                          "FAST_RCNN": {"ROI_BOX_HEAD": "ResNet.add_ResNet_roi_conv5_head"},
                          "MRCNN": {"ROI_MASK_HEAD": "mask_rcnn_heads.mask_rcnn_fcn_head_v0up"}},
    "vgg16": {"MODEL": {"TYPE": "faster_rcnn", "CONV_BODY": "VGG16.add_VGG16_conv5_body"},
              "FAST_RCNN": {"ROI_BOX_HEAD": "VGG16.add_VGG16_roi_fc_head"}},
    "vgg_cnn_m_1024": {"MODEL": {"TYPE": "faster_rcnn",
                                 "CONV_BODY": "VGG_CNN_M_1024.add_VGG_CNN_M_1024_conv5_body"},
                       "FAST_RCNN": {"ROI_BOX_HEAD": "VGG_CNN_M_1024.add_VGG_CNN_M_1024_roi_fc_head"}},
    "rfcn": {"MODEL": {"TYPE": "rfcn", "CONV_BODY": "ResNet.add_ResNet50_conv4_body"}},
}


def _combo_key(cfg):
    return (
        cfg.MODEL.TYPE,
        cfg.MODEL.CONV_BODY,
        cfg.FAST_RCNN.ROI_BOX_HEAD,
        cfg.MRCNN.ROI_MASK_HEAD if cfg.MODEL.MASK_ON else "",
        cfg.KRCNN.ROI_KEYPOINTS_HEAD if cfg.MODEL.KEYPOINTS_ON else "",
        cfg.FPN.FPN_ON,
        cfg.MODEL.MASK_ON,
        cfg.MODEL.KEYPOINTS_ON,
        cfg.RETINANET.RETINANET_ON,
    )


def _loadable_combos():
    combos = {}
    for path in sorted(glob.glob(os.path.join(REPO_CONFIGS, "*.yaml"))):
        cfg = load_cfg(path)
        combos.setdefault(_combo_key(cfg), (os.path.basename(path), cfg))
    for name, overrides in sorted(REFERENCE_FAMILIES.items()):
        cfg = assert_and_infer_cfg(
            merge_cfg_from_dict(
                Config(), {**overrides, "MODEL": {**overrides["MODEL"],
                                                   "NUM_CLASSES": 81}}
            )
        )
        combos.setdefault(_combo_key(cfg), (name, cfg))
    return sorted(combos.values(), key=lambda c: c[0])


def test_every_loadable_combo_builds_and_traces():
    combos = _loadable_combos()
    assert len(combos) >= 10  # the surface is real, not one family
    failures = []
    for relpath, cfg in combos:
        # shrink width only — depth/wiring is what is under test
        cfg = merge_cfg_from_dict(
            cfg,
            {"RESNETS": {"CHANNEL_RATIO": 0.125}, "COMPUTE_DTYPE": "float32"},
        )
        try:
            model = create_model(cfg)
            shapes = jax.eval_shape(
                lambda m=model: init_model_params(
                    m, jax.random.PRNGKey(0), (1, 128, 128, 3)
                )
            )
            n_params = len(jax.tree_util.tree_leaves(shapes))
            assert n_params > 10, f"{relpath}: suspiciously few params"
        except Exception as e:  # noqa: BLE001 — collect all failures
            failures.append(f"{relpath}: {type(e).__name__}: {e}")
    assert not failures, "\n".join(failures)
