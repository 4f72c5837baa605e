"""Config-surface regression: every in-repo YAML must keep loading.

The reference ships 110 configs; 94 are loadable by the reference itself and
16 (all under model_comp/) name config keys that never existed in the
released lib/core/config.py — the reference's own merge raises
KeyError('Non-existent config key: {}') on them (config.py:1146-1151).
sad_tpu must refuse those keys the same way; the configs in configs/ (the
SAD student and teacher) must load and build.
"""

import glob
import os

import pytest

from sad_tpu.config import load_cfg
from sad_tpu.config.config import ConfigError

REPO_CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")

# YAML -> first non-existent key the merge hits (matches the reference's own
# KeyError; see lib/core/config.py:1146-1151). Everything else must load.
EXPECTED_BAD_KEYS = {
    "model_comp/ResNet-50.yaml": "CLS",
    "model_comp/retinanet_R-101-FPN_1x.yaml": "DISTILLATION.WEIGHTS",
    "model_comp/retinanet_R-50-FPN_1x.yaml": "DISTILLATION.HARD_WEIGHTS",
    "model_comp/retinanet_R-50-FPN_1x_L2.yaml": "RETINANET.ONE_HOT_TARGET",
    "model_comp/retinanet_R-50-FPN_1x_half.yaml": "DISTILLATION.WEIGHTS",
    "model_comp/retinanet_R-50-FPN_1x_test.yaml": "DISTILLATION.HARD_WEIGHTS",
    "model_comp/retinanet_R-50-FPN_deconv.yaml": "RETINANET.DECONV",
    "model_comp/retinanet_R-50-FPN_deconv_unlabel.yaml": "RETINANET.DECONV",
    "model_comp/retinanet_R-50-FPN_distillation.yaml": "DISTILLATION.WEIGHTS",
    "model_comp/retinanet_R-50-FPN_distillation_bbox_thresh.yaml": "RETINANET.DECONV",
    "model_comp/retinanet_R-50-FPN_distillation_half.yaml": "DISTILLATION.WEIGHTS",
    "model_comp/retinanet_R-50-FPN_distillation_self.yaml": "DISTILLATION.WEIGHTS",
    "model_comp/retinanet_R-50-FPN_distillation_soft_t.yaml": "DISTILLATION.WEIGHTS",
    "model_comp/retinanet_R-50-FPN_distillation_test.yaml": "RETINANET.DECONV",
    "model_comp/retinanet_R-50-FPN_mutual.yaml": "DISTILLATION.WEIGHTS",
    "model_comp/retinanet_X-101-64x4d-FPN_1x.yaml": "DISTILLATION.WEIGHTS",
}


def _all_yamls():
    return sorted(glob.glob(os.path.join(REPO_CONFIGS, "*.yaml")))


def _nested_yaml(dotted_key):
    """A YAML document setting `dotted_key` (e.g. 'DISTILLATION.WEIGHTS')."""
    parts = dotted_key.split(".")
    lines = [" " * (2 * i) + f"{p}:" for i, p in enumerate(parts[:-1])]
    lines.append(" " * (2 * (len(parts) - 1)) + f"{parts[-1]}: 1")
    return "MODEL:\n  TYPE: retinanet\n" + "\n".join(lines) + "\n"


class TestReferenceYamlSurface:
    def test_inventory_complete(self):
        names = {os.path.basename(y) for y in _all_yamls()}
        assert {
            "retinanet_R-50-FPN_distillation.yaml",
            "retinanet_R-101-FPN_1x_teacher.yaml",
        } <= names

    def test_all_valid_yamls_load(self):
        failures = []
        for y in _all_yamls():
            rel = os.path.relpath(y, REPO_CONFIGS)
            try:
                cfg = load_cfg(y)
            except Exception as e:  # noqa: BLE001
                failures.append(f"{rel}: {type(e).__name__}: {e}")
                continue
            assert cfg.MODEL.TYPE, rel
        assert not failures, "\n".join(failures)

    def test_dead_model_comp_yamls_fail_on_same_keys(self, tmp_path):
        for rel, key in EXPECTED_BAD_KEYS.items():
            path = tmp_path / os.path.basename(rel)
            path.write_text(_nested_yaml(key))
            with pytest.raises(ConfigError, match="Non-existent config key"):
                try:
                    load_cfg(str(path))
                except ConfigError as e:
                    assert key in str(e), (rel, str(e))
                    raise


def test_every_loadable_yaml_builds_a_model():
    """The head/body strings of every loadable reference YAML must resolve
    to a constructible sad_tpu model (the reference's get_func matrix,
    model_builder.py:160)."""
    from sad_tpu.models import create_model

    failures = []
    for y in _all_yamls():
        rel = os.path.relpath(y, REPO_CONFIGS)
        cfg = load_cfg(y)
        try:
            m = create_model(cfg)
            assert m is not None
        except Exception as e:  # noqa: BLE001
            failures.append(f"{rel}: {type(e).__name__}: {e}")
    assert not failures, "\n".join(failures)


def test_deprecated_type_aliases_normalize():
    """TYPE: mask_rcnn etc. are deprecated spellings the reference still
    resolves (model_builder.py:511-744); they must normalize with implied
    flags."""
    from sad_tpu.config.config import assert_and_infer_cfg, merge_cfg_from_dict
    from sad_tpu.config import Config

    cfg = assert_and_infer_cfg(
        merge_cfg_from_dict(Config(), {"MODEL": {"TYPE": "mask_rcnn"}})
    )
    assert cfg.MODEL.TYPE == "generalized_rcnn" and cfg.MODEL.MASK_ON
    cfg = assert_and_infer_cfg(
        merge_cfg_from_dict(
            Config(), {"MODEL": {"TYPE": "fast_rcnn_frozen_features"}}
        )
    )
    assert cfg.MODEL.TYPE == "generalized_rcnn"
    assert cfg.TRAIN.FREEZE_CONV_BODY


def test_freeze_conv_body_mask():
    """TRAIN.FREEZE_CONV_BODY freezes the whole conv body + FPN (ref:
    model_builder.py:200-207 StopGradient on every blob_conv)."""
    from sad_tpu.models.model_builder import trainable_mask

    params = {
        "fpn": {"conv1": {"kernel": 1, "bias": 1}},
        "box_head": {"fc6": {"kernel": 1, "bias": 1}},
    }
    m = trainable_mask(params, freeze_at=0, freeze_conv_body=True)
    assert not m["fpn"]["conv1"]["kernel"] and not m["fpn"]["conv1"]["bias"]
    assert m["box_head"]["fc6"]["kernel"] and m["box_head"]["fc6"]["bias"]


def test_cfg_yaml_roundtrip(tmp_path):
    """cfg_to_yaml output reloads through the normal merge path and
    reproduces the config exactly (the checkpoint-embedded cfg, ref
    net.py:149-182)."""
    from sad_tpu.config import load_cfg, yaml_subset
    from sad_tpu.config.config import cfg_to_yaml, merge_cfg_from_dict

    cfg = load_cfg(
        os.path.join(REPO_CONFIGS, "retinanet_R-50-FPN_distillation.yaml"),
        ["NUM_GPUS", "2", "TRAIN.WEIGHTS", ""],
    )
    text = cfg_to_yaml(cfg)
    reloaded = merge_cfg_from_dict(load_cfg(), yaml_subset.loads(text))
    assert reloaded == cfg
