"""Surface tests for the synthetic COCO generator (data/synth_coco.py).

The generator is the stand-in for real COCO in the parity dress rehearsal;
these tests pin the properties the rehearsal relies on: determinism,
multi-class coverage, crowd RLE / ignore / small objects present, keypoints
with a flip map, and a clean roidb roundtrip through the CocoDataset layer.
"""

import json
import os

import numpy as np
import pytest

from sad_tpu.config.catalog import register_dataset
from sad_tpu.data.dataset import CocoDataset
from sad_tpu.data.synth_coco import generate_synthetic_coco


@pytest.fixture(scope="module")
def gen(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    img_dir, j = generate_synthetic_coco(
        root, "t", 24, seed=3, with_keypoints=True,
        crowd_frac=0.3, ignore_frac=0.1,
    )
    return root, img_dir, j


def test_document_surface(gen):
    _, img_dir, j = gen
    doc = json.load(open(j))
    assert len(doc["images"]) == 24
    assert len(doc["categories"]) == 8
    cats = {a["category_id"] for a in doc["annotations"]}
    assert len(cats) >= 6, "multi-class coverage"
    assert any(a["iscrowd"] for a in doc["annotations"]), "crowd RLE present"
    crowd = next(a for a in doc["annotations"] if a["iscrowd"])
    assert isinstance(crowd["segmentation"], dict)
    assert any(a.get("ignore") for a in doc["annotations"])
    assert any(a["area"] < 32 * 32 for a in doc["annotations"]), "small objs"
    for im in doc["images"]:
        assert os.path.exists(os.path.join(img_dir, im["file_name"]))
    # annotations lie inside their image
    dims = {im["id"]: (im["height"], im["width"]) for im in doc["images"]}
    for a in doc["annotations"]:
        h, w = dims[a["image_id"]]
        x, y, bw, bh = a["bbox"]
        assert 0 <= x and 0 <= y and x + bw <= w and y + bh <= h


def test_determinism(tmp_path):
    _, j1 = generate_synthetic_coco(str(tmp_path / "a"), "d", 4, seed=11)
    _, j2 = generate_synthetic_coco(str(tmp_path / "b"), "d", 4, seed=11)
    assert json.load(open(j1))["annotations"] == json.load(open(j2))["annotations"]


def test_roidb_roundtrip(gen):
    _, img_dir, j = gen
    register_dataset("synth_rt", img_dir, j, allow_override=True)
    ds = CocoDataset("synth_rt")
    assert ds.keypoints == ["center", "left_tip", "right_tip", "top_tip",
                            "bottom_tip"]
    # left/right tips swap under flip; center/top/bottom are fixed points
    assert list(ds.keypoint_flip_idx) == [0, 2, 1, 3, 4]
    roidb = ds.get_roidb()
    assert sum(len(e["boxes"]) for e in roidb) > 24
    e = next(e for e in roidb if e["is_crowd"].any())
    i = int(np.where(e["is_crowd"])[0][0])
    assert isinstance(e["segms"][i], dict)
    kp = next(e for e in roidb if len(e["gt_keypoints"]))["gt_keypoints"]
    assert kp.shape[1:] == (5, 3)


def test_unlabeled_split(tmp_path):
    d, j = generate_synthetic_coco(str(tmp_path), "u", 3, seed=0, labeled=False)
    doc = json.load(open(j))
    assert "annotations" not in doc and len(doc["images"]) == 3
    assert os.path.basename(j).startswith("image_info_")
