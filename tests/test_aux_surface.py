"""Aux surface: keypoint utils, RLE, image-list dataset, proposal files,
model summary."""

import os
import pickle

import numpy as np
import pytest

from sad_tpu.utils import segms
from sad_tpu.utils.keypoints import (
    flip_keypoint_channels,
    get_keypoints,
    heatmaps_to_keypoints,
)


class TestKeypoints:
    def test_flip_map_is_involution(self):
        idx = flip_keypoint_channels()
        np.testing.assert_array_equal(idx[idx], np.arange(17))
        names, _ = get_keypoints()
        assert names[idx[names.index("left_eye")]] == "right_eye"
        assert names[idx[names.index("nose")]] == "nose"

    def test_heatmap_decode_peak_location(self):
        hm = np.full((1, 8, 8, 2), -5.0, np.float32)
        hm[0, 2, 6, 0] = 5.0   # keypoint 0 at (py=2, px=6)
        hm[0, 7, 0, 1] = 5.0
        rois = np.asarray([[10.0, 20.0, 90.0, 100.0]], np.float32)
        out = heatmaps_to_keypoints(hm, rois)
        # the heatmap is bicubic-upsampled to the 80x80 roi before argmax
        # (keypoints.py:103-158); an isolated hot cell's upsampled bump
        # peaks at the cell center: x = (6+0.5)*80/8+10 = 75, y = 45
        assert out[0, 0, 0] == pytest.approx(75.0, abs=1.0)
        assert out[0, 1, 0] == pytest.approx(45.0, abs=1.0)
        # prob comes from a softmax over the RESIZED 80x80 map: the hot
        # cell's mass spreads over its ~10x10 upsampled bump, so the peak
        # prob is small in absolute terms but far above uniform
        assert out[0, 3, 0] > 20.0 / (80 * 80)

    def test_resize_bicubic_cv2_kernel_semantics(self):
        """_resize_bicubic reproduces cv2 INTER_CUBIC (Keys a=-0.75):
        interpolating (identity/constant exact), but NOT linear-reproducing
        between samples — at frac 0.25 the first moment is 0.296875, the
        a=-0.75 kernel's characteristic wiggle (a=-0.5 would give 0.25)."""
        from sad_tpu.utils.keypoints import _resize_bicubic

        rng = np.random.RandomState(0)
        m = rng.randn(8, 8, 3).astype(np.float32)
        np.testing.assert_allclose(_resize_bicubic(m, 8, 8), m, atol=1e-5)
        c = np.full((4, 4, 1), 3.7, np.float32)
        np.testing.assert_allclose(_resize_bicubic(c, 13, 9), 3.7, atol=1e-5)
        ramp = (
            np.arange(8, dtype=np.float32)[None, :, None]
            * np.ones((8, 1, 1), np.float32)
        )
        up = _resize_bicubic(ramp, 8, 16)
        # src position for output col 7 is 3.25 (frac 0.25); the a=-0.75
        # kernel lands at 3 + 0.296875
        assert up[4, 7, 0] == pytest.approx(3.296875, abs=1e-4)

    def test_heatmap_decode_subcell_precision(self):
        """Two adjacent equal-logit cells: the upsampled bump peaks BETWEEN
        them — the cell-center decode could never produce this."""
        hm = np.full((1, 8, 8, 1), -5.0, np.float32)
        hm[0, 4, 3, 0] = 5.0
        hm[0, 4, 4, 0] = 5.0
        rois = np.asarray([[0.0, 0.0, 80.0, 80.0]], np.float32)
        out = heatmaps_to_keypoints(hm, rois)
        # cell centers are x=35 and x=45; the joint peak is near x=40
        assert 37.0 < out[0, 0, 0] < 43.0

    def test_heatmap_decode_inference_min_size(self):
        """INFERENCE_MIN_SIZE floors the upsampled map extent
        (keypoints.py:129-134)."""
        hm = np.full((1, 4, 4, 1), -5.0, np.float32)
        hm[0, 1, 2, 0] = 5.0
        rois = np.asarray([[10.0, 10.0, 14.0, 14.0]], np.float32)  # tiny roi
        out_plain = heatmaps_to_keypoints(hm, rois)
        out_floor = heatmaps_to_keypoints(hm, rois, min_size=64)
        # both localize within the roi near the hot cell center
        for o in (out_plain, out_floor):
            assert 10.0 <= o[0, 0, 0] <= 14.0
            assert 10.0 <= o[0, 1, 0] <= 14.0
        # the floored map gives finer quantization: (x+0.5)*w/64 grid
        assert out_floor[0, 0, 0] != out_plain[0, 0, 0]

    def test_nms_oks_suppresses_duplicates(self):
        """ref keypoints.py nms_oks: greedy keep by mean-logit order,
        suppress OKS > thresh."""
        from sad_tpu.utils.keypoints import compute_oks, nms_oks

        rng = np.random.RandomState(0)
        k = 17
        base = np.zeros((4, k), np.float32)
        base[0] = rng.uniform(20, 80, k)  # x
        base[1] = rng.uniform(20, 80, k)  # y
        base[2] = 5.0  # logits
        dup = base.copy()
        dup[0] += 0.5  # nearly identical prediction
        dup[2] = 3.0  # lower confidence
        far = base.copy()
        far[0] += 500.0
        far[1] += 500.0
        far[2] = 4.0
        preds = np.stack([dup, base, far])  # unordered on purpose
        rois = np.asarray(
            [[10, 10, 90, 90], [10, 10, 90, 90], [510, 510, 590, 590]],
            np.float32,
        )
        # identical prediction has OKS ~1 with itself
        assert compute_oks(base, rois[1], base[None], rois[1:2])[0] == (
            pytest.approx(1.0)
        )
        keep = nms_oks(preds, rois, 0.3)
        # highest mean-logit (index 1) kept first, near-dup (0) suppressed,
        # far prediction (2) kept
        assert keep == [1, 2]


class TestRLE:
    def test_roundtrip(self):
        rng = np.random.RandomState(0)
        m = (rng.uniform(size=(13, 17)) < 0.3).astype(np.uint8)
        rle = segms.mask_to_rle(m)
        back = segms.rle_to_mask(rle)
        np.testing.assert_array_equal(m, back)
        assert sum(rle["counts"]) == 13 * 17

    def test_all_ones_starts_with_zero_run(self):
        m = np.ones((3, 3), np.uint8)
        rle = segms.mask_to_rle(m)
        assert rle["counts"][0] == 0


class TestImageList:
    def test_parse(self, tmp_path):
        f = tmp_path / "list.txt"
        f.write_text("a/b.jpg 3\nc.jpg 0\n")
        from sad_tpu.data.image_list_dataset import ImageListDataset

        ds = ImageListDataset(str(f), "/imgs")
        assert len(ds) == 2
        assert ds.entries[0]["image"] == "/imgs/a/b.jpg"
        assert ds.entries[0]["label"] == 3


class TestProposalFiles:
    def test_attach_and_flip(self, tmp_path):
        from sad_tpu.eval.rpn_generator import add_proposals_to_roidb

        props = {
            "ids": [7],
            "boxes": [np.asarray([[10, 10, 20, 20]], np.float32)],
            "scores": [np.asarray([0.9], np.float32)],
        }
        pf = tmp_path / "props.pkl"
        with open(pf, "wb") as f:
            pickle.dump(props, f)
        roidb = [
            {"id": 7, "width": 100, "height": 80, "flipped": False},
            {"id": 7, "width": 100, "height": 80, "flipped": True},
            {"id": 8, "width": 100, "height": 80, "flipped": False},
        ]
        add_proposals_to_roidb(roidb, str(pf))
        np.testing.assert_allclose(roidb[0]["proposal_boxes"][0], [10, 10, 20, 20])
        np.testing.assert_allclose(roidb[1]["proposal_boxes"][0], [79, 10, 89, 20])
        assert len(roidb[2]["proposal_boxes"]) == 0


class TestModelSummary:
    def test_summary_counts(self):
        from sad_tpu.utils.net_info import print_model_summary

        params = {"a": {"kernel": np.zeros((3, 4))}, "b": np.zeros((5,))}
        txt = print_model_summary(params)
        assert "TOTAL: 17" in txt


class TestVOCDataset:
    def test_parse_and_coco_gt(self, tmp_path):
        import os

        root = tmp_path / "VOC2007"
        (root / "Annotations").mkdir(parents=True)
        (root / "ImageSets" / "Main").mkdir(parents=True)
        (root / "JPEGImages").mkdir()
        (root / "ImageSets" / "Main" / "trainval.txt").write_text("000001\n")
        (root / "Annotations" / "000001.xml").write_text("""
<annotation>
  <size><width>100</width><height>80</height><depth>3</depth></size>
  <object><name>dog</name><difficult>0</difficult>
    <bndbox><xmin>11</xmin><ymin>21</ymin><xmax>50</xmax><ymax>60</ymax></bndbox>
  </object>
  <object><name>person</name><difficult>1</difficult>
    <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>20</xmax><ymax>20</ymax></bndbox>
  </object>
</annotation>""")
        from sad_tpu.data.voc_dataset import VOCDataset

        ds = VOCDataset(str(tmp_path), "2007", "trainval")
        roidb = ds.get_roidb()
        assert len(roidb) == 1
        e = roidb[0]
        assert e["height"] == 80 and e["width"] == 100
        np.testing.assert_allclose(e["boxes"][0], [10, 20, 49, 59])
        assert e["gt_classes"].tolist() == [
            ds.classes.index("dog"), ds.classes.index("person")
        ]
        assert e["difficult"].tolist() == [False, True]

        gt = ds.as_coco_gt(roidb)
        assert len(gt["annotations"]) == 2
        # VOC evaluator ignores difficult gts; perfect det on the dog -> AP 1
        from sad_tpu.eval.voc_eval import voc_eval_boxes

        dets = [{"image_id": 1, "category_id": ds.classes.index("dog"),
                 "bbox": [10, 20, 40, 40], "score": 0.9}]
        res = voc_eval_boxes(gt, dets)
        assert res["mAP"] == pytest.approx(1.0)


def test_net_drawer_writes_dot(tmp_path):
    """tools/net_drawer: the net-visualization devtool analogue
    (caffe2/python/net_drawer.py GetPydotGraph) writes a renderable dot
    graph with body->FPN->head wiring."""
    from sad_tpu.tools.net_drawer import main

    out = str(tmp_path / "m.dot")
    main([
        "--cfg",
        os.path.join(
            os.path.dirname(__file__), "..", "configs",
            "retinanet_R-50-FPN_distillation.yaml",
        ),
        "--out", out, "TRAIN.WEIGHTS", "",
    ])
    text = open(out).read()
    assert text.startswith("digraph")
    assert "->" in text and "params" in text


def test_dashboard_report(tmp_path):
    """tools/dashboard: the mint-web-UI devtool analogue
    (caffe2/python/mint/app.py) — TrainingStats' log_file sink feeds a
    standalone HTML report with per-metric charts + checkpoint table."""
    from sad_tpu.tools.dashboard import main, render_report
    from sad_tpu.utils.stats import TrainingStats

    run = tmp_path / "train" / "coco_2017_val"
    run.mkdir(parents=True)
    stats = TrainingStats(100, log_period=1, log_file=str(run / "stats.jsonl"))
    for it in range(5):
        stats.iter_tic()
        stats.iter_toc()
        stats.update_iter_stats(it, {"loss": 2.0 - 0.3 * it,
                                     "fl_fpn3": 1.0 / (it + 1)})
        stats.log_iter_stats(it, 0.01)
    # the nan-abort iteration logs BEFORE the finite check — a NaN row must
    # not poison the charts
    with open(run / "stats.jsonl", "a") as f:
        f.write('{"iter": 5, "loss": NaN, "fl_fpn3": 0.1}\n')
    with open(run / "model_iter1.pkl", "wb") as f:
        pickle.dump({"params": {}}, f)
    (run / "cfg.yaml").write_text("MODEL:\n  TYPE: retinanet\n")

    out = main(["--dir", str(tmp_path), "--out", str(tmp_path / "r.html")])
    text = open(out).read()
    assert "<svg" in text and "polyline" in text
    import re

    for svg in re.findall(r"<svg.*?</svg>", text, re.S):
        assert "nan" not in svg.lower()  # NaN row filtered from the charts
    assert "fl_fpn3" in text and "loss" in text
    assert "model_iter1.pkl" in text
    assert "MODEL:" in text  # config inlined
    # empty dir degrades gracefully
    empty = tmp_path / "empty"
    empty.mkdir()
    assert "No stats.jsonl" in render_report(str(empty))


class TestRLEString:
    @staticmethod
    def _encode(counts):
        """Transcription of maskApi.c rleToString (the pycocotools
        compressed-RLE encoder) as the test oracle."""
        s = []
        for i, c in enumerate(counts):
            x = int(c)
            if i > 2:
                x -= int(counts[i - 2])
            more = True
            while more:
                ch = x & 0x1F
                x >>= 5
                more = (x != -1) if (ch & 0x10) else (x != 0)
                if more:
                    ch |= 0x20
                s.append(chr(ch + 48))
        return "".join(s)

    def test_roundtrip_random(self):
        from sad_tpu.utils.segms import rle_string_to_counts

        rng = np.random.RandomState(0)
        for _ in range(20):
            counts = rng.randint(0, 5000, rng.randint(1, 40)).tolist()
            assert rle_string_to_counts(self._encode(counts)) == counts

    def test_bytes_input_and_polygon_area(self):
        from sad_tpu.utils.segms import polygon_area, rle_string_to_counts

        counts = [3, 10, 2, 7]
        assert rle_string_to_counts(self._encode(counts).encode()) == counts
        # 10x4 axis-aligned rectangle
        assert polygon_area([0, 0, 10, 0, 10, 4, 0, 4]) == 40.0

    def test_dt_area_variants(self):
        """_dt_area: mask area from uncompressed RLE, compressed RLE string,
        and polygons — never silently bbox for a segm det."""
        from sad_tpu.eval.coco_eval import COCOEvaluator

        gt = {"images": [{"id": 1, "height": 20, "width": 20}],
              "annotations": [], "categories": [{"id": 1, "name": "x"}]}
        ev = COCOEvaluator(gt, iou_type="segm")
        d_unc = {"bbox": [0, 0, 5, 5],
                 "segmentation": {"size": [20, 20], "counts": [3, 7, 2, 8]}}
        assert ev._dt_area(d_unc) == 15.0
        d_cmp = {"bbox": [0, 0, 5, 5],
                 "segmentation": {"size": [20, 20],
                                  "counts": self._encode([3, 7, 2, 8])}}
        assert ev._dt_area(d_cmp) == 15.0
        d_poly = {"bbox": [0, 0, 5, 5],
                  "segmentation": [[0, 0, 10, 0, 10, 4, 0, 4]]}
        assert ev._dt_area(d_poly) == 40.0
        d_bbox = {"bbox": [0, 0, 5, 5]}
        assert ev._dt_area(d_bbox) == 25.0


class TestConvInit:
    def test_msra_fill_matches_caffe2_semantics(self):
        """KRCNN/MRCNN.CONV_INIT='MSRAFill' = Caffe2 filler_op.h:462-475:
        normal with std sqrt(2/fan_out), fan_out = out_ch * kh * kw."""
        import jax
        import jax.numpy as jnp

        from sad_tpu.models.rcnn import KeypointHead, MaskHead

        head = KeypointHead(
            64, 17, num_convs=1, conv_init="MSRAFill", kernel=3
        )
        p = head.init(jax.random.PRNGKey(0), jnp.zeros((2, 14, 14, 64)))
        k = p["params"]["conv_fcn1"]["kernel"]  # (3, 3, 64, 64)
        fan_out = k.shape[-1] * k.shape[0] * k.shape[1]
        std = float(jnp.std(k))
        assert std == pytest.approx((2.0 / fan_out) ** 0.5, rel=0.1)

        gauss = KeypointHead(
            64, 17, num_convs=1, conv_init="GaussianFill", kernel=3
        )
        pg = gauss.init(jax.random.PRNGKey(0), jnp.zeros((2, 14, 14, 64)))
        kg = pg["params"]["conv_fcn1"]["kernel"]
        assert float(jnp.std(kg)) == pytest.approx(0.01, rel=0.1)
        # output deconv: gauss std 0.001 (keypoint_rcnn_heads.py:83)
        dg = pg["params"]["kps_score_lowres"]["kernel"]
        assert float(jnp.std(dg)) == pytest.approx(0.001, rel=0.1)

        mh = MaskHead(32, 3, num_convs=1, conv_init="MSRAFill")
        pm = mh.init(jax.random.PRNGKey(0), jnp.zeros((2, 14, 14, 32)))
        km = pm["params"]["_[mask]_fcn1"]["kernel"]
        fan_out_m = km.shape[-1] * km.shape[0] * km.shape[1]
        assert float(jnp.std(km)) == pytest.approx(
            (2.0 / fan_out_m) ** 0.5, rel=0.1
        )

        with pytest.raises(ValueError, match="CONV_INIT"):
            KeypointHead(8, 17, num_convs=1, conv_init="XavierFill").init(
                jax.random.PRNGKey(0), jnp.zeros((1, 14, 14, 8))
            )


class TestVis:
    def test_vis_one_image_boxes_masks_keypoints(self, tmp_path):
        """vis_one_image overlays masks (alpha blend + white border) and
        keypoint skeletons (ref: vis.py vis_mask/vis_keypoints/kp_connections)."""
        import numpy as np

        from sad_tpu.utils.vis import kp_connections, vis_one_image

        im = np.zeros((60, 80, 3), np.uint8)
        boxes = np.asarray([[10, 10, 40, 40]], np.float32)
        scores = np.asarray([0.9], np.float32)
        classes = np.asarray([1], np.int32)
        mask = np.zeros((60, 80), np.uint8)
        mask[15:35, 15:35] = 1
        kp = np.zeros((4, 17), np.float32)
        kp[0] = np.linspace(12, 38, 17)  # x
        kp[1] = np.linspace(12, 38, 17)  # y
        kp[2] = 5.0  # confident logits
        out = tmp_path / "v.png"
        img = vis_one_image(
            im, boxes, scores, classes,
            segms=[mask], keypoints=[kp], out_path=str(out),
        )
        assert out.exists()
        arr = np.asarray(img)
        # mask interior got blended (non-black), border white
        assert arr[25, 25].sum() > 0
        assert tuple(arr[15, 25]) == (255, 255, 255)
        # skeleton pairs resolve to valid indices
        pairs = kp_connections()
        assert len(pairs) == 15
        assert all(0 <= a < 17 and 0 <= b < 17 for a, b in pairs)


class TestCv2Delegation:
    """When real cv2 is importable, the resize kernels delegate to it; these
    tests pin that the delegated outputs equal the numpy oracles (so either
    path can serve the parity claims)."""

    def test_bilinear_cv2_equals_numpy_oracle(self, monkeypatch):
        pytest.importorskip("cv2")
        import sad_tpu.utils.segms as segms

        rng = np.random.RandomState(0)
        for h, w, oh, ow in [(480, 640, 300, 400), (7, 5, 31, 17),
                             (100, 100, 643, 211)]:
            m = (rng.rand(h, w, 3) * 255).astype(np.float32)
            got = segms._resize_bilinear(m, oh, ow)
            with monkeypatch.context() as mp:
                mp.setattr(segms, "optional_module", lambda name: None)
                want = segms._resize_bilinear(m, oh, ow)
            np.testing.assert_allclose(got, want, atol=1e-3)
            assert got.shape == want.shape

    def test_bicubic_cv2_equals_numpy_oracle(self, monkeypatch):
        pytest.importorskip("cv2")
        import sad_tpu.utils.keypoints as kp

        rng = np.random.RandomState(1)
        for h, w, k, oh, ow in [(14, 14, 17, 120, 85), (8, 8, 1, 33, 57)]:
            m = rng.rand(h, w, k).astype(np.float32)
            got = kp._resize_bicubic(m, oh, ow)
            with monkeypatch.context() as mp:
                mp.setattr(kp, "optional_module", lambda name: None)
                want = kp._resize_bicubic(m, oh, ow)
            np.testing.assert_allclose(got, want, atol=1e-5)
            assert got.shape == want.shape
