"""CPU rehearsal of chip_smoke.py: every phase at a tiny width on the
virtual CPU devices, and the device check that refuses the CPU."""

import os

import jax
import numpy as np
import pytest

import chip_smoke as cs
from sad_tpu.config import load_cfg
from sad_tpu.config.config import cfg_to_yaml

TINY = [
    "RESNETS.CHANNEL_RATIO", "0.0625", "RETINANET.NUM_CONVS", "1",
    "MODEL.CONV_BODY", "FPN.add_fpn_ResNet50_conv5_body",
    "TRAIN.SCALES", "(64,)", "TRAIN.MAX_SIZE", "128",
    "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "128",
    "COMPUTE_DTYPE", "float32", "NUM_GPUS", "2",
    "DATA_LOADER.NUM_THREADS", "1", "SOLVER.BASE_LR", "0.0001",
] + cs.INIT_OPTS


def _tiny_yaml(tmp_path, path):
    out = tmp_path / os.path.basename(path)
    out.write_text(cfg_to_yaml(load_cfg(path, TINY)))
    return str(out)


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    with pytest.raises(SystemExit):
        cs.main(["--four"])


def test_kernel_phase_checks_at_tiny_width():
    cs.check_nms(3, 300, 20, 0.5, seed=0)
    cs.check_topk(2, 16, width=4096)
    cs.check_losses(0, grid=(1, 4, 6, 3, 5))


def test_near_threshold_explains_only_near_pairs():
    boxes = np.array([[0, 0, 9, 9], [0, 0, 9, 9], [100, 100, 109, 109]],
                     np.float32)
    assert cs.near_threshold(boxes, [0, 2], [0, 2], 0.5) == 0
    # box 1 has IoU 1.0 with box 0: nowhere near 0.5
    assert cs.near_threshold(boxes, [0, 2], [0, 1, 2], 0.5) == 0
    assert cs.near_threshold(boxes, [0, 2], [0, 1, 2], 1.0) > 0


def test_compile_log_records_backend_compiles():
    compiles = cs.CompileLog()
    try:
        jax.jit(lambda x: x * 3.0 + 1.0)(np.arange(7.0))
    finally:
        jax.monitoring.unregister_event_time_span_listener(compiles._record)
    names = [name for _, name, _ in compiles.events]
    assert any("lambda" in n for n in names), names
    assert "lambda" in compiles.summary(min_s=0.0)
    assert compiles.summary(since=len(compiles.events)) == "none"


def test_trainer_and_pseudo_label_phases(tmp_path):
    cs.make_datasets(str(tmp_path / "data"), seed=0, sizes=(48, 96))
    student = _tiny_yaml(tmp_path, cs.STUDENT_YAML)
    teacher = _tiny_yaml(tmp_path, cs.TEACHER_YAML)
    tr = cs.run_trainer(str(tmp_path), student, teacher, [])
    assert tr["images_per_step"] == 4
    assert [s["iter"] for s in tr["stats"]] == [0, 3]
    pl = cs.run_pseudo_labels(str(tmp_path), teacher, [])
    assert pl["images"] == 16 and pl["annotations"] > 0


def test_four_device_step_matches_one_device(capsys):
    """The --four phase on four virtual CPU devices."""
    count = cs.four_gpu_phase(jax.devices()[:4], seed=0, extra_opts=TINY,
                              h=128, w=128)
    assert count == 4
    out = capsys.readouterr().out
    assert "four: f32 SAD step" in out and "four: bf16 SAD step" in out
