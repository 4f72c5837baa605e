"""The package's main path needs nothing beyond JAX, numpy, scipy, optax,
chex, einops and the standard library: a fresh interpreter that cannot
import flax, yaml, PIL, cv2 or orbax imports sad_tpu, loads the in-repo
configs, and builds, initialises and applies the RetinaNet models and the
SAD train step. Also: the compile-cache placement and the loader workers'
environment."""

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("flax", "yaml", "PIL", "cv2", "orbax")

SCRIPT = textwrap.dedent(
    """
    import sys

    BLOCKED = {blocked!r}

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {{name}}")
            return None

    sys.meta_path.insert(0, Blocker())

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import sad_tpu
    from sad_tpu.config import load_cfg
    from sad_tpu.models import create_model
    from sad_tpu.models.model_builder import init_model_params
    from sad_tpu.train import TrainState, init_momentum_state, make_train_step
    import chip_smoke

    opts = ["RESNETS.CHANNEL_RATIO", "0.0625", "RETINANET.NUM_CONVS", "1",
            "COMPUTE_DTYPE", "float32", "NUM_GPUS", "1"] + chip_smoke.INIT_OPTS
    scfg = load_cfg(chip_smoke.STUDENT_YAML, opts)
    tcfg = load_cfg(chip_smoke.TEACHER_YAML, opts)
    student, teacher = create_model(scfg), create_model(tcfg)
    sp = init_model_params(student, jax.random.PRNGKey(0), (1, 128, 128, 3))
    tp = init_model_params(teacher, jax.random.PRNGKey(1), (1, 128, 128, 3))
    out = student.apply({{"params": sp}}, jnp.zeros((1, 128, 128, 3)))
    assert set(out) == {{"cls_logits", "bbox_pred", "cls_prob"}}
    batch = jax.tree_util.tree_map(
        jnp.asarray, chip_smoke.synthetic_step_batch(scfg, 2, 1, 128, 128, 0))
    step = jax.jit(make_train_step(scfg, student, teacher, n_groups=1,
                                   teacher_cfg=tcfg))
    state = TrainState(sp, init_momentum_state(sp).velocity)
    _, metrics = step(state, tp, batch, jnp.float32(1e-4))
    assert np.isfinite(float(metrics["loss"]))
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not leaked, leaked
    print("OK")
    """
)


def test_main_path_without_optional_packages():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(blocked=BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize("env_dir", [None, "/some/cache/dir"])
def test_compile_cache_placement(monkeypatch, env_dir):
    import jax

    from sad_tpu.utils import env

    before = jax.config.jax_compilation_cache_dir
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    try:
        got = env.enable_compile_cache()
        if env_dir is None:
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
            with open(os.path.join(REPO, ".gitignore")) as f:
                assert ".jax_cache/" in f.read().split()
        else:
            # JAX reads the variable itself; nothing else is set in code
            assert got == env_dir
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_loader_workers_stay_off_the_accelerator(monkeypatch):
    import multiprocessing as mp

    from sad_tpu.data.mp_loader import worker_environment

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    with worker_environment():
        assert os.environ["JAX_PLATFORMS"] == "cpu"
        with mp.get_context("spawn").Pool(1) as pool:
            child = pool.apply(os.getenv, ("JAX_PLATFORMS",))
            omp = pool.apply(os.getenv, ("OMP_NUM_THREADS",))
    assert (child, omp) == ("cpu", "1")
    assert os.environ["JAX_PLATFORMS"] == "cuda"
    assert "OMP_NUM_THREADS" not in os.environ
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    with worker_environment():
        assert os.environ["OMP_NUM_THREADS"] == "3"  # the operator's value
