"""Equivalence of the grouped-conv phrasings (ops/grouped_conv.py).

Every packed phrasing must reproduce the XLA feature_group_count conv —
values AND gradients — since the backbone may swap them at trace time
underneath unchanged checkpoints (ResNeXt grouped 3x3,
detectron/lib/modeling/ResNet.py:244-255).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sad_tpu.ops import grouped_conv as gc


def _mk(n, h, w, c, groups, cout=None, k=3, seed=0):
    cout = cout or c
    key = jax.random.PRNGKey(seed)
    kx, kk = jax.random.split(key)
    x = jax.random.normal(kx, (n, h, w, c), jnp.float32)
    kern = jax.random.normal(kk, (k, k, c // groups, cout), jnp.float32) * 0.1
    return x, kern


CASES = [
    # (groups, cg) covering the X-101 stages plus a non-square spatial
    dict(n=2, h=10, w=14, c=64, groups=16),          # cg=4
    dict(n=1, h=8, w=8, c=64, groups=8),             # cg=8
    dict(n=2, h=6, w=6, c=128, groups=4),            # cg=32
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("pack_spec", ["1", "lane", "dense", "2"])
def test_packed_matches_fgc(case, pack_spec):
    x, kern = _mk(**case)
    groups = case["groups"]
    pack = gc.resolve_pack(pack_spec, groups, case["c"] // groups)
    if groups % pack:
        pytest.skip("pack incompatible")
    ref = gc.grouped_conv_fgc(x, kern, groups)
    got = gc.grouped_conv_packed(x, kern, groups, pack)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stride,dilation", [(2, 1), (1, 2)])
def test_packed_stride_dilation(stride, dilation):
    x, kern = _mk(n=2, h=12, w=10, c=64, groups=16)
    ref = gc.grouped_conv_fgc(x, kern, 16, stride, dilation)
    got = gc.grouped_conv_packed(x, kern, 16, 4, stride, dilation)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_packed_non_square_group_widths():
    # cg_in != cg_out (C_in 64 -> C_out 128 with 16 groups)
    x, kern = _mk(n=1, h=7, w=9, c=64, groups=16, cout=128)
    ref = gc.grouped_conv_fgc(x, kern, 16)
    got = gc.grouped_conv_packed(x, kern, 16, 8)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pack", [1, 4, 16])
def test_gradients_match_fgc(pack):
    x, kern = _mk(n=1, h=6, w=6, c=64, groups=16)

    def loss(fn):
        def f(x, k):
            y = fn(x, k)
            return jnp.sum(jnp.sin(y))
        return jax.grad(f, argnums=(0, 1))

    gx_ref, gk_ref = loss(lambda x, k: gc.grouped_conv_fgc(x, k, 16))(x, kern)
    gx, gk = loss(lambda x, k: gc.grouped_conv_packed(x, k, 16, pack))(x, kern)
    np.testing.assert_allclose(gx, gx_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gk, gk_ref, rtol=1e-5, atol=1e-5)


def test_resolve_pack():
    assert gc.resolve_pack("fgc", 64, 4) is None
    # auto = XLA feature_group_count on every backend
    assert gc.resolve_pack("auto", 64, 4) is None
    assert gc.resolve_pack("dense", 64, 4) == 64
    assert gc.resolve_pack("lane", 64, 4) == 32
    assert gc.resolve_pack("lane", 64, 32) == 4
    assert gc.resolve_pack("lane", 4, 4) == 4  # capped at groups
    assert gc.resolve_pack("8", 64, 4) == 8
    with pytest.raises(ValueError):
        gc.resolve_pack("7", 64, 4)


def test_dispatch_env_override(monkeypatch):
    x, kern = _mk(n=1, h=6, w=6, c=64, groups=16)
    ref = gc.grouped_conv_fgc(x, kern, 16)
    monkeypatch.setattr(gc, "GROUPED_CONV_IMPL", "lane")
    got = gc.grouped_conv(x, kern, 16)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_pack_block_diagonal_layout():
    # channel order of the packed output features must be (b, p, co) == g-major
    kern = jnp.arange(2 * 3 * 8, dtype=jnp.float32).reshape(1, 1, 2, 24) / 48.0
    packed = gc.pack_block_diagonal(kern, groups=4, pack=2)
    assert packed.shape == (1, 1, 4, 24)
    k6 = np.asarray(kern).reshape(1, 1, 2, 4, 6)
    p = np.asarray(packed).reshape(1, 1, 2, 2, 2, 2, 6)  # (q, ci, b, p, co)
    for q in range(2):
        for b in range(2):
            for pp in range(2):
                blk = p[0, 0, q, :, b, pp, :]
                if pp == q:
                    np.testing.assert_array_equal(blk, k6[0, 0, :, b * 2 + pp, :])
                else:
                    assert (blk == 0).all()


def test_resnext_body_param_tree_and_phrasing_equivalence():
    """The GroupedConv module keeps nn.Conv's param tree (name 'kernel',
    shape (3,3,cg,features)) and the full ResNeXt trunk is numerically
    identical under every phrasing (trace-time swap, unchanged weights)."""
    from sad_tpu.models.arch import ModelArch
    from sad_tpu.models import resnet as rn

    arch = ModelArch(
        depth=50, block_counts=(1, 1, 1, 1), num_groups=8, width_per_group=4,
        stride_1x1=True, channel_ratio=1.0, res5_dilation=1, freeze_at=0,
        fpn_dim=16, zero_init_lateral=False, min_level=3, max_level=7,
        extra_conv_levels=True, num_classes=5, aspect_ratios=(1.0,),
        scales_per_octave=1, anchor_scale=4.0, num_convs=1, prior_prob=0.01,
        share_cls_bbox_tower=False, class_specific_bbox=False, softmax=False,
        compute_dtype="float32")
    body = rn.ResNetBody(arch)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32, 3), jnp.float32)
    params = body.init(jax.random.PRNGKey(0), x)
    b0 = params["params"]["Bottleneck_0"]
    assert b0["res2_0_branch2b"]["kernel"].shape == (3, 3, 4, 32)
    orig_impl = gc.GROUPED_CONV_IMPL
    try:
        gc.GROUPED_CONV_IMPL = "fgc"
        y_ref = body.apply(params, x)
    finally:
        gc.GROUPED_CONV_IMPL = orig_impl
    for impl in ("lane", "1"):
        try:
            gc.GROUPED_CONV_IMPL = impl
            y = body.apply(params, x)
        finally:
            gc.GROUPED_CONV_IMPL = orig_impl
        for name in y_ref:
            np.testing.assert_allclose(
                y[name], y_ref[name], rtol=2e-4, atol=2e-4)
