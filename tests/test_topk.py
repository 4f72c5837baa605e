"""ops.topk: the shared top-k for decode + RPN candidates.

These tests pin the CPU-visible contracts: the exact multiset, tied
fields, the degenerate k >= n path, and both recall settings. The GPU
timing and the equality with lax.top_k at decode width run in
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sad_tpu.ops import topk


def _multiset_equal(a, b):
    return np.array_equal(np.sort(np.asarray(a)), np.sort(np.asarray(b)))


@pytest.mark.parametrize("exact", [True, False])
def test_same_multiset_as_sort(exact):
    arr = np.random.RandomState(0).rand(4096).astype(np.float32)
    x = jnp.asarray(arr)
    vs, inds = jax.jit(lambda x: topk.top_k(x, 100, exact=exact))(x)
    ref_vs, _ = jax.lax.top_k(x, 100)
    assert _multiset_equal(vs, ref_vs)
    # indices point at elements carrying the reported score
    assert np.array_equal(arr[np.asarray(inds)], np.asarray(vs))
    # values descend
    v = np.asarray(vs)
    assert np.all(v[:-1] >= v[1:])


@pytest.mark.parametrize("exact", [True, False])
def test_tied_field(exact):
    # every element ties at the k-th value: multiset must still be exact
    x = jnp.full((512,), 0.25, jnp.float32)
    vs, inds = topk.top_k(x, 32, exact=exact)
    assert _multiset_equal(vs, np.full(32, 0.25, np.float32))
    assert len(set(np.asarray(inds).tolist())) == 32  # distinct elements


def test_k_ge_n_degenerate():
    x = jnp.asarray(np.random.RandomState(1).rand(16).astype(np.float32))
    vs, _ = topk.top_k(x, 16)
    assert _multiset_equal(vs, x)


def test_quantized_scores_batched():
    # many ties at the boundary, several rows at once (decode runs per image
    # under vmap): each row's score multiset equals the sort's
    arr = np.round(np.random.RandomState(2).rand(3, 2048) * 8.0) / 8.0
    x = jnp.asarray(arr.astype(np.float32))
    vs, inds = jax.vmap(lambda r: topk.top_k(r, 64))(x)
    ref_vs, _ = jax.lax.top_k(x, 64)
    for row in range(3):
        assert _multiset_equal(vs[row], ref_vs[row])
        assert np.array_equal(arr[row][np.asarray(inds[row])], np.asarray(vs[row]))
