"""The GPU greedy-NMS kernel (ops/pallas_nms.py) against nms_fixed and a
numpy oracle, in the Pallas interpreter, plus the choice of implementation
in ops/nms.greedy_nms and the kernel's lowering for CUDA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sad_tpu.ops import nms as nms_mod
from sad_tpu.ops.nms import NEG_INF, greedy_nms, nms_fixed
from sad_tpu.ops.pallas_nms import MAX_K, nms_pallas, num_warps_for


def np_nms(boxes, scores, thr, max_out):
    """Plain numpy greedy NMS (legacy +1 IoU, first index among ties)."""
    live = scores.astype(np.float64).copy()
    b = boxes.astype(np.float64)
    areas = (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1)
    keep = []
    while len(keep) < max_out and live.max() > NEG_INF:
        i = int(np.argmax(live))
        keep.append(i)
        iw = np.maximum(
            np.minimum(b[i, 2], b[:, 2]) - np.maximum(b[i, 0], b[:, 0]) + 1, 0
        )
        ih = np.maximum(
            np.minimum(b[i, 3], b[:, 3]) - np.maximum(b[i, 1], b[:, 1]) + 1, 0
        )
        inter = iw * ih
        live[inter / (areas[i] + areas - inter) > thr] = NEG_INF
        live[i] = NEG_INF
    return keep


def _problems(seed, n, k, ties, clusters=40):
    """Clustered boxes so real suppression happens; with ties, scores come
    from a few levels so many candidates share the maximum."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 600, (n, clusters, 2))
    which = rng.randint(0, clusters, (n, k))
    xy = np.take_along_axis(centers, which[..., None], 1)
    xy = xy + rng.uniform(-8, 8, (n, k, 2))
    wh = rng.uniform(10, 60, (n, k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    if ties:
        scores = rng.randint(1, 6, (n, k)).astype(np.float32) / 8.0
    else:
        scores = rng.uniform(0.01, 1.0, (n, k)).astype(np.float32)
    return boxes, scores


# (problems, candidates, picks): decode-like (class-offset boxes, 100
# picks) and RPN-like (more candidates and picks), cut to interpreter size
SCALES = {"decode": (3, 700, 100), "rpn": (2, 1500, 300)}


@pytest.mark.parametrize("scale", sorted(SCALES))
@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("ties", [False, True])
def test_kernel_matches_nms_fixed_and_numpy(scale, thr, ties):
    n, k, max_out = SCALES[scale]
    boxes, scores = _problems(hash((scale, thr, ties)) % 1000, n, k, ties)
    idx, valid = nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), thr, max_out, interpret=True
    )
    ref_idx, ref_valid = jax.vmap(
        lambda b, s: nms_fixed(b, s, thr, max_out)
    )(boxes, scores)
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(ref_valid))
    np.testing.assert_array_equal(np.asarray(idx), np.asarray(ref_idx))
    for p in range(n):
        keep = np.asarray(idx[p])[np.asarray(valid[p])]
        assert keep.tolist() == np_nms(boxes[p], scores[p], thr, max_out)


def test_padding_and_invalid_tail():
    """K not a power of two, max_out not a power of two, invalid tail."""
    boxes, scores = _problems(5, 2, 77, False)
    scores[:, 40:] = NEG_INF
    idx, valid = nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, 60, interpret=True
    )
    assert idx.shape == valid.shape == (2, 60)
    for p in range(2):
        i1, v1 = nms_fixed(jnp.asarray(boxes[p]), jnp.asarray(scores[p]), 0.5, 60)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(valid[p]))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(idx[p]))
        assert not np.asarray(valid[p])[40:].any()  # fewer picks than max_out


def test_all_invalid_problem():
    boxes, scores = _problems(6, 3, 16, False)
    scores[1] = NEG_INF
    idx, valid = nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), 0.5, 10, interpret=True
    )
    assert not np.asarray(valid[1]).any()
    np.testing.assert_array_equal(np.asarray(idx[1]), 0)
    assert np.asarray(valid[0]).any()


def test_kernel_refuses_candidates_beyond_max_k():
    boxes = jnp.zeros((1, MAX_K + 1, 4))
    with pytest.raises(ValueError, match="MAX_K"):
        nms_pallas(boxes, jnp.zeros((1, MAX_K + 1)), 0.5, 10, interpret=True)


def test_choice_of_implementation_is_by_candidate_count():
    assert nms_mod.uses_kernel(5 * 1000)  # decode: 5 levels x 1000
    assert nms_mod.uses_kernel(12000)  # RPN pre-NMS top-N pads to MAX_K
    assert not nms_mod.uses_kernel(MAX_K + 1)
    assert not nms_mod.uses_kernel(1000 * 80)  # R-CNN class-wise decode
    assert num_warps_for(128) == 4 and num_warps_for(16384) == 32


def _lowered(platform, k, max_out):
    return jax.export.export(
        jax.jit(lambda b, s: greedy_nms(b, s, 0.5, max_out)),
        platforms=[platform],
        disabled_checks=[jax.export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")],
    )(
        jax.ShapeDtypeStruct((4, k, 4), jnp.float32),
        jax.ShapeDtypeStruct((4, k), jnp.float32),
    ).mlir_module()


@pytest.mark.parametrize(
    "k, max_out, kernel",
    [(5000, 100, True), (12000, 2000, True), (MAX_K + 1, 100, False)],
)
def test_greedy_nms_lowers_the_kernel_for_cuda_only(k, max_out, kernel):
    """Lowering for CUDA (no GPU needed) runs the Triton lowering of the
    kernel at real widths; the CPU lowering of the same call is nms_fixed."""
    assert ("xla.gpu.triton" in _lowered("cuda", k, max_out)) == kernel
    assert "xla.gpu.triton" not in _lowered("cpu", k, max_out)


def test_greedy_nms_on_cpu_equals_nms_fixed():
    boxes, scores = _problems(9, 3, 200, True)
    idx, valid = greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.4, 30)
    for p in range(3):
        i1, v1 = nms_fixed(jnp.asarray(boxes[p]), jnp.asarray(scores[p]), 0.4, 30)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(valid[p]))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(idx[p]))


def test_nms_levels_batched_matches_per_image_generate_proposals():
    """The batched proposal path (proposal_candidates under vmap + one
    nms_levels_batched call) must reproduce the per-(level, image)
    generate_proposals results exactly, including levels with different
    candidate counts (padding semantics)."""
    from sad_tpu.ops.proposals import (
        generate_proposals,
        nms_levels_batched,
        proposal_candidates,
    )

    rng = np.random.RandomState(7)
    b = 3
    post_n, thr, pre_n = 40, 0.6, 120
    im_hw = jnp.asarray(
        rng.uniform(200, 400, (b, 2)).astype(np.float32)
    )
    levels = {}
    for lvl, (h, w) in {3: (16, 24), 4: (8, 12)}.items():
        a = 3
        anchors = jnp.asarray(
            np.stack(
                [
                    rng.uniform(0, 300, (h, w, a)),
                    rng.uniform(0, 300, (h, w, a)),
                    rng.uniform(40, 120, (h, w, a)),
                    rng.uniform(40, 120, (h, w, a)),
                ],
                axis=-1,
            ).astype(np.float32)
        )
        anchors = anchors.at[..., 2:].set(
            anchors[..., :2] + anchors[..., 2:]
        )
        scores = jnp.asarray(
            rng.uniform(0, 1, (b, h, w, a)).astype(np.float32)
        )
        deltas = jnp.asarray(
            rng.uniform(-0.3, 0.3, (b, h, w, a, 4)).astype(np.float32)
        )
        levels[lvl] = (scores, deltas, anchors)

    prop_levels = []
    for lvl, (scores, deltas, anchors) in levels.items():
        bx, ts, ms = jax.vmap(
            lambda s, d, ihw, a=anchors: proposal_candidates(
                s, d, a, ihw, pre_n, 8.0
            )
        )(scores, deltas, im_hw)
        prop_levels.append((lvl, bx, ts, ms))
    lv_b, lv_s, lv_v = nms_levels_batched(prop_levels, thr, post_n)

    for lvl, (scores, deltas, anchors) in levels.items():
        for i in range(b):
            ref_b, ref_s, ref_v = generate_proposals(
                scores[i], deltas[i], anchors, im_hw[i],
                pre_n, post_n, thr, 8.0,
            )
            np.testing.assert_array_equal(
                np.asarray(ref_v), np.asarray(lv_v[lvl][i])
            )
            m = np.asarray(ref_v)
            np.testing.assert_allclose(
                np.asarray(ref_b)[m], np.asarray(lv_b[lvl][i])[m], rtol=1e-6
            )
            np.testing.assert_allclose(
                np.asarray(ref_s)[m], np.asarray(lv_s[lvl][i])[m], rtol=1e-6
            )


def test_proposal_candidates_approx_branch_matches_exact_on_cpu():
    """cfg.RPN.EXACT_TOPK=False routes the pre-NMS candidate top-k through
    jax.lax.approx_max_k at recall 0.99. On CPU and GPU the approx
    lowering is exact, so both settings must select the same candidates
    (same policy as TEST.EXACT_TOPK, tests/test_parity_e2e.py)."""
    from sad_tpu.ops.proposals import proposal_candidates

    rng = np.random.RandomState(11)
    h, w, a = 32, 48, 3
    anchors = np.stack(
        [
            rng.uniform(0, 300, (h, w, a)),
            rng.uniform(0, 300, (h, w, a)),
            rng.uniform(40, 120, (h, w, a)),
            rng.uniform(40, 120, (h, w, a)),
        ],
        axis=-1,
    ).astype(np.float32)
    anchors[..., 2:] += anchors[..., :2]
    scores = jnp.asarray(rng.uniform(0, 1, (h, w, a)).astype(np.float32))
    deltas = jnp.asarray(
        rng.uniform(-0.3, 0.3, (h, w, a, 4)).astype(np.float32)
    )
    im_hw = jnp.asarray([320.0, 320.0], jnp.float32)

    # pre_n < total scores so the k < flat branch (the approx call) is
    # taken. Both variants run under the same jit wrapper: the comparison
    # isolates the top-k operator choice, not jit-vs-eager fusion noise.
    def run(exact):
        return jax.jit(
            lambda s, d, ihw: proposal_candidates(
                s, d, jnp.asarray(anchors), ihw, 500, 8.0,
                exact_topk=exact,
            )
        )(scores, deltas, im_hw)

    # Compare as a canonical-sorted set of candidate rows rather than
    # positionally: positional bitwise equality would rely on the
    # approx_max_k lowering's tie ordering — an XLA implementation detail,
    # not a contract. Same candidate multiset ⇒
    # identical downstream NMS behavior.
    def rows(out):
        boxes, top_scores, masked_scores = (np.asarray(o) for o in out)
        stacked = np.concatenate(
            [top_scores[:, None], masked_scores[:, None], boxes], axis=1
        )
        return stacked[np.lexsort(stacked.T[::-1])]

    np.testing.assert_allclose(rows(run(True)), rows(run(False)), rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("k, max_out, thr", [(5000, 100, 0.5), (12000, 2000, 0.7)])
def test_compiled_kernel_matches_nms_fixed_on_gpu(gpu_device, k, max_out, thr):
    """The kernel compiled by Triton on the card, at decode and RPN scale."""
    boxes, scores = _problems(11, 2, k, ties=True)
    idx, valid = nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), thr, max_out)
    for p in range(2):
        i1, v1 = nms_fixed(jnp.asarray(boxes[p]), jnp.asarray(scores[p]), thr, max_out)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(valid[p]))
        np.testing.assert_array_equal(np.asarray(i1), np.asarray(idx[p]))
