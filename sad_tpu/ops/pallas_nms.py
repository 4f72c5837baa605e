"""Greedy NMS as a Pallas kernel for NVIDIA GPUs (Triton route).

The plain form (ops/nms.py nms_fixed) runs ``max_out`` dependent
`fori_loop` steps, each a few tiny fused kernels (argmax over K, one-vs-all
IoU, masked suppression), so on a GPU it is bound by kernel launches, not
by arithmetic. This kernel runs the whole greedy loop inside one program
per problem: the candidates' scores and box coordinates stay in registers,
picks accumulate into an output vector through a one-hot select and are
stored once at the end, and a batch of problems spreads over the SMs, one
program each.

Semantics are those of nms_fixed (ref: lib/utils/cython_nms.pyx greedy
order, legacy +1 IoU): at each step pick the highest-scoring live
candidate (the lowest index among equal scores), emit it, and suppress it
and every candidate whose IoU with it exceeds the threshold. Candidates
with NEG_INF scores are never emitted (``valid`` False). The kernel's
division may round differently from XLA's, so a candidate whose IoU lies
within about 1e-6 of the threshold can be kept by one and suppressed by the
other.

Triton wants power-of-two block shapes: K pads to ``next_pow2(K)`` with
NEG_INF scores, ``max_out`` to ``next_pow2(max_out)``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_NEG = -1e30  # ops.nms.NEG_INF as a python float: kernels must not
# capture traced constants

# Largest padded candidate count one program holds (the RPN's 12000
# pre-NMS candidates pad to 16384). Above it ops.nms uses nms_fixed.
MAX_K = 16384


def next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def num_warps_for(kp: int) -> int:
    """Warps per program: about 16 candidates per thread, 4 to 32 warps."""
    return int(min(32, max(4, kp // 512)))


def _nms_kernel(x1_ref, y1_ref, x2_ref, y2_ref, s_ref, idx_ref, valid_ref,
                *, kp: int, mp: int, max_out: int, iou_threshold: float):
    x1 = x1_ref[...]
    y1 = y1_ref[...]
    x2 = x2_ref[...]
    y2 = y2_ref[...]
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    lane = jax.lax.broadcasted_iota(jnp.int32, (kp,), 0)
    slot = jax.lax.broadcasted_iota(jnp.int32, (mp,), 0)

    def body(i, carry):
        live, out_idx, out_valid = carry
        best = jnp.max(live)
        pick = jnp.min(jnp.where(live == best, lane, kp))
        valid = best > _NEG
        hit = lane == pick
        px1 = jnp.sum(jnp.where(hit, x1, 0.0))
        py1 = jnp.sum(jnp.where(hit, y1, 0.0))
        px2 = jnp.sum(jnp.where(hit, x2, 0.0))
        py2 = jnp.sum(jnp.where(hit, y2, 0.0))
        parea = (px2 - px1 + 1.0) * (py2 - py1 + 1.0)
        iw = jnp.maximum(jnp.minimum(px2, x2) - jnp.maximum(px1, x1) + 1.0, 0.0)
        ih = jnp.maximum(jnp.minimum(py2, y2) - jnp.maximum(py1, y1) + 1.0, 0.0)
        inter = iw * ih
        iou = inter / (parea + areas - inter)
        suppress = valid & ((iou > iou_threshold) | hit)
        live = jnp.where(suppress, _NEG, live)
        here = slot == i
        out_idx = jnp.where(here, jnp.where(valid, pick, 0), out_idx)
        out_valid = jnp.where(here, valid.astype(jnp.int32), out_valid)
        return live, out_idx, out_valid

    zeros = jnp.zeros((mp,), jnp.int32)
    _, out_idx, out_valid = jax.lax.fori_loop(
        0, max_out, body, (s_ref[...], zeros, zeros)
    )
    idx_ref[...] = out_idx
    valid_ref[...] = out_valid


@functools.partial(jax.jit, static_argnums=(2, 3), static_argnames=("interpret",))
def nms_pallas(
    boxes: jnp.ndarray,  # (N, K, 4)
    scores: jnp.ndarray,  # (N, K); invalid candidates carry NEG_INF
    iou_threshold: float,
    max_out: int,
    *,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """N independent greedy-NMS problems, one kernel program each.

    Returns (idx (N, max_out) int32, valid (N, max_out) bool), per problem
    the keep sequence of nms_fixed. ``interpret=True`` runs the kernel in
    the Pallas interpreter (tests on a CPU)."""
    n, k, _ = boxes.shape
    kp, mp = next_pow2(k), next_pow2(max_out)
    if kp > MAX_K:
        raise ValueError(f"{k} candidates exceed the kernel's MAX_K={MAX_K}")
    planes = jnp.pad(
        boxes.astype(jnp.float32), ((0, 0), (0, kp - k), (0, 0))
    ).transpose(2, 0, 1)  # (4, N, kp)
    rows = jnp.pad(
        scores.astype(jnp.float32), ((0, 0), (0, kp - k)),
        constant_values=_NEG,
    )
    kernel = functools.partial(
        _nms_kernel, kp=kp, mp=mp, max_out=max_out,
        iou_threshold=float(iou_threshold),
    )
    in_spec = pl.BlockSpec((None, kp), lambda i: (i, 0))
    out_spec = pl.BlockSpec((None, mp), lambda i: (i, 0))
    idx, valid = pl.pallas_call(
        kernel,
        grid=(n,),
        in_specs=[in_spec] * 5,
        out_specs=[out_spec, out_spec],
        out_shape=[jax.ShapeDtypeStruct((n, mp), jnp.int32)] * 2,
        compiler_params=pltriton.CompilerParams(
            num_warps=num_warps_for(kp), num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name="greedy_nms",
    )(planes[0], planes[1], planes[2], planes[3], rows)
    return idx[:, :max_out], valid[:, :max_out] > 0
