"""Top-k selection for the score-grid hot paths (decode + RPN candidates).

The reference selects detection candidates with a sort-based top-k
(lib/core/test_retinanet.py:120-135 `np.argsort`). At the decode geometry
P3 alone is 80*128*9*80 = 7.37M scores per image.

Both settings go through XLA's ApproxTopK (`jax.lax.approx_max_k`).
``exact=True`` (TEST.EXACT_TOPK / RPN.EXACT_TOPK, the default) asks for
``recall_target=1.0``; the GPU and CPU lowerings of ApproxTopK are exact,
so this is the exact top-k multiset. On the GPU it is never slower than
the sort behind ``lax.top_k`` (PERF.md). ``exact=False`` asks for
``recall_target=0.99``, which the GPU lowering also computes exactly.

Which indices are reported when several elements tie at the k-th value is
implementation-defined: the multiset of (score, element) pairs is exact,
tie identity at the boundary is not — the same class of nondeterminism
the reference's GPU sort has, and the reason parity tests compare score
sets rather than tie order.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def top_k(
    x: jnp.ndarray, k: int, exact: bool = True
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k over the last axis; returns (values desc-sorted, indices)."""
    if k >= x.shape[-1]:
        # Degenerate: nothing to select; approx_max_k requires k <= n too.
        return jax.lax.top_k(x, min(k, x.shape[-1]))
    return jax.lax.approx_max_k(x, k, recall_target=1.0 if exact else 0.99)
