"""Momentum SGD with Caffe2/Detectron semantics.

Replicates, per parameter (refs: caffe2/sgd/momentum_sgd_op.h:23-51 and
detectron/lib/modeling/optimizer.py:95-130):

    g_eff = 2 * g                   for biases (2x LR, no weight decay)
          = g + weight_decay * w    otherwise  (WeightedSum, optimizer.py:121)
    V     = momentum * V + lr * g_eff
    w     = w - V

Non-trainable params (AffineChannel scale/bias, frozen stages) get no update
op at all — here a mask. The momentum-history rescale on LR changes
(detector.py:628-648) is a separate function applied by the host loop.

Implemented as a pure pytree transform (an optax-style kernel but with the
Caffe2 LR-in-history convention, which optax.sgd does not reproduce).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class MomentumSGDState(NamedTuple):
    velocity: Any  # pytree like params


def init_momentum_state(params: Any) -> MomentumSGDState:
    return MomentumSGDState(
        velocity=jax.tree_util.tree_map(lambda p: jnp.zeros_like(p), params)
    )


def momentum_sgd_update(
    params: Any,
    grads: Any,
    state: MomentumSGDState,
    lr: jnp.ndarray,  # scalar (fed per-iter like the reference's lr blob)
    *,
    momentum: float,
    weight_decay: float,
    trainable: Any,  # pytree of bools
    is_bias: Any,  # pytree of bools
):
    """Returns (new_params, new_state)."""

    def upd(p, g, v, t, b):
        if not t:
            return p, v
        g = g.astype(jnp.float32)
        if b:
            g_eff = 2.0 * g
        else:
            g_eff = g + weight_decay * p
        v_new = momentum * v + lr * g_eff
        return (p - v_new).astype(p.dtype), v_new

    out = jax.tree_util.tree_map(
        upd, params, grads, state.velocity, trainable, is_bias
    )
    new_params = jax.tree_util.tree_map(
        lambda x: x[0], out, is_leaf=lambda x: isinstance(x, tuple)
    )
    new_vel = jax.tree_util.tree_map(
        lambda x: x[1], out, is_leaf=lambda x: isinstance(x, tuple)
    )
    return new_params, MomentumSGDState(velocity=new_vel)


def fused_momentum_sgd_update(
    params: Any,
    grads: Any,
    state: MomentumSGDState,
    lr: jnp.ndarray,
    *,
    momentum: float,
    weight_decay: float,
    trainable: Any,
    is_bias: Any,
):
    """Same Caffe2 semantics as momentum_sgd_update over ONE raveled vector.

    Within one jit program XLA already fuses the per-leaf updates, and the
    ravel/unravel concats add memory traffic, so the train steps use the
    per-leaf form; this one serves host-driven update loops (a standalone
    per-leaf update program has ~200 outputs)."""
    from jax.flatten_util import ravel_pytree

    p_vec, unravel = ravel_pytree(params)
    g_vec, _ = ravel_pytree(
        jax.tree_util.tree_map(lambda g: g.astype(jnp.float32), grads)
    )
    v_vec, _ = ravel_pytree(state.velocity)

    def role_vec(fn):
        parts = [
            jnp.full((int(np.prod(p.shape)) if p.shape else 1,), fn(t, b), jnp.float32)
            for p, t, b in zip(
                jax.tree_util.tree_leaves(params),
                jax.tree_util.tree_leaves(trainable),
                jax.tree_util.tree_leaves(is_bias),
            )
        ]
        return jnp.concatenate(parts)

    grad_mul = role_vec(lambda t, b: (2.0 if b else 1.0) if t else 0.0)
    wd = role_vec(lambda t, b: weight_decay if (t and not b) else 0.0)
    train = role_vec(lambda t, b: 1.0 if t else 0.0)

    g_eff = g_vec * grad_mul + wd * p_vec
    v_new = (momentum * v_vec + lr * g_eff) * train  # frozen keep zero history
    p_new = p_vec - v_new
    return unravel(p_new), MomentumSGDState(velocity=unravel(v_new))


def rescale_momentum(state: MomentumSGDState, correction: float, trainable: Any):
    """V *= correction for trainable params (detector.py:628-648)."""
    new_v = jax.tree_util.tree_map(
        lambda v, t: v * correction if t else v, state.velocity, trainable
    )
    return MomentumSGDState(velocity=new_v)
