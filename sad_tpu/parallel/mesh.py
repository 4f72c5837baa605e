"""Device mesh and sharding helpers.

This module replaces for the reference's entire
distributed stack (SURVEY.md §5.8): muji ring allreduce
(caffe2/python/muji.py:47-183), NCCL ops (contrib/nccl/cuda_nccl_op_gpu.cc),
Gloo ops + rendezvous stores (contrib/gloo, distributed/), MPI ops
(mpi/mpi_ops.cc), and the host-mediated parameter broadcast
(lib/utils/net.py:185-208).

Here all of that is one `jax.sharding.Mesh`: parameters are replicated by
sharding (no broadcast step), and gradient reduction is an all-reduce XLA
inserts because the loss sums over the batch axis (NCCL over NVLink between
the GPUs of one host).

Axes:
  'data'  — data parallel (the only parallelism the reference trains with)
  'model' — reserved for spatial/tensor sharding of very large inputs
            (the CNN analogue of sequence parallelism, SURVEY.md §5.7);
            size 1 by default.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def create_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devices) // n_model
    assert n_data * n_model == len(devices), (
        f"mesh {n_data}x{n_model} != {len(devices)} devices"
    )
    arr = np.asarray(devices).reshape(n_data, n_model)
    return Mesh(arr, ("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch/group) dim over the 'data' axis."""
    return NamedSharding(mesh, P("data"))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def spatial_sharding(mesh: Mesh) -> NamedSharding:
    """Shard (B, H, W, C) images: batch over the data axes, image HEIGHT
    over the 'model' axis — the CNN analogue of sequence parallelism
    (SURVEY.md §5.7). XLA partitions the convolutions spatially and inserts
    the halo exchanges; outputs match a replicated run to roundoff (see
    tests). Use for inputs too large for one device's memory."""
    return NamedSharding(mesh, P("data", "model", None, None))


def shard_batch_tree(batch, mesh: Mesh):
    """Apply leading-dim data sharding to every array in a batch pytree.

    1-D arrays whose leading dim is not divisible by the data axis (e.g. the
    per-group fg_num vector when groups < devices) are replicated instead —
    they are tiny, and XLA reshards them where needed. A non-divisible
    array of rank >= 2 is a misshaped batch (it would silently train
    replicated), so it raises instead."""
    s = batch_sharding(mesh)
    rep = replicated_sharding(mesh)
    n = mesh.shape["data"]

    def put(x):
        arr = np.asarray(x) if not hasattr(x, "shape") else x
        if arr.ndim >= 1 and arr.shape[0] % n == 0 and arr.shape[0] > 0:
            return jax.device_put(x, s)
        if arr.ndim >= 2:
            raise ValueError(
                f"batch array of shape {arr.shape} cannot be data-sharded "
                f"over {n} devices (leading dim not divisible); fix the "
                "batch size instead of training replicated"
            )
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map(put, batch)
