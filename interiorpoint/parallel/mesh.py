"""Device-mesh helpers.

The reference is single-process/single-device (SURVEY.md §2.2: no
torch.distributed/NCCL/MPI anywhere); all multi-device capability here is
new: ``jax.sharding.Mesh`` + NamedSharding for data layout, XLA collectives
(psum/all_gather) for the cross-device reductions.  Meshes are flat 1-D:
every device reaches every other at the same rate (all-to-all NVLink), so
the mesh follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("batch",),
              shape: Optional[Sequence[int]] = None) -> Mesh:
    """Build a mesh over the first ``n_devices`` devices.

    With one axis name the mesh is 1-D; pass ``shape`` for multi-axis
    meshes (e.g. shape=(2, 4), axis_names=("batch", "rows")).
    """
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if shape is None:
        shape = (len(devs),) if len(axis_names) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    arr = np.array(devs).reshape(shape)
    return Mesh(arr, axis_names=tuple(axis_names))


def batch_sharding(mesh: Mesh, axis: str = "batch", ndim: int = 1,
                   batch_dim: int = 0) -> NamedSharding:
    """NamedSharding placing ``batch_dim`` of an ndim-array on ``axis``."""
    spec = [None] * ndim
    spec[batch_dim] = axis
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
