"""Device-mesh distribution of the cell-parallel compute.

The reference's only parallelism is MPI domain decomposition over mesh
cells with owner-computes assembly + `compress()` halo reductions
(SURVEY.md par.2; src/NavierStokes.cpp:19-23, 164-167, 292-294).  The
Device-mesh equivalent: shard the *cell arrays* (element matrices, DoF maps)
over a 1-D ``jax.sharding.Mesh`` axis and keep DoF vectors replicated; the
scatter-add of shared-DoF contributions becomes a local segment_sum
followed by a single ``psum`` across devices.  Krylov dot products then need no
extra collectives at all (vectors are replicated).

At the reference's target scales (~1-5M DoF) the replicated DoF vectors
are a few MB — far below HBM pressure — while the cell arrays (the actual
memory and FLOP load) divide by the device count.
"""

from __future__ import annotations

import numpy as np

import jax


def device_mesh(n_devices: int = 0, axis: str = "cells"):
    """1-D mesh over the first n_devices (all visible if 0)."""
    devs = jax.devices()
    n = n_devices if n_devices > 0 else len(devs)
    return jax.sharding.Mesh(np.array(devs[:n]), (axis,))


def cell_partitioning(n_cells: int, n_devices: int = 0) -> np.ndarray:
    """Device id per cell (contiguous blocks — cells from our generators and
    from gmsh are spatially coherent in index order, so block partitioning
    approximates the reference's METIS-style spatial decomposition,
    src/NavierStokes.cpp:19).  This is the 'partitioning' VTU field."""
    n = n_devices if n_devices > 0 else max(1, len(jax.devices()))
    return np.minimum((np.arange(n_cells) * n) // max(n_cells, 1),
                      n - 1).astype(np.float64)


def pad_to_multiple(arr: np.ndarray, multiple: int, pad_value=0):
    """Pad axis 0 so its length divides evenly across devices."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = np.full((rem,) + arr.shape[1:], pad_value, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0), n
