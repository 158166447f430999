"""Explicit shard_map versions of the cell-parallel operators.

The device-mesh equivalent of the reference's MPI owner-computes assembly +
``compress()`` reduction (src/NavierStokes.cpp:164-167, 292-294) and of the
ghost import/export inside every Trilinos SpMV (SURVEY.md par.3.1):

  * cell arrays (element matrices, DoF maps, scatter plans) are sharded on
    a 1-D device-mesh axis;
  * DoF vectors are replicated (a few MB at the reference's scales);
  * each operator application = local gather/einsum/segment_sum followed by
    one ``psum`` across devices — the single collective per matvec.

Krylov dot products need no collectives at all (vectors replicated), unlike
the reference where every dot is an MPI allreduce.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from navierstokes_tpu.ops.assembly import CellArrays
from navierstokes_tpu.ops.operators import (Scatter, apply_blocks,
                                            convection_matrices,
                                            curved_convection_fix, f_diag,
                                            mass_apply, schur_diag)

AXIS = "cells"


def shard_problem(cells: CellArrays, space, mesh: jax.sharding.Mesh,
                  dtype=jnp.float32):
    """Pad the cell set to a device multiple, build per-shard scatter plans,
    and device_put everything with cells-axis sharding.

    Returns (cells_sharded, scat_v_stacked, scat_p_stacked, n_real_cells).
    Padding cells have zero element matrices / detj / jinv, so they
    contribute nothing (the analogue of not owning a cell).
    """
    d = mesh.devices.size
    nc = int(cells.cell_p2.shape[0])
    nc_pad = ((nc + d - 1) // d) * d
    pad = nc_pad - nc

    def pad0(a, value=0):
        a = np.asarray(a)
        if pad == 0:
            return a
        p_ = np.full((pad,) + a.shape[1:], value, dtype=a.dtype)
        return np.concatenate([a, p_], axis=0)

    cp2 = pad0(cells.cell_p2)
    cp1 = pad0(cells.cell_p1)
    padded = CellArrays(
        cell_p2=cp2, cell_p1=cp1,
        detj=pad0(cells.detj), jinv=pad0(cells.jinv),
        mass=pad0(cells.mass), stiff=pad0(cells.stiff),
        grad=pad0(cells.grad))
    # curved-cell convection data rides REPLICATED (tiny — the obstacle
    # boundary layer); ShardedOps.convection applies the fix outside the
    # sharded region, where ids address the global cell axis
    curv = jax.tree.map(np.asarray,
                        (cells.curv_ids, cells.curv_nodes,
                         cells.curv_phi, cells.curv_dphys))

    # per-shard scatter plans (local flat index -> global node id)
    def stacked_scatter(ids, num_segments):
        ids = ids.reshape(d, -1)
        orders, sids = [], []
        for k in range(d):
            flat = ids[k].reshape(-1)
            o = np.argsort(flat, kind="stable")
            orders.append(o.astype(np.int32))
            sids.append(flat[o].astype(np.int32))
        return Scatter(order=jnp.asarray(np.stack(orders)),
                       sorted_ids=jnp.asarray(np.stack(sids)),
                       num_segments=num_segments)

    scat_v = stacked_scatter(cp2, space.n_p2)
    scat_p = stacked_scatter(cp1, space.n_p1)

    shard = NamedSharding(mesh, P(AXIS))
    put = lambda a: jax.device_put(jnp.asarray(a), shard)
    cells_sh = jax.tree.map(put, padded)
    if curv[0] is not None:
        rep = NamedSharding(mesh, P())
        ci, cn, cp, cg = (jax.device_put(jnp.asarray(a), rep) for a in curv)
        cells_sh = dataclasses.replace(cells_sh, curv_ids=ci, curv_nodes=cn,
                                       curv_phi=cp, curv_dphys=cg)
    scat_v = Scatter(put(scat_v.order), put(scat_v.sorted_ids),
                     scat_v.num_segments)
    scat_p = Scatter(put(scat_p.order), put(scat_p.sorted_ids),
                     scat_p.num_segments)
    return cells_sh, scat_v, scat_p, nc


def _local(scat: Scatter) -> Scatter:
    """Inside shard_map: (1, n) stacked rows -> this shard's plan."""
    return Scatter(order=scat.order[0], sorted_ids=scat.sorted_ids[0],
                   num_segments=scat.num_segments)


def _bare(cells: CellArrays) -> CellArrays:
    """Drop the replicated curved-cell leaves: the shard_map regions see
    only local cells, so the blanket P(AXIS) spec must not touch them."""
    if cells.curv_ids is None:
        return cells
    return dataclasses.replace(cells, curv_ids=None, curv_nodes=None,
                               curv_phi=None, curv_dphys=None)


class ShardedOps:
    """Drop-in replacements for the ops/operators.py entry points, running
    under shard_map over the given mesh.  Methods mirror SingleDeviceOps
    (models/navier_stokes.py)."""

    def __init__(self, mesh: jax.sharding.Mesh):
        self.mesh = mesh

    def _smap(self, f, in_specs, out_specs):
        return jax.shard_map(f, mesh=self.mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    def convection(self, params, u):
        # affine bulk sharded; the (global-cell-indexed) curved fix runs on
        # the replicated data outside the sharded region
        def f(cells, t_hat, u):
            return convection_matrices(cells, t_hat, u)

        c = self._smap(f, (P(AXIS), P(), P()), P(AXIS))(
            _bare(params.cells), params.t_hat, u)
        return curved_convection_fix(params.cells, c, u)

    def apply_blocks(self, params, f_cell, xu, xp, with_f=True, with_g=True,
                     with_gt=True):
        def f(cells, fc, sv, sp, xu, xp):
            yu, yp = apply_blocks(cells, fc, _local(sv), _local(sp), xu, xp,
                                  with_f=with_f, with_g=with_g,
                                  with_gt=with_gt)
            return jax.lax.psum((yu, yp), AXIS)

        return self._smap(f, (P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(), P()),
                          (P(), P()))(
            _bare(params.cells), f_cell, params.scat_v, params.scat_p,
            xu, xp)

    def f_diag(self, params, f_cell):
        def f(cells, fc, sv):
            return jax.lax.psum(f_diag(cells, fc, _local(sv)), AXIS)

        return self._smap(f, (P(AXIS), P(AXIS), P(AXIS)), P())(
            _bare(params.cells), f_cell, params.scat_v)

    def mass_apply(self, params, u):
        def f(cells, sv, u):
            return jax.lax.psum(mass_apply(cells, _local(sv), u), AXIS)

        return self._smap(f, (P(AXIS), P(AXIS), P()), P())(
            _bare(params.cells), params.scat_v, u)

    def schur_diag(self, params, node_weights):
        def f(cells, sp, w):
            return jax.lax.psum(schur_diag(cells, w, _local(sp)), AXIS)

        return self._smap(f, (P(AXIS), P(AXIS), P()), P())(
            _bare(params.cells), params.scat_p, node_weights)


class SingleDeviceOps:
    """Direct (unsharded) dispatch."""

    def convection(self, params, u):
        return convection_matrices(params.cells, params.t_hat, u)

    def apply_blocks(self, params, f_cell, xu, xp, with_f=True, with_g=True,
                     with_gt=True):
        return apply_blocks(params.cells, f_cell, params.scat_v,
                            params.scat_p, xu, xp, with_f=with_f,
                            with_g=with_g, with_gt=with_gt)

    def f_diag(self, params, f_cell):
        return f_diag(params.cells, f_cell, params.scat_v)

    def mass_apply(self, params, u):
        return mass_apply(params.cells, params.scat_v, u)

    def schur_diag(self, params, node_weights):
        return schur_diag(params.cells, node_weights, params.scat_p)
