"""Batched per-cell assembly data — the batched replacement for the
reference's per-cell FEValues assembly loop (src/NavierStokes.cpp:133-330).

Instead of assembling a distributed sparse matrix each step, we precompute
*geometric factors* per cell once (detJ, J^-1 — constant for affine
simplices) and contract them with tiny fixed reference tensors
(fem/reference_elements.py) into per-cell scalar element matrices.  The
Taylor-Hood monolithic block matrix has the structure

    [ kron(I_dim, F_c)   G ]   F_c = M/dt + nu*K + C(u_old)   (scalar n_v x n_v)
    [ G^T                0 ]   G   = pressure-gradient coupling

so only the *scalar* blocks are ever materialized: (n_cells, n_v, n_v) for
F_c and (n_cells, n_v, dim, n_p) for G.  The convection part C(u_old) is the
only per-step rebuild (reference: the whole matrix is rebuilt per step,
cpp:154-294 — our static/dynamic split realizes the design the reference
left as dead declarations, assemble_static_matrices, hpp:195-199).

Integrand parity with the reference (cpp:191-248):
  mass/dt        : (phi_i . phi_j)/dt
  viscosity      : nu * grad(phi_i) : grad(phi_j)
  convection T1  : phi_i . (u_old . grad) phi_j        (cpp:204-208)
  pressure       : -(div phi_i) psi_j  and  -(div phi_j) psi_i
  lumped mass    : |sum_j (phi_j . phi_i)| accumulated -> dt / (.)
                   (cpp:232-236, 287-290; used by the Yosida preconditioner)
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.fem.spaces import FaceData, TaylorHoodSpace


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CellArrays:
    """Device-resident static per-cell data (pytree)."""
    cell_p2: jax.Array      # (nc, n_v) int32 velocity-node ids
    cell_p1: jax.Array      # (nc, n_p) int32 pressure-node ids
    detj: jax.Array         # (nc,)
    jinv: jax.Array         # (nc, dim, dim) reference<-physical
    mass: jax.Array         # (nc, n_v, n_v) scalar mass element matrices
    stiff: jax.Array        # (nc, n_v, n_v) scalar stiffness
    grad: jax.Array         # (nc, n_v, dim, n_p) -int d_d(phi_a) psi_j
    # Curved (boundary-snapped) cell subset — per-step convection on those
    # cells uses per-quadrature-point quadratic geometry instead of the
    # affine detj/jinv above (ops/operators.curved_convection_fix).  None
    # on meshes without snapped boundaries.
    curv_ids: object = None    # (k,) int32 curved cell ids
    curv_nodes: object = None  # (k, n_v) int32 velocity-node rows
    curv_phi: object = None    # (n_cq, n_v) P2 values at the curved rule
    curv_dphys: object = None  # (k, n_cq, n_v, dim) physical gradients
    #                            pre-scaled by w_q * detJ_q


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FaceArrays:
    """Device-resident boundary-face quadrature data for one tag."""
    vel_nodes: jax.Array    # (nf, n_v) int32 — owning cell's velocity nodes
    p_nodes: jax.Array      # (nf, n_p) int32
    phi_v: jax.Array        # (nf, n_fq, n_v)
    dphi_phys: jax.Array    # (nf, n_fq, n_v, dim) physical gradients
    phi_p: jax.Array        # (nf, n_fq, n_p)
    normals: jax.Array      # (nf, n_fq, dim) outward unit normals per quad
    #                         point (per-point on curved/snapped faces)
    jxw: jax.Array          # (nf, n_fq)


def geometric_factors(space: TaylorHoodSpace):
    """Affine-map factors per cell: detJ (signed, positive after orientation
    fix) and J^{-1} with J[:, k] = v_{k+1} - v_0."""
    mesh = space.mesh
    p = mesh.points[mesh.cells]                  # (nc, dim+1, dim)
    J = np.swapaxes(p[:, 1:, :] - p[:, :1, :], 1, 2)  # (nc, dim, dim)
    detj = np.linalg.det(J)
    jinv = np.linalg.inv(J)
    return detj, jinv


def curved_conv_inputs(space: TaylorHoodSpace):
    """(curv_ids, curv_nodes, curv_phi, curv_dphys) numpy inputs for the
    per-step curved-cell convection fix, or (None,)*4 on unsnapped meshes.
    curv_nodes are the curved cells' velocity-node rows (so the fix never
    needs the possibly-sharded cell arrays); curv_dphys folds w_q * detJ_q
    into the physical gradients so the per-step contraction is a plain
    einsum (ops/operators.curved_convection_fix)."""
    cd = space.curved_data()
    if cd is None:
        return None, None, None, None
    wdet = cd.qw[None, :] * cd.detj_q                     # (k, n_cq)
    dphys = np.einsum("kq,qax,kqxd->kqad", wdet, cd.dphi_v, cd.jinv_q)
    nodes = np.asarray(space.cell_p2)[cd.ids].astype(np.int32)
    return cd.ids.astype(np.int32), nodes, cd.phi_v, dphys


def cell_arrays_numpy(space: TaylorHoodSpace) -> CellArrays:
    """Host (numpy, float64) per-cell arrays — the preprocessing product.

    Cells touched by snapped (curved) boundaries get their static element
    matrices replaced by quadratic-map quadrature versions; the stored
    per-cell detj/jinv stay the affine values (used only as the curved
    cells' convection fallback on paths without the curved fix)."""
    rs = space.rs
    detj, jinv = geometric_factors(space)

    # physical stiffness: k_ab = detJ * K_hat[x,y,a,b] (Jinv Jinv^T)[x,y]
    C = np.einsum("cxd,cyd->cxy", jinv, jinv) * detj[:, None, None]
    stiff = np.einsum("xyab,cxy->cab", rs.K_hat, C)
    mass = detj[:, None, None] * rs.M_hat[None, :, :]
    # G[c,a,d,j] = -detJ * G_hat[a,x,j] Jinv[c,x,d]
    grad = -np.einsum("axj,cxd,c->cadj", rs.G_hat, jinv, detj)

    cd = space.curved_data()
    if cd is not None:
        wdet = cd.qw[None, :] * cd.detj_q                 # (k, n_cq)
        dphys = np.einsum("qax,kqxd->kqad", cd.dphi_v, cd.jinv_q)
        mass[cd.ids] = np.einsum("kq,qa,qb->kab", wdet, cd.phi_v, cd.phi_v)
        stiff[cd.ids] = np.einsum("kq,kqad,kqbd->kab", wdet, dphys, dphys)
        grad[cd.ids] = -np.einsum("kq,kqad,qj->kadj", wdet, dphys, cd.phi_p)
    return CellArrays(cell_p2=space.cell_p2, cell_p1=space.cell_p1,
                      detj=detj, jinv=jinv, mass=mass, stiff=stiff,
                      grad=grad)


def build_cell_arrays(space: TaylorHoodSpace, dtype=jnp.float32,
                      host: CellArrays | None = None) -> CellArrays:
    c = host or cell_arrays_numpy(space)
    f = lambda x: jnp.asarray(x, dtype=dtype)
    ci, cn, cp, cg = curved_conv_inputs(space)
    return CellArrays(
        cell_p2=jnp.asarray(np.asarray(c.cell_p2)),
        cell_p1=jnp.asarray(np.asarray(c.cell_p1)),
        detj=f(c.detj), jinv=f(c.jinv), mass=f(c.mass), stiff=f(c.stiff),
        grad=f(c.grad),
        curv_ids=None if ci is None else jnp.asarray(ci),
        curv_nodes=None if ci is None else jnp.asarray(cn),
        curv_phi=None if ci is None else f(cp),
        curv_dphys=None if ci is None else f(cg),
    )


def forcing_rhs(space: TaylorHoodSpace, f_fn, t: float = 0.0) -> np.ndarray:
    """Host-side forcing assembly: r[(a,d)] = int f_d(x, t) phi_a dx.

    The reference's ForcingTerm is identically zero (src/NavierStokes.hpp:
    56-65; forcing integrand at cpp:240-243) but the hook is first-class
    here: ``f_fn(points (n, dim), t) -> (n, dim)``.  Returns (n_p2, dim)
    float64 (cast at use site)."""
    rs = space.rs
    mesh = space.mesh
    detj, _ = geometric_factors(space)
    verts = mesh.points[mesh.cells]                    # (nc, dim+1, dim)
    # physical quad points: x = v0 + J qp  (affine)
    qp = rs.qp                                         # (n_q, dim)
    lam0 = 1.0 - qp.sum(axis=1)
    bary = np.concatenate([lam0[:, None], qp], axis=1)  # (n_q, dim+1)
    xq = np.einsum("qk,ckd->cqd", bary, verts)          # (nc, n_q, dim)
    fq = f_fn(xq.reshape(-1, mesh.dim), t).reshape(xq.shape)
    r_c = np.einsum("q,qa,cqd,c->cad", rs.qw, rs.phi_v, fq, detj)
    out = np.zeros((space.n_p2, mesh.dim))
    np.add.at(out, np.asarray(space.cell_p2).reshape(-1),
              r_c.reshape(-1, mesh.dim))
    return out


def build_face_arrays(space: TaylorHoodSpace, tag: int,
                      dtype=jnp.float32) -> FaceArrays:
    fd: FaceData = space.face_data(tag)
    if fd.jinv_q is not None:
        # curved owning cells: per-quad-point inverse Jacobians
        dphi_phys = np.einsum("fqbx,fqxd->fqbd", fd.dphi_v_ref, fd.jinv_q)
    else:
        _, jinv = geometric_factors(space)
        jinv_f = jinv[fd.cells]                              # (nf, dim, dim)
        dphi_phys = np.einsum("fqbx,fxd->fqbd", fd.dphi_v_ref, jinv_f)
    f = lambda x: jnp.asarray(x, dtype=dtype)
    return FaceArrays(
        vel_nodes=jnp.asarray(space.cell_p2[fd.cells]),
        p_nodes=jnp.asarray(space.cell_p1[fd.cells]),
        phi_v=f(fd.phi_v), dphi_phys=f(dphi_phys), phi_p=f(fd.phi_p),
        normals=f(fd.normals), jxw=f(fd.jxw),
    )
