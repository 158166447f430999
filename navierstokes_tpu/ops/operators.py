"""Matrix-free Taylor-Hood block operators as batched gather/matmul/scatter.

One operator application is: gather DoF values per cell, contract with the
per-cell scalar element matrices (batched einsum), scatter-add
back with a presorted ``segment_sum``.  This replaces distributed Trilinos
SpMV + `compress` halo exchange (reference: src/NavierStokes.cpp:292-294 and
every Krylov matvec inside SolverGMRES, cpp:377).

The scatter permutation is precomputed on the host so the on-device
segment_sum runs with ``indices_are_sorted=True`` — the accelerator-friendly
form of FEM scatter-add (no data-dependent control flow).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.ops.assembly import CellArrays


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Scatter:
    """Presorted segment-sum plan for (n_src_rows,) -> (n_out,) scatter."""
    order: jax.Array        # (n_flat,) permutation sorting the target ids
    sorted_ids: jax.Array   # (n_flat,) target ids, sorted
    num_segments: int = dataclasses.field(metadata=dict(static=True))

    def __call__(self, flat_values: jax.Array) -> jax.Array:
        """flat_values: (n_flat, ...) -> (num_segments, ...)."""
        v = jnp.take(flat_values, self.order, axis=0, mode="clip")
        return jax.ops.segment_sum(v, self.sorted_ids,
                                   num_segments=self.num_segments,
                                   indices_are_sorted=True)


def build_scatter(ids: np.ndarray, num_segments: int) -> Scatter:
    flat = np.asarray(ids).reshape(-1)
    from navierstokes_tpu import native
    nat = native.scatter_plan(flat)
    if nat is not None:
        order, sorted_ids = nat
    else:
        order = np.argsort(flat, kind="stable").astype(np.int32)
        sorted_ids = flat[order].astype(np.int32)
    return Scatter(order=jnp.asarray(order),
                   sorted_ids=jnp.asarray(sorted_ids),
                   num_segments=int(num_segments))


def convection_matrices(cells: CellArrays, t_hat: jax.Array,
                        u: jax.Array) -> jax.Array:
    """Per-cell convection element matrices C(u_old): (nc, n_v, n_v).

    c_ab = int phi_a ((u_old . grad) phi_b)  — the reference's T1 form
    (src/NavierStokes.cpp:204-208), evaluated as a contraction of the fixed
    reference tensor T_hat[a,b,x,e] with per-cell J^-1 u values.

    When the mesh has snapped (curved) boundary cells, their rows are
    replaced by the quadratic-geometry quadrature version using the
    precomputed per-point physical gradients (curv_* fields; see
    ops/assembly.curved_conv_inputs) — a tiny batch (the obstacle boundary
    layer) on top of the affine bulk.
    """
    nv = cells.cell_p2.shape[1]
    u_c = jnp.take(u, cells.cell_p2, axis=0, mode="clip")          # (nc, n_v, dim)
    w = jnp.einsum("cxd,ced->cxe", cells.jinv, u_c)   # (nc, dim, n_v)
    w = w * cells.detj[:, None, None]
    # one flat (nc, dim*n_v) x (dim*n_v, n_v*n_v) dot instead of the
    # 4-way einsum: avoids tiny-minor intermediates that XLA tile-pads
    dim = w.shape[1]
    tm = t_hat.transpose(2, 3, 0, 1).reshape(dim * nv, nv * nv)
    c = jax.lax.dot_general(w.reshape(-1, dim * nv), tm,
                            (((1,), (0,)), ((), ())),
                            preferred_element_type=w.dtype)
    return curved_convection_fix(cells, c.reshape(-1, nv, nv), u)


def curved_convection_fix(cells, c_elem: jax.Array,
                          u: jax.Array) -> jax.Array:
    """Replace the curved (boundary-snapped) cells' rows of the per-cell
    convection matrices with the quadratic-geometry quadrature version:
    c_ab = sum_q (w detJ)_q phi_a(q) u_d(q) (dphi_b/dx_d)(q).  No-op when
    the mesh has no snapped boundaries.  Separated from
    ``convection_matrices`` so the shard_map cells path can apply it on the
    replicated data outside the sharded region (parallel/sharded_ops)."""
    ids = getattr(cells, "curv_ids", None)
    if ids is None:
        return c_elem
    u_k = jnp.take(u, cells.curv_nodes, axis=0)            # (k, n_v, dim)
    u_q = jnp.einsum("qe,ked->kqd", cells.curv_phi, u_k)   # u at q
    c_k = jnp.einsum("qa,kqd,kqbd->kab", cells.curv_phi, u_q,
                     cells.curv_dphys)
    return c_elem.at[ids].set(c_k.astype(c_elem.dtype))


def apply_blocks(cells: CellArrays, f_cell: jax.Array,
                 scat_v: Scatter, scat_p: Scatter,
                 xu: jax.Array, xp: jax.Array,
                 with_f=True, with_g=True, with_gt=True):
    """Monolithic (or partial) block operator application.

      yu = F xu + G xp          (momentum rows)
      yp = G^T xu               (continuity rows)

    xu: (n_p2, dim), xp: (n_p1,) -> (yu, yp) of the same shapes.
    """
    nc = cells.cell_p2.shape[0]
    dim = cells.jinv.shape[1]

    yu_c = None
    if with_f or with_gt:
        xu_c = jnp.take(xu, cells.cell_p2, axis=0, mode="clip")    # (nc, n_v, dim)
    if with_f:
        yu_c = jnp.einsum("cab,cbd->cad", f_cell, xu_c)
    if with_g:
        xp_c = jnp.take(xp, cells.cell_p1, axis=0, mode="clip")    # (nc, n_p)
        g_term = jnp.einsum("cadj,cj->cad", cells.grad, xp_c)
        yu_c = g_term if yu_c is None else yu_c + g_term
    yu = (scat_v(yu_c.reshape(-1, dim)) if yu_c is not None
          else jnp.zeros_like(xu))

    if with_gt:
        yp_c = jnp.einsum("cbdj,cbd->cj", cells.grad, xu_c)
        yp = scat_p(yp_c.reshape(nc * yp_c.shape[1]))
    else:
        yp = jnp.zeros_like(xp)

    # Layout pin: when this operator feeds a lax.while_loop carry (every
    # Krylov matvec does), the gather->scatter chain otherwise can send
    # XLA's layout assignment into a pathologically slow
    # negotiation between the gather-preferred and scatter-preferred layouts
    # of the carried vector.  Mixing the input back in (exact no-op) anchors
    # the output to the input layout; compile time drops to seconds.
    yu = yu + 0.0 * xu
    yp = yp + 0.0 * xp
    return yu, yp


def f_diag(cells: CellArrays, f_cell: jax.Array, scat_v_diag: Scatter):
    """Diagonal of the velocity block F (same value for every component of a
    node): (n_p2,).  Used for aSIMPLE's D = diag(F)
    (reference: src/NavierStokes.cpp:948-953)."""
    nv = f_cell.shape[1]
    d = f_cell[:, jnp.arange(nv), jnp.arange(nv)]     # (nc, n_v)
    return scat_v_diag(d.reshape(-1))


def schur_diag(cells: CellArrays, node_weights: jax.Array,
               scat_p_diag: Scatter) -> jax.Array:
    """Diagonal of S = B W B^T with W = diag(node_weights) per velocity node:
    diag_S[j] = sum_{c,a,d} grad[c,a,d,j]^2 * w[node(c,a)].  Used as the
    Jacobi scale of the inner Schur solves — the stand-in for the
    reference's ILU(S) (src/NavierStokes.cpp:959).

    NOTE: this cells-path value is an APPROXIMATION — it sums squares of
    per-cell contributions, so for velocity nodes shared by several cells
    it under-counts the cross-cell products of the true assembled
    diag(B W B^T).  The BSR path (ops/bsr.py schur_diag) computes the
    exact assembled version; preconditioner quality only, never affects
    the converged solution."""
    w_c = jnp.take(node_weights.reshape(-1), cells.cell_p2, axis=0, mode="clip")  # (nc,n_v)
    contrib = jnp.einsum("cadj,cadj,ca->cj", cells.grad, cells.grad, w_c)
    return scat_p_diag(contrib.reshape(-1))


def mass_apply(cells: CellArrays, scat_v: Scatter, u: jax.Array) -> jax.Array:
    """Consistent mass matrix times velocity: (n_p2, dim)."""
    dim = u.shape[1]
    u_c = jnp.take(u, cells.cell_p2, axis=0, mode="clip")
    r = jnp.einsum("cab,cbd->cad", cells.mass, u_c)
    return scat_v(r.reshape(-1, dim))


def lumped_mass(cells: CellArrays, mlump_hat: jax.Array,
                scat_v_diag: Scatter) -> jax.Array:
    """Abs-lumped mass per velocity node: (n_p2,).

    Matches the reference's per-quad-point-abs accumulation
    sum_{q,j} |phi_j . phi_i| JxW (src/NavierStokes.cpp:232-236); for the
    vector basis the component blocks are identical so a scalar per node
    suffices.  The Yosida preconditioner consumes dt / lumped
    (cpp:287-290).
    """
    rows = cells.detj[:, None] * mlump_hat[None, :]   # (nc, n_v)
    return scat_v_diag(rows.reshape(-1))
