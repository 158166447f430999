"""Two-level aggregation preconditioner for the Schur complement.

The reference preconditions its inner Schur solves with ILU(0)
(src/NavierStokes.cpp:959, 986-989).  ILU's sequential triangular solves
map poorly onto an accelerator, and plain Jacobi degrades like O(1/h) on the
Laplacian-like S = B D^-1 B^T — at ~100k pressure DoFs the inner solve
never reaches its 1e-2 tolerance and the outer Krylov stalls.

Replacement: a two-level method exploiting the space-filling-
curve node ordering (Hilbert; fem/spaces.py):

  * aggregates = contiguous runs of ``agg`` pressure nodes (compact spatial
    patches, because the numbering follows a space-filling curve).
    Restriction R^T r = reshape+sum — no gather at all;
  * Galerkin coarse matrix S_c = R^T B W B^T R assembled on device each
    step from the static BSR pressure-coupling blocks contracted with the
    current masked D^-1 (a single presorted segment-sum over block pairs),
    then DENSE-inverted (n_agg ~ hundreds..thousands);
  * multiplicative two-level application:
        z  = R S_c^-1 R^T r
        z += omega * diag(S)^-1 (r - S z)

This makes the inner Schur BiCGStab converge in O(1) iterations
independent of mesh size.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.ops.bsr import BsrData
from navierstokes_tpu.ops.operators import Scatter, build_scatter

_static = dict(static=True)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class CoarsePlan:
    """Static plan for assembling S_c from the BSR G blocks."""
    pair_scatter: Scatter     # (n_vb*KG*KG,) -> n_agg*n_agg slots
    n_agg: int = dataclasses.field(metadata=_static)
    agg: int = dataclasses.field(metadata=_static)  # pressure nodes per agg
    n_p1: int = dataclasses.field(metadata=_static)


def build_coarse_plan(bsr: BsrData, agg_blocks: int = 4) -> CoarsePlan:
    """agg_blocks: pressure BSR blocks (of bp nodes) per aggregate."""
    g_cols = getattr(bsr, "host_g_cols", None)        # (n_vb, KG) p-blocks
    if g_cols is None:
        g_cols = np.asarray(bsr.g_cols, dtype=np.int64)
    n_pb = -(-bsr.n_p1 // bsr.bp)
    n_agg = -(-n_pb // agg_blocks)
    a_cols = g_cols // agg_blocks                     # aggregate ids
    n_vb, KG = a_cols.shape
    slots = (a_cols[:, :, None] * n_agg + a_cols[:, None, :]).reshape(-1)
    plan = build_scatter(slots.astype(np.int64).reshape(-1, 1),
                         n_agg * n_agg)
    return CoarsePlan(pair_scatter=plan, n_agg=n_agg,
                      agg=agg_blocks * bsr.bp, n_p1=bsr.n_p1)


def coarse_matrix(bsr: BsrData, plan: CoarsePlan,
                  dinv_masked: jax.Array) -> jax.Array:
    """S_c[a,b] = sum_u (B^T R)[u,a] dinv[u] (B^T R)[u,b], assembled from
    G block pairs.  dinv_masked: (n_p2,) masked inverse diag(F)."""
    n_vb = bsr.g_cols.shape[0]
    pad = n_vb * bsr.bu - bsr.n_p2
    d_blk = jnp.pad(dinv_masked, (0, pad)).reshape(n_vb, bsr.bu)
    # W[n,k,d,a] = sum_b g[n,k,d,a,b]  (aggregate sum over the block's
    # pressure nodes; aggregates always contain whole blocks)
    from navierstokes_tpu.ops.bsr import g_blocks
    w = jnp.sum(g_blocks(bsr), axis=4)                # (n_vb, KG, dim, bu)
    # pair contraction: val[n,k1,k2] = sum_{d,a} w[n,k1,d,a] d[n,a] w[n,k2,d,a]
    vals = jnp.einsum("nkda,na,nlda->nkl", w, d_blk, w)
    sc = plan.pair_scatter(vals.reshape(-1, 1))
    return sc.reshape(plan.n_agg, plan.n_agg)


def coarse_inverse(s_c: jax.Array, reg: float = 1e-8) -> jax.Array:
    """Dense inverse with a tiny diagonal shift (aggregates touching only
    Dirichlet-masked velocity nodes could otherwise be singular).

    Always inverted in float32: single precision is ample for a
    preconditioner block."""
    n = s_c.shape[0]
    scale = jnp.mean(jnp.abs(jnp.diagonal(s_c))) + 1e-30
    a = (s_c + (reg * scale) * jnp.eye(n, dtype=s_c.dtype))
    return jnp.linalg.inv(a.astype(jnp.float32)).astype(s_c.dtype)


def restrict(plan: CoarsePlan, r: jax.Array) -> jax.Array:
    pad = plan.n_agg * plan.agg - plan.n_p1
    return jnp.pad(r, (0, pad)).reshape(plan.n_agg, plan.agg).sum(axis=1)


def prolong(plan: CoarsePlan, y: jax.Array) -> jax.Array:
    out = jnp.repeat(y, plan.agg)
    return out[:plan.n_p1]


def make_two_level(apply_s, diag_s, plan: CoarsePlan, sc_inv: jax.Array,
                   omega: float = 0.7):
    """Multiplicative coarse + damped-Jacobi preconditioner for S."""
    sdinv = jnp.where(diag_s != 0, 1.0 / diag_s, 1.0)

    def precond(r):
        y = sc_inv @ restrict(plan, r)
        z = prolong(plan, y)
        r2 = r - apply_s(z)
        return z + omega * (sdinv * r2)

    return precond


def estimate_lam_max(apply_s, sdinv, n: int, dtype, iters: int = 8,
                     op=None):
    """Power-iteration estimate of lambda_max(D^-1 S) (x1.05 safety).

    The whole estimate runs as ONE jitted XLA program, not as ~15
    individually dispatched ops.

    ``op``: optional operator pytree, passed as ``apply_s(op, v)``.  Large
    operators MUST flow through ``op`` rather than a closure: closed-over
    device arrays are inlined into the program as HLO constants (~100 MB
    for the pressure operator of a 1.74M-DoF 3D mesh).  Closures remain
    fine for small operands and for calls made inside an outer trace
    (where captures are tracers, not constants)."""

    @jax.jit
    def run(op, sdinv):
        apply = (lambda v: apply_s(op, v)) if op is not None \
            else apply_s
        # deterministic pseudo-random start (no RNG inside jit-able setup)
        v = jnp.sin(jnp.arange(n, dtype=dtype) * 12.9898 + 0.5) + 0.01

        def body(_, v):
            w = sdinv * apply(v)
            return w / jnp.maximum(jnp.linalg.norm(w), 1e-30)

        v = jax.lax.fori_loop(0, iters, body, v)
        return jnp.linalg.norm(sdinv * apply(v))

    return run(op, sdinv) * 1.05


def chebyshev(apply_s, sdinv, lam_max, r, k: int, ratio: float = 6.0):
    """k Chebyshev smoothing iterations for S z = r (z0 = 0), targeting the
    upper spectrum [lam_max/ratio, lam_max] of D^-1 S — the standard
    polynomial smoother of smoothed-aggregation AMG, and the accelerator-friendly
    replacement for Gauss-Seidel/ILU sweeps (pure matvecs + axpys)."""
    lmin = lam_max / ratio
    theta = 0.5 * (lam_max + lmin)
    delta = 0.5 * (lam_max - lmin)
    sigma = theta / delta
    rho = 1.0 / sigma
    d = (sdinv * r) / theta
    z = d
    for _ in range(k - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        resid = r - apply_s(z)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (sdinv * resid)
        z = z + d
        rho = rho_new
    return z


def make_vcycle_solver(apply_s, diag_s, plan: CoarsePlan, sc_inv: jax.Array,
                       n_cycles: int = 2, smooth_k: int = 3,
                       lam_max=None):
    """Fixed-iteration two-level V-cycles approximating S^-1.

    Chebyshev pre/post-smoothing + exact (dense-inverse) coarse correction.
    A FIXED LINEAR operator: usable as the aSIMPLE inner Schur solve while
    keeping the whole preconditioner linear (so the outer Krylov theory
    holds exactly).  Contraction per cycle is h-independent."""
    sdinv = jnp.where(diag_s != 0, 1.0 / diag_s, 1.0)

    def vcycle(z, r):
        # pre-smooth on the residual equation
        z = z + chebyshev(apply_s, sdinv, lam_max, r - apply_s(z), smooth_k)
        # coarse correction
        rc = r - apply_s(z)
        z = z + prolong(plan, sc_inv @ restrict(plan, rc))
        # post-smooth
        z = z + chebyshev(apply_s, sdinv, lam_max, r - apply_s(z), smooth_k)
        return z

    def solve(r):
        z = jnp.zeros_like(r)
        for _ in range(n_cycles):
            z = vcycle(z, r)
        return z

    return solve
