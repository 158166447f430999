"""Jitted Krylov solvers (GMRES / flexible GMRES / CG) on pytrees.

The JAX replacement for deal.II ``SolverGMRES`` over Trilinos vectors
(reference: src/NavierStokes.cpp:348-377 outer solve, :978-989 inner solves).
Everything is a single XLA program: Arnoldi under ``lax.while_loop`` with a
statically-shaped Krylov basis, Givens-rotation least squares, and no host
round-trips — dot products that were MPI allreduces in the reference are
plain (or psum-reduced) on-device reductions here.

All solvers take/return arbitrary pytrees; internally they operate on the
flattened vector (static structure under jit).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree


class KrylovResult(NamedTuple):
    x: object            # solution pytree
    iterations: jax.Array
    residual: jax.Array  # final (estimated) residual norm
    converged: jax.Array


def _identity(x):
    return x


def gmres(matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0,
          restart=30, maxiter=100, precond: Optional[Callable] = None,
          flexible=False) -> KrylovResult:
    """(F)GMRES with right preconditioning.

    Stops when ||b - A x|| <= max(tol * ||b||, atol).  ``restart`` is the
    Krylov-space dimension m; ``maxiter`` caps the *total* number of inner
    iterations across restart cycles.  With ``flexible=True`` the
    preconditioned vectors Z_j are stored (FGMRES) so the preconditioner may
    itself be an iterative solve — required for the aSIMPLE/aYosida
    preconditioners whose vmult runs inner GMRES (reference:
    src/NavierStokes.cpp:966-995).
    """
    b_flat, unravel = ravel_pytree(b)
    n = b_flat.shape[0]
    dtype = b_flat.dtype
    M = precond or _identity

    def mv(v_flat):
        out, _ = ravel_pytree(matvec(unravel(v_flat)))
        return out

    def pc(v_flat):
        out, _ = ravel_pytree(M(unravel(v_flat)))
        return out

    if x0 is None:
        x0_flat = jnp.zeros_like(b_flat)
    else:
        x0_flat, _ = ravel_pytree(x0)

    bnorm = jnp.linalg.norm(b_flat)
    target = jnp.maximum(tol * bnorm, atol).astype(dtype)
    m = restart

    def cycle(x_flat, total_iters):
        """One restart cycle; returns updated x, iters, residual, converged."""
        r0 = b_flat - mv(x_flat)
        beta = jnp.linalg.norm(r0)

        V = jnp.zeros((m + 1, n), dtype)
        V = V.at[0].set(jnp.where(beta > 0, r0 / jnp.maximum(beta, 1e-30), 0))
        Z = jnp.zeros((m, n), dtype) if flexible else None
        H = jnp.zeros((m + 1, m), dtype)
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)

        def cond(state):
            j, *_rest, res = state
            return jnp.logical_and(j < m,
                                   jnp.logical_and(res > target,
                                                   total_iters + j < maxiter))

        def body(state):
            j, V, Z, H, cs, sn, g, _res = state
            z = pc(V[j])
            w = mv(z)
            if flexible:
                Z = Z.at[j].set(z)
            # modified Gram-Schmidt (two passes for fp32 robustness),
            # vectorized over the full static basis with an index mask.
            mask = (jnp.arange(m + 1) <= j).astype(dtype)
            h1 = (V @ w) * mask
            w = w - h1 @ V
            h2 = (V @ w) * mask
            w = w - h2 @ V
            h = h1 + h2
            wnorm = jnp.linalg.norm(w)
            V = V.at[j + 1].set(w / jnp.maximum(wnorm, 1e-30))
            h = h.at[j + 1].set(wnorm)

            # apply stored Givens rotations to the new column
            def rot_body(i, hcol):
                active = i < j
                ci, si = cs[i], sn[i]
                hi = jnp.where(active, ci * hcol[i] + si * hcol[i + 1], hcol[i])
                hi1 = jnp.where(active, -si * hcol[i] + ci * hcol[i + 1],
                                hcol[i + 1])
                return hcol.at[i].set(hi).at[i + 1].set(hi1)

            h = jax.lax.fori_loop(0, m, rot_body, h)

            # new rotation annihilating h[j+1]
            denom = jnp.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            cj = jnp.where(denom > 0, h[j] / jnp.maximum(denom, 1e-30), 1.0)
            sj = jnp.where(denom > 0, h[j + 1] / jnp.maximum(denom, 1e-30), 0.0)
            h = h.at[j].set(denom).at[j + 1].set(0.0)
            cs = cs.at[j].set(cj)
            sn = sn.at[j].set(sj)
            g = g.at[j + 1].set(-sj * g[j])
            g = g.at[j].set(cj * g[j])
            H = H.at[:, j].set(h)
            res = jnp.abs(g[j + 1])
            return j + 1, V, Z, H, cs, sn, g, res

        state = (jnp.array(0, jnp.int32), V, Z, H, cs, sn, g, beta)
        j, V, Z, H, cs, sn, g, res = jax.lax.while_loop(cond, body, state)

        # solve the j x j upper-triangular system (padded to m with identity)
        active = jnp.arange(m) < j
        R = H[:m, :m]
        R = jnp.where(active[None, :] & active[:, None], R,
                      jnp.eye(m, dtype=dtype))
        y = jax.scipy.linalg.solve_triangular(R, jnp.where(active, g[:m], 0.0),
                                              lower=False)
        if flexible:
            dx = y @ Z
        else:
            dx = pc(y @ V[:m])
        return x_flat + dx, total_iters + j, res, res <= target

    def outer_cond(state):
        _x, iters, _res, conv = state
        return jnp.logical_and(~conv, iters < maxiter)

    def outer_body(state):
        x, iters, _res, _conv = state
        return cycle(x, iters)

    # the cycle body is traced exactly once (inside the while); the first
    # iteration always runs because the initial "residual" is +inf
    state0 = (x0_flat, jnp.array(0, jnp.int32),
              jnp.array(jnp.inf, dtype), jnp.array(False))
    x, iters, res, conv = jax.lax.while_loop(outer_cond, outer_body, state0)
    return KrylovResult(unravel(x), iters, res, conv)


fgmres = functools.partial(gmres, flexible=True)


def bicgstab(matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0,
             maxiter=100, precond: Optional[Callable] = None) -> KrylovResult:
    """Right-preconditioned BiCGStab.

    Short-recurrence Krylov for nonsymmetric systems: carries ~7 vectors and
    no Arnoldi basis, which keeps while-loop state small — used for the
    aSIMPLE/aYosida inner solves where GMRES' (m+1, n) basis would be carried
    through the nested while loops.  Two matvecs per
    iteration; at the reference's loose 1e-2 inner tolerance
    (src/NavierStokes.cpp:972-973) a handful of iterations suffice.
    """
    b_flat, unravel = ravel_pytree(b)
    M = precond or _identity

    def mv(v):
        out, _ = ravel_pytree(matvec(unravel(v)))
        return out

    def pc(v):
        out, _ = ravel_pytree(M(unravel(v)))
        return out

    x = jnp.zeros_like(b_flat) if x0 is None else ravel_pytree(x0)[0]
    r = b_flat - mv(x)
    r0 = r  # shadow residual
    dtype = b_flat.dtype
    target = jnp.maximum(tol * jnp.linalg.norm(b_flat), atol).astype(dtype)
    one = jnp.ones((), dtype)
    rho = alpha = omega = one
    v = jnp.zeros_like(b_flat)
    p = jnp.zeros_like(b_flat)
    eps = jnp.asarray(1e-30, dtype)

    def cond(state):
        x, r, *_rest, k, stag = state
        return jnp.logical_and(jnp.linalg.norm(r) > target,
                               jnp.logical_and(k < maxiter, ~stag))

    def body(state):
        x, r, rho, alpha, omega, v, p, k, _stag = state
        rho_new = r0 @ r
        beta = (rho_new / jnp.where(jnp.abs(rho) > eps, rho, eps)) * \
               (alpha / jnp.where(jnp.abs(omega) > eps, omega, eps))
        p = r + beta * (p - omega * v)
        phat = pc(p)
        v = mv(phat)
        denom = r0 @ v
        alpha = rho_new / jnp.where(jnp.abs(denom) > eps, denom, eps)
        s = r - alpha * v
        shat = pc(s)
        t = mv(shat)
        tt = t @ t
        omega = (t @ s) / jnp.where(tt > eps, tt, eps)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        # breakdown guard: stagnate-flag stops the loop cleanly
        stag = jnp.logical_or(jnp.abs(rho_new) <= eps, jnp.abs(denom) <= eps)
        return x, r, rho_new, alpha, omega, v, p, k + 1, stag

    state = (x, r, rho, alpha, omega, v, p, jnp.array(0, jnp.int32),
             jnp.array(False))
    x, r, *_rest, k, _stag = jax.lax.while_loop(cond, body, state)
    res = jnp.linalg.norm(r)
    return KrylovResult(unravel(x), k, res, res <= target)


def cg(matvec: Callable, b, x0=None, *, tol=1e-6, atol=0.0, maxiter=100,
       precond: Optional[Callable] = None) -> KrylovResult:
    """Preconditioned conjugate gradient for SPD operators (test fixtures and
    SPD sub-solves)."""
    b_flat, unravel = ravel_pytree(b)
    M = precond or _identity

    def mv(v):
        out, _ = ravel_pytree(matvec(unravel(v)))
        return out

    def pc(v):
        out, _ = ravel_pytree(M(unravel(v)))
        return out

    x = jnp.zeros_like(b_flat) if x0 is None else ravel_pytree(x0)[0]
    r = b_flat - mv(x)
    z = pc(r)
    p = z
    rz = r @ z
    target = jnp.maximum(tol * jnp.linalg.norm(b_flat), atol)

    def cond(state):
        _x, r, *_rest, k = state
        return jnp.logical_and(jnp.linalg.norm(r) > target, k < maxiter)

    def body(state):
        x, r, p, rz, k = state
        Ap = mv(p)
        alpha = rz / jnp.maximum(p @ Ap, 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pc(r)
        rz_new = r @ z
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return x, r, p, rz_new, k + 1

    x, r, _p, _rz, k = jax.lax.while_loop(
        cond, body, (x, r, p, rz, jnp.array(0, jnp.int32)))
    res = jnp.linalg.norm(r)
    return KrylovResult(unravel(x), k, res, res <= target)
