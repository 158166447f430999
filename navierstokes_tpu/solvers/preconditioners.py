"""Block preconditioners for the monolithic Taylor-Hood system.

Matrix-free, jit-compatible re-designs of the reference's Trilinos
preconditioners (src/NavierStokes.cpp:934-1051):

* ``identity``  — pass-through (reference: src/NavierStokes.hpp:274-287).
* ``asimple``   — algebraic SIMPLE with D = diag(F), S = B D^-1 B^T
  (initialize at cpp:934-963, vmult at cpp:966-995).  The explicit sparse
  ``mmult`` building S is replaced by a matrix-free S application; the two
  ILU-preconditioned inner GMRES solves (rtol 1e-2, cpp:972-989) become
  Jacobi-preconditioned inner GMRES — ILU's sequential triangular solves
  map poorly onto an accelerator, while diagonal scaling + a few extra
  Krylov iterations vectorize perfectly.
* ``ayosida``   — Yosida variant with S = B (dt M_lumped^-1) B^T and a
  second F-solve in the velocity update (cpp:998-1051).

Exact algebra parity of the vmult sequences, including the sign and the
1/alpha scaling (alpha = 0.5, src/NavierStokes.hpp:306).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp

from navierstokes_tpu.solvers.krylov import bicgstab, gmres


@dataclasses.dataclass
class InnerSolve:
    """Inner solve policy: Jacobi-preconditioned BiCGStab.

    The reference uses ILU-preconditioned GMRES at rtol 1e-2
    (src/NavierStokes.cpp:972-989).  ILU's sequential triangular solves
    map poorly onto an accelerator, and an Arnoldi basis carried through
    the nested while loop (outer FGMRES body -> inner solver) costs
    memory.  BiCGStab's short recurrence (~7 carried vectors, zero basis
    storage, 2 matvecs/iteration) is the replacement; ``maxiter`` counts
    matvec pairs, so the reference-equivalent budget is about half the
    GMRES iteration count."""
    tol: float = 1.0e-2
    maxiter: int = 30
    method: str = "bicgstab"  # bicgstab | gmres

    def __call__(self, apply_op: Callable, rhs, precond=None):
        if self.method == "gmres":
            return gmres(apply_op, rhs, tol=self.tol,
                         restart=min(10, self.maxiter),
                         maxiter=self.maxiter, precond=precond).x
        return bicgstab(apply_op, rhs, tol=self.tol, maxiter=self.maxiter,
                        precond=precond).x


def make_identity():
    return lambda r: r


def make_cahouet_chabard(apply_f: Callable, apply_bt: Callable,
                         solve_ap: Callable, mp_lumped, dinv,
                         dt: float, nu, inner_f: InnerSolve):
    """Block upper-triangular preconditioner with the Cahouet-Chabard Schur
    approximation — the performance-mode alternative to the reference's
    aSIMPLE (which needs O(100) outer iterations at CFL > 1 regardless of
    inner-solve quality):

        S_F^-1  ~=  (1/dt) * Ap^-1 + nu * Mp^-1
        p = -S_F^-1 r_p
        u = F^-1 (r_u - B^T p)

    (limits: nu->0 gives S_F = B (dt M^-1) B^T = dt*Ap exactly; dt->inf
    gives the Stokes pressure-mass result.)

    with Ap = B M_lumped^-1 B^T (STATIC pressure Laplacian, inverted by the
    fixed two-level Chebyshev V-cycle built once at setup) and Mp the lumped
    pressure mass.  h- and dt-robust for the transient Navier-Stokes block
    system [Cahouet & Chabard 1988]."""
    jac_f = lambda r: r * dinv

    def vmult(r):
        ru, rp = r
        z = solve_ap(rp) / dt + nu * (rp / mp_lumped)
        p = -z
        u = inner_f(apply_f, ru - apply_bt(p), jac_f)
        return (u, p)

    return vmult


def make_pcd(apply_f: Callable, apply_bt: Callable, solve_ap: Callable,
             apply_ap: Callable, apply_np: Callable, mp_lumped, dinv,
             dt: float, nu, inner_f: InnerSolve):
    """Pressure convection-diffusion (PCD) Schur approximation
    [Elman, Silvester & Wathen]:

        S_F^-1  ~=  Mp^-1 Fp Ap^-1,   Fp = Mp/dt + nu Ap + Np(u)

    where Ap is the (static) mixed pressure Laplacian, Mp the lumped
    pressure mass, and Np the per-step pressure-space convection operator.
    Reduces to Cahouet-Chabard when Np = 0; the convection term is what
    keeps outer iteration counts bounded at CFL > 1.
    """
    jac_f = lambda r: r * dinv

    def vmult(r):
        ru, rp = r
        y = solve_ap(rp)                                   # Ap^-1 r
        fy = mp_lumped * y / dt + nu * apply_ap(y) + apply_np(y)
        z = fy / mp_lumped
        p = -z
        u = inner_f(apply_f, ru - apply_bt(p), jac_f)
        return (u, p)

    return vmult


def make_asimple(apply_f: Callable, apply_b: Callable, apply_bt: Callable,
                 dinv, diag_s, alpha: float,
                 inner_f: InnerSolve, inner_s: InnerSolve,
                 precond_s: Callable | None = None,
                 solve_s: Callable | None = None):
    """aSIMPLE vmult (parity with src/NavierStokes.cpp:966-995):

        y   = F^-1 ru                (inner GMRES)
        r1  = ru_p - B y             (sadd(-1, src), cpp:983)
        z   = S^-1 r1                (inner GMRES, S = B D^-1 B^T)
        p   = -z / alpha             (cpp:990)
        u   = y - D^-1 B^T p         (cpp:992-994)

    dinv: (n_p2, 1) inverse diagonal of the BC-masked F (per velocity node).
    diag_s: (n_p1,) diagonal of S for the Jacobi inner preconditioner.
    """
    jac_f = lambda r: r * dinv
    sdinv = jnp.where(diag_s != 0, 1.0 / diag_s, 1.0)
    jac_s = precond_s or (lambda r: r * sdinv)

    def apply_s(v):
        return apply_b(apply_bt(v) * dinv)

    def vmult(r):
        ru, rp = r
        y = inner_f(apply_f, ru, jac_f)
        r1 = rp - apply_b(y)
        z = solve_s(r1) if solve_s is not None \
            else inner_s(apply_s, r1, jac_s)
        p = -z / alpha
        u = y - apply_bt(p) * dinv
        return (u, p)

    return vmult


def make_ayosida(apply_f: Callable, apply_b: Callable, apply_bt: Callable,
                 dinv, dt_mlump_inv, diag_s,
                 inner_f: InnerSolve, inner_s: InnerSolve,
                 precond_s: Callable | None = None,
                 solve_s: Callable | None = None):
    """aYosida vmult (parity with src/NavierStokes.cpp:1024-1051):

        y   = F^-1 ru
        r1  = B y - ru_p             (sadd(1, -1, src), cpp:1040)
        z   = S^-1 r1                (S = B (dt M_l^-1) B^T, cpp:1013)
        p   = z
        u   = y - F^-1 (B^T p)       (second F-solve, cpp:1048-1050)

    dinv: (n_p2, 1) inverse diagonal of the BC-masked F (Jacobi scale for
    the F-solves).  dt_mlump_inv: (n_p2, 1) the assembled dt / lumped-mass
    vector (reference deltat_lumped_mass_inv, cpp:287-290).
    """
    jac_f = lambda r: r * dinv
    sdinv = jnp.where(diag_s != 0, 1.0 / diag_s, 1.0)
    jac_s = precond_s or (lambda r: r * sdinv)

    def apply_s(v):
        return apply_b(apply_bt(v) * dt_mlump_inv)

    def vmult(r):
        ru, rp = r
        y = inner_f(apply_f, ru, jac_f)
        r1 = apply_b(y) - rp
        p = solve_s(r1) if solve_s is not None \
            else inner_s(apply_s, r1, jac_s)
        u = y - inner_f(apply_f, apply_bt(p), jac_f)
        return (u, p)

    return vmult
