"""Compensated (double-float) iterative refinement for the monolithic
saddle-point solve.

The reference solves in double throughout
(src/NavierStokes.cpp:348, 377); in fp32 the attainable residual floors
near 3e-6*||b|| (models/navier_stokes.py), which was measured to wash out
small force coefficients (2D-1 lift, VALIDATION.md).  The residual of the
BC-masked block system is evaluated here in two-float arithmetic
(ops/df32.py, ~2^-48 effective precision) while every correction solve
stays the ordinary fp32 FGMRES + preconditioner.  Classic mixed-precision
iterative refinement: each pass multiplies the true residual by the
fp32 solve's contraction factor, with no fp32 read-off floor because the
residual is computed compensated.

All applies mirror ops/bsr.py's flat row-major layouts; only the HI part
of the operator values exists (the fp32 assembly is the system being
solved — its eps-level representation error is a backward perturbation,
irrelevant next to the 1e-3-level solver floor being fixed).
"""

from __future__ import annotations

import jax.numpy as jnp

from navierstokes_tpu.ops import df32
from navierstokes_tpu.ops.bsr import (BsrData, _fold_overflow, _fold_spills,
                                      _n_pb_phys, _n_vb_phys, _pblocks,
                                      _ublocks)


def apply_f_df(bsr: BsrData, f_blk, xu):
    """F matvec with df input: ((n_p2,d) hi, lo) -> ((n_p2,d) hi, lo)."""
    xu_h, xu_l = xu
    n_ext, bu, C = f_blk.shape
    d = xu_h.shape[1]
    xbh = _ublocks(bsr, xu_h)
    xbl = _ublocks(bsr, xu_l)
    his, los = [], []
    for dd in range(d):
        xgh = jnp.take(xbh[..., dd], bsr.f_cols, axis=0,
                       mode="clip").reshape(n_ext, C)
        xgl = jnp.take(xbl[..., dd], bsr.f_cols, axis=0,
                       mode="clip").reshape(n_ext, C)
        hi, lo = df32.df_matvec_flat(f_blk, xgh, xgl)
        his.append(hi)
        los.append(lo)
    yh = jnp.stack(his, axis=-1)                    # (n_ext, bu, d)
    yl = jnp.stack(los, axis=-1)
    # overflow fold: hi/lo folded separately — the plain adds on the few
    # spill rows cap those rows at ~eps (not eps^2) accuracy, still two
    # orders below the fp32 floor being fixed
    yh = _fold_overflow(bsr, yh)
    yl = _fold_overflow(bsr, yl)
    return (yh.reshape(-1, d)[:bsr.n_p2], yl.reshape(-1, d)[:bsr.n_p2])


def apply_bt_df(bsr: BsrData, xp):
    """G (pressure-gradient) matvec with df pressure input."""
    xp_h, xp_l = xp
    pbh = _pblocks(bsr, xp_h)
    pbl = _pblocks(bsr, xp_l)
    n_ext = bsr.g_cols.shape[0]
    pgh = jnp.take(pbh, bsr.g_cols, axis=0, mode="clip").reshape(n_ext, -1)
    pgl = jnp.take(pbl, bsr.g_cols, axis=0, mode="clip").reshape(n_ext, -1)
    g = bsr.g_blk                                   # (n_ext, dim, bu, C)
    p, e = df32.two_prod(g, pgh[:, None, None, :])
    e = e + g * pgl[:, None, None, :]
    yh, yl = df32.df_sum((p, e), axis=-1)           # (n_ext, dim, bu)
    # spill fold: hi/lo separately (same eps-level cap as apply_f_df's
    # overflow fold above — see that note)
    yh = _fold_spills(bsr.g_spill, yh, _n_vb_phys(bsr))
    yl = _fold_spills(bsr.g_spill, yl, _n_vb_phys(bsr))
    d = yh.shape[1]
    yh = jnp.swapaxes(yh, 1, 2).reshape(-1, d)[:bsr.n_p2]
    yl = jnp.swapaxes(yl, 1, 2).reshape(-1, d)[:bsr.n_p2]
    return yh, yl


def apply_b_df(bsr: BsrData, xu):
    """B (continuity) matvec with df velocity input -> df (n_p1,)."""
    xu_h, xu_l = xu
    ubh = _ublocks(bsr, xu_h)
    ubl = _ublocks(bsr, xu_l)
    n_ext = bsr.b_cols.shape[0]
    ugh = jnp.take(ubh, bsr.b_cols, axis=0, mode="clip").reshape(n_ext, -1)
    ugl = jnp.take(ubl, bsr.b_cols, axis=0, mode="clip").reshape(n_ext, -1)
    b = bsr.b_blk                                   # (n_ext, bp, C)
    p, e = df32.two_prod(b, ugh[:, None, :])
    e = e + b * ugl[:, None, :]
    zh, zl = df32.df_sum((p, e), axis=-1)           # (n_ext, bp)
    zh = _fold_spills(bsr.b_spill, zh, _n_pb_phys(bsr))
    zl = _fold_spills(bsr.b_spill, zl, _n_pb_phys(bsr))
    return zh.reshape(-1)[:bsr.n_p1], zl.reshape(-1)[:bsr.n_p1]


def _dfm(x, m):
    """Exact df * {0,1}-mask."""
    return x[0] * m, x[1] * m


def apply_saddle_df(bsr: BsrData, f_blk, mask, sigma, xu, xp):
    """df apply of the BC-masked monolithic operator
    (models/navier_stokes.py apply_A):
      yu = (F xu_m + G xp) * mask + sigma * (xu - xu_m);  yp = B xu_m."""
    one_m = 1.0 - mask
    xum = _dfm(xu, mask)
    fu = apply_f_df(bsr, f_blk, xum)
    gu = apply_bt_df(bsr, xp)
    yu = df32.df_add(fu, gu)
    su = df32.df_mul_f(_dfm(xu, one_m), sigma)
    yu = df32.df_add(_dfm(yu, mask), su)
    yp = apply_b_df(bsr, xum)
    return yu, yp


def rhs_df(bsr: BsrData, f_blk, mask, sigma, m_blk, u, g, dt, rhs_neumann,
           extra=None):
    """df evaluation of the step RHS (models/navier_stokes.py _step_fn):
      b_u = (M u/dt + neumann [+ extra] - A g) * mask + sigma g
      b_p = -(B g)
    ``extra`` is an optional fp32 vector (forcing contribution)."""
    mu = apply_f_df(bsr, m_blk, (u, jnp.zeros_like(u)))
    bu = df32.df_div_f(mu, jnp.float32(dt))
    bu = df32.df_add(bu, df32.df(rhs_neumann))
    if extra is not None:
        bu = df32.df_add(bu, df32.df(extra))
    g_df = (g, jnp.zeros_like(g))
    # A g with zero pressure: the G term vanishes -> pure F apply
    ag_u = apply_f_df(bsr, f_blk, g_df)
    bu = df32.df_sub(bu, ag_u)
    bu = df32.df_add(_dfm(bu, mask), df32.df_mul_f(g_df, sigma))
    ag_p = apply_b_df(bsr, g_df)
    return bu, df32.df_neg(ag_p)


def refine_saddle(bsr: BsrData, f_blk, mask, sigma, b_df, x, solve_fn,
                  n_passes: int):
    """Run ``n_passes`` of compensated iterative refinement.

    x: fp32 (u, p) from the main solve; solve_fn((ru, rp)) -> (du, dp)
    is the fp32 correction solve (FGMRES with the step's preconditioner).
    Returns ((u, p) fp32 rounded, final true-residual norm)."""
    b_u, b_p = b_df
    xu = df32.df(x[0])
    xp = df32.df(x[1])
    for _ in range(n_passes):
        au, ap = apply_saddle_df(bsr, f_blk, mask, sigma, xu, xp)
        ru = df32.df_round(df32.df_sub(b_u, au))
        rp = df32.df_round(df32.df_sub(b_p, ap))
        du, dp = solve_fn((ru, rp))
        xu = df32.df_add(xu, df32.df(du))
        xp = df32.df_add(xp, df32.df(dp))
    au, ap = apply_saddle_df(bsr, f_blk, mask, sigma, xu, xp)
    ru = df32.df_round(df32.df_sub(b_u, au))
    rp = df32.df_round(df32.df_sub(b_p, ap))
    res = jnp.sqrt(jnp.sum(ru * ru) + jnp.sum(rp * rp))
    return (df32.df_round(xu), df32.df_round(xp)), res
