"""Double-float (two-float) compensated arithmetic in fp32.

This module implements the standard error-free transformations (Knuth
two-sum, Dekker split two-product) so selected reductions — Krylov dot
products, residual evaluations, the lift/drag boundary integrals — can run
with ~2^-48 effective precision while every op stays a plain fp32 op.  It
was written for an accelerator without an f64 unit.  On a GPU the
transforms stay exact when XLA compiles them (chip_smoke.py's df32 phase
checks this on the card: no multiply-add contraction breaks them).

Used by the iterative-refinement path of the monolithic solve
(models/navier_stokes.py, ``SolverConfig.refine``) to recover the
reference's f64 solve accuracy (the reference solves in double
throughout, /root/reference/src/NavierStokes.cpp:348, 377) — the fix for
the round-2 fp32 floor on small force coefficients (2D-1 Cl).

A df value is a pair ``(hi, lo)`` of same-shape fp32 arrays with
``|lo| <= ulp(hi)/2``; the represented number is ``hi + lo``.

References: Dekker 1971; Ogita, Rump & Oishi 2005 (dot2); Muller et al.,
"Handbook of Floating-Point Arithmetic" ch. 14.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Dekker splitting constant for fp32 (24-bit significand): 2^12 + 1.
# NB: a Python float, NOT a jnp array — a module-level device array would
# be captured as a lifted jit constant-argument, which breaks executable
# argument-count bookkeeping across repeated chunk invocations (measured:
# "Execution supplied 40 buffers but compiled program expected 41").
_SPLIT = float(np.float32(4097.0))


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b), s+e = a+b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Error-free product via Dekker splitting: p + e = a*b exactly.

    Valid in round-to-nearest fp32 when no overflow occurs in the split
    (|a|,|b| < ~2^115, trivially true here)."""
    p = a * b
    aa = a * _SPLIT
    ahi = aa - (aa - a)
    alo = a - ahi
    bb = b * _SPLIT
    bhi = bb - (bb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def df(hi, lo=None):
    hi = jnp.asarray(hi, jnp.float32)
    return (hi, jnp.zeros_like(hi) if lo is None else jnp.asarray(lo, jnp.float32))


def df_from_f64(x):
    """Split a host f64 array into an (hi, lo) fp32 pair (exact to ~2^-48)."""
    import numpy as np
    hi = np.asarray(x, np.float64).astype(np.float32)
    lo = (np.asarray(x, np.float64) - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def df_to_f64(x):
    import numpy as np
    hi, lo = x
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def df_add(x, y):
    """df + df (Dekker add, ~2^-48 relative error)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return fast_two_sum(s, e)


def df_neg(x):
    return -x[0], -x[1]


def df_sub(x, y):
    return df_add(x, df_neg(y))


def df_mul(x, y):
    """df * df."""
    xh, xl = x
    yh, yl = y
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return fast_two_sum(p, e)


def df_mul_f(x, a):
    """df * fp32."""
    xh, xl = x
    p, e = two_prod(xh, a)
    e = e + xl * a
    return fast_two_sum(p, e)


def df_scale(x, a):
    return df_mul_f(x, jnp.float32(a))


def df_div_f(x, a):
    """df / fp32 (one Newton correction on the fp32 quotient)."""
    xh, xl = x
    q1 = xh / a
    t, e = two_prod(q1, a)
    r = ((xh - t) - e) + xl
    return fast_two_sum(q1, r / a)


def df_select(mask, x, y):
    return jnp.where(mask, x[0], y[0]), jnp.where(mask, x[1], y[1])


def df_round(x):
    """Round df -> fp32 (just the compensated hi part)."""
    return x[0] + x[1]


def df_sum(x, axis=-1):
    """Compensated reduction of a df value along ``axis``.

    Pairwise two-sum tree: log2(n) levels, each level a vectorized
    two_sum of even/odd lanes — error O(eps^2) instead of O(n*eps).
    ``axis`` is normalized to the last axis by moveaxis."""
    hi, lo = x
    if axis != -1 and axis != hi.ndim - 1:
        hi = jnp.moveaxis(hi, axis, -1)
        lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    while n > 1:
        if n % 2 == 1:
            pad = [(0, 0)] * (hi.ndim - 1) + [(0, 1)]
            hi = jnp.pad(hi, pad)
            lo = jnp.pad(lo, pad)
            n += 1
        a = (hi[..., 0::2], lo[..., 0::2])
        b = (hi[..., 1::2], lo[..., 1::2])
        hi, lo = df_add(a, b)
        n //= 2
    return hi[..., 0], lo[..., 0]


def df_dot(a, b):
    """Compensated dot product of two fp32 1-D vectors -> df scalar.

    dot2 of Ogita-Rump-Oishi with a pairwise tree reduction; result is
    as if computed in ~f62 then rounded."""
    p, e = two_prod(a, b)
    return df_sum((p, e), axis=-1)


def df_matvec_flat(vals, xg, x_lo_g=None, vals_lo=None):
    """Compensated flat row-major block matvec row reduction.

    vals: (n, bu, C) fp32 operator values (hi part); xg: (n, C) gathered
    x (hi).  Optional lo parts add the first-order correction terms
    (vals_lo*x_hi + vals_hi*x_lo) — each only needs plain fp32 since they
    are already ~eps smaller.  Returns df (n, bu)."""
    p, e = two_prod(vals, xg[:, None, :])
    if x_lo_g is not None:
        e = e + vals * x_lo_g[:, None, :]
    if vals_lo is not None:
        e = e + vals_lo * xg[:, None, :]
    return df_sum((p, e), axis=-1)
