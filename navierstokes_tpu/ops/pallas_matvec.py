"""Fused multi-component F matvec: a Pallas kernel through Triton.

The hot op of every Krylov iteration is the block-sparse F matvec
(ops/bsr.py apply_f; the SpMV inside the reference's solves,
src/NavierStokes.cpp:377, 978-989).  XLA reduces the flat row-major value
array ``f_blk`` once PER VELOCITY COMPONENT, so it reads the values dim
times.  This kernel reads each (ROW_TILE, bu, C) block of values once and
contracts it against all dim gathered operands.  The column gather stays
outside the kernel (one ``jnp.take`` per component, as in apply_f).

``apply_f_any`` picks the kernel on a GPU for the shapes it takes (see
``fits``) and apply_f everywhere else; apply_f is also the reference the
tests compare with.  On an H100 (400 W limit) at the 1M-DoF bench mesh
the kernel takes a third of apply_f's time per matvec (PERF.md).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Block rows per program: one (ROW_TILE, bu, C) fp32 value block is 64 KB
# at bu=16, C=256, well inside a Hopper SM's shared memory.
ROW_TILE = 4


def _kernel(vals_ref, *refs):
    # refs = (xg_0..xg_{d-1}, out_0..out_{d-1})
    d = len(refs) // 2
    v = vals_ref[...]                                   # (T, bu, C)
    for dd in range(d):
        xg = refs[dd][...]                              # (T, C)
        refs[d + dd][...] = jnp.sum(v * xg[:, None, :], axis=-1)


def fits(f_blk) -> bool:
    """Shapes the kernel takes: fp32 values, ROW_TILE dividing the row
    count, and a power-of-two row width C (Triton's block rule)."""
    n_ext, _, C = f_blk.shape
    return (f_blk.dtype == jnp.float32 and n_ext % ROW_TILE == 0
            and C & (C - 1) == 0)


@functools.partial(jax.jit, static_argnames=("interpret",))
def fused_reduce(f_blk, xgs, interpret=False):
    """out[v, i, dd] = sum_c f_blk[v, i, c] * xgs[dd][v, c].

    f_blk: (n_ext, bu, C) fp32 meeting ``fits``; xgs: tuple of dim
    (n_ext, C) fp32 arrays.  Returns (n_ext, bu, dim) fp32."""
    n_ext, bu, C = f_blk.shape
    d = len(xgs)
    T = ROW_TILE
    outs = pl.pallas_call(
        _kernel,
        grid=(n_ext // T,),
        in_specs=[pl.BlockSpec((T, bu, C), lambda i: (i, 0, 0))]
        + [pl.BlockSpec((T, C), lambda i: (i, 0)) for _ in range(d)],
        out_specs=[pl.BlockSpec((T, bu), lambda i: (i, 0))
                   for _ in range(d)],
        out_shape=[jax.ShapeDtypeStruct((n_ext, bu), jnp.float32)
                   for _ in range(d)],
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        backend="triton",
        interpret=interpret,
        name="f_fused_reduce",
    )(f_blk, *xgs)
    return jnp.stack(outs, axis=-1)


def apply_f_fused(bsr, f_blk, xu, interpret=False):
    """ops.bsr.apply_f through the fused kernel (same semantics)."""
    from navierstokes_tpu.ops.bsr import _fold_overflow, _ublocks
    n_ext, bu, C = f_blk.shape
    d = xu.shape[1]
    xb = _ublocks(bsr, xu)
    xgs = tuple(
        jnp.take(xb[..., dd], bsr.f_cols, axis=0,
                 mode="clip").reshape(n_ext, C)
        for dd in range(d))
    y = fused_reduce(f_blk, xgs, interpret=interpret)   # (n_ext, bu, d)
    y = _fold_overflow(bsr, y)
    return y.reshape(-1, d)[:bsr.n_p2].astype(xu.dtype)


def apply_f_any(bsr, f_blk, xu):
    """The F matvec: the fused kernel when compiling for a GPU and the
    shapes fit, apply_f otherwise."""
    from navierstokes_tpu.ops.bsr import apply_f
    if not fits(f_blk):
        return apply_f(bsr, f_blk, xu)
    return jax.lax.platform_dependent(bsr, f_blk, xu, cuda=apply_f_fused,
                                      default=apply_f)
