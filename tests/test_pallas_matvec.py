"""Fused multi-component F matvec (Triton-route Pallas kernel) against the
XLA apply, in interpret mode on the CPU; and the choice between the two.
The kernel's on-card check is chip_smoke.py's parity and main phases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.ops import assembly
from navierstokes_tpu.ops.bsr import BsrOps, apply_f, build_bsr
from navierstokes_tpu.ops.pallas_matvec import (ROW_TILE, apply_f_any,
                                                apply_f_fused, fits)


@pytest.fixture(scope="module")
def bsr_setup():
    """The operator as the model builds it: 128-row multiple, auto K."""
    mesh = channel_with_cylinder_2d(h=0.12)
    sp = TaylorHoodSpace(mesh)
    cells = assembly.cell_arrays_numpy(sp)
    bsr = build_bsr(sp, cells, row_multiple=128, f_kmax=-1)
    return sp, bsr


def test_row_tile_padding(bsr_setup):
    """The model's 128-row multiple makes the extended row count a
    multiple of the kernel's row tile, so its operator fits the kernel."""
    _, bsr = bsr_setup
    assert bsr.f_cols.shape[0] % ROW_TILE == 0
    assert fits(bsr.k_blk)


def test_fused_matches_xla(bsr_setup):
    sp, bsr = bsr_setup
    rng = np.random.default_rng(0)
    xu = jnp.asarray(rng.standard_normal((sp.n_p2, 2)), jnp.float32)
    f_blk = bsr.k_blk + 0.5 * bsr.m_blk
    y_ref = apply_f(bsr, f_blk, xu)
    y_pl = apply_f_fused(bsr, f_blk, xu, interpret=True)
    np.testing.assert_allclose(np.asarray(y_pl), np.asarray(y_ref),
                               rtol=2e-5, atol=2e-5)


def test_fused_matches_xla_bf16(bsr_setup):
    """bf16 values (inner_bf16) do not fit the kernel: they take the XLA
    mixed-precision path, bit for bit."""
    sp, bsr = bsr_setup
    rng = np.random.default_rng(1)
    xu = jnp.asarray(rng.standard_normal((sp.n_p2, 2)), jnp.float32)
    f_blk = (bsr.k_blk + 0.5 * bsr.m_blk).astype(jnp.bfloat16)
    assert not fits(f_blk)
    np.testing.assert_array_equal(np.asarray(apply_f_any(bsr, f_blk, xu)),
                                  np.asarray(apply_f(bsr, f_blk, xu)))


@pytest.mark.parametrize("platform, fused", [("cpu", False), ("cuda", True)])
def test_kernel_chosen_for_gpu_only(bsr_setup, platform, fused):
    """apply_f_any lowers to the Triton kernel for CUDA and to plain XLA
    for the CPU."""
    sp, bsr = bsr_setup
    f_blk = bsr.k_blk + 0.5 * bsr.m_blk
    xu = jnp.ones((sp.n_p2, 2), jnp.float32)
    text = jax.jit(apply_f_any).trace(bsr, f_blk, xu).lower(
        lowering_platforms=(platform,)).as_text()
    assert ("f_fused_reduce" in text) == fused


def test_non_power_of_two_width_takes_xla(bsr_setup):
    sp, bsr = bsr_setup
    f_blk = jnp.zeros((bsr.f_cols.shape[0], bsr.bu, 384), jnp.float32)
    assert not fits(f_blk)
    assert fits(f_blk[:, :, :256])


def test_sharded_operator_keeps_xla_matvec():
    """A Pallas call is opaque to the SPMD partitioner: only the
    single-device operator takes the fused kernel."""
    assert BsrOps(fused_f=False)._apply_f is apply_f
    assert BsrOps()._apply_f is apply_f_any
