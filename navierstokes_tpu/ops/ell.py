"""Node-graph ELL operators — the fast path for Krylov matvecs.

The gather -> batched-matmul -> segment-sum formulation (ops/operators.py)
re-does the element scatter on EVERY operator application, many times the
~30 MB of traffic a matvec at ~400k DoF fundamentally needs.

This module assembles the *node-coupling graph* once per step instead:

  * velocity-velocity scalar block F (same for every component):
      f_cols (n_p2, K) neighbor node ids,  f_vals (n_p2, K)
      apply: y[i, d] = sum_k f_vals[i,k] * x[f_cols[i,k], d]
    -> one gather + FMA per matvec; the element->graph reduction (a single
      presorted segment-sum over nc * n_v^2 values) happens ONCE per time
      step when the convection block is rebuilt (reference rebuilds the
      whole sparse matrix per step, src/NavierStokes.cpp:154-294).
  * pressure-gradient G and continuity G^T as static ELL blocks
      g_cols/g_vals (n_p2, Kg[, dim]) and b_cols/b_vals (n_p1, Kb, dim)
    (the pressure coupling never changes between steps).
  * static mass/stiffness ELL values so F = M/dt + nu K + C(u) is a pure
    elementwise combination in graph format.

This is the static-sparsity "ELL + segment-sum scatter" design called for
in SURVEY.md par.7 (build plan, step 3).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu.ops.assembly import CellArrays
from navierstokes_tpu.ops.operators import Scatter, build_scatter, \
    convection_matrices


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EllData:
    """Device pytree: node-graph operator data + per-step assembly plan."""
    # element-level data needed to rebuild convection each step
    cell_p2: jax.Array       # (nc, n_v) int32
    detj: jax.Array          # (nc,)
    jinv: jax.Array          # (nc, dim, dim)
    t_hat: jax.Array         # reference convection tensor
    # element->graph reduction plan for the F block
    f_slot_scatter: Scatter  # flat (nc*n_v*n_v) -> (n_p2*K) slots
    # F graph (velocity-velocity scalar)
    f_cols: jax.Array        # (n_p2, K) int32
    f_diag_slot: jax.Array   # (n_p2,) int32 — slot k with f_cols[i,k]==i
    m_vals: jax.Array        # (n_p2, K) static mass graph
    k_vals: jax.Array        # (n_p2, K) static stiffness graph
    # pressure coupling (static)
    g_cols: jax.Array        # (n_p2, Kg) int32 (cols are p nodes)
    g_vals: jax.Array        # (n_p2, Kg, dim)
    b_cols: jax.Array        # (n_p1, Kb) int32 (cols are velocity nodes)
    b_vals: jax.Array        # (n_p1, Kb, dim)
    # curved (boundary-snapped) cell subset for the per-step convection fix
    curv_ids: object = None
    curv_nodes: object = None
    curv_phi: object = None
    curv_dphys: object = None


def _ragged_to_ell(rows, cols, n_rows, pad_col=0):
    """rows/cols int64 arrays of equal length (duplicates allowed but not
    expected) -> (ell_cols (n_rows, K), slot_of_pair fn).  Returns ell_cols
    and a dict mapping (row, col) -> k."""
    order = np.lexsort((cols, rows))
    r, c = rows[order], cols[order]
    # unique (row, col)
    first = np.ones(len(r), dtype=bool)
    first[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    ru, cu = r[first], c[first]
    counts = np.bincount(ru, minlength=n_rows)
    K = int(counts.max()) if len(counts) else 1
    ell_cols = np.full((n_rows, K), pad_col, dtype=np.int64)
    # position within row
    row_start = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=row_start[1:])
    k_of = np.arange(len(ru)) - row_start[ru]
    ell_cols[ru, k_of] = cu
    return ell_cols, (ru, cu, k_of), K


def build_ell(space: TaylorHoodSpace, cells: CellArrays,
              dtype=jnp.float32) -> EllData:
    """Host-side construction of the node graphs + per-step reduction plan.

    ``cells`` must be the HOST (numpy) CellArrays from
    assembly.cell_arrays_numpy — device arrays would round-trip."""
    rs = space.rs
    n_p2, n_p1 = space.n_p2, space.n_p1
    cp2 = np.asarray(space.cell_p2, dtype=np.int64)      # (nc, n_v)
    cp1 = np.asarray(space.cell_p1, dtype=np.int64)      # (nc, n_p)
    nc, nv = cp2.shape
    npp = cp1.shape[1]
    dim = space.dim

    # ---- F graph: all (i, j) node pairs sharing a cell ------------------
    rows = np.repeat(cp2, nv, axis=1).reshape(-1)        # i = cell_p2[c,a]
    colsj = np.tile(cp2, (1, nv)).reshape(-1)            # j = cell_p2[c,b]
    f_cols, (ru, cu, k_of), K = _ragged_to_ell(rows, colsj, n_p2)

    # slot of each (cell,a,b) pair: searchsorted into the unique pair list
    pair_key = ru * np.int64(n_p2) + cu
    want = rows * np.int64(n_p2) + colsj
    pos = np.searchsorted(pair_key, want)
    slot_flat = ru[pos] * np.int64(K) + k_of[pos]        # (nc*nv*nv,)
    f_slot_scatter = build_scatter(slot_flat.astype(np.int32).reshape(-1, 1),
                                   n_p2 * K)

    # diag slot per node
    diag_slot = np.zeros(n_p2, dtype=np.int64)
    self_mask = ru == cu
    diag_slot[ru[self_mask]] = k_of[self_mask]

    # static graphs via the same reduction, on host
    def reduce_to_ell(elem_vals):
        out = np.zeros(n_p2 * K)
        np.add.at(out, slot_flat, elem_vals.reshape(-1))
        return out.reshape(n_p2, K)

    m_vals = reduce_to_ell(np.asarray(cells.mass, np.float64))
    k_vals = reduce_to_ell(np.asarray(cells.stiff, np.float64))

    # ---- G graph (u-node rows, p-node cols), static ----------------------
    grad = np.asarray(cells.grad, np.float64)            # (nc, n_v, dim, n_p)
    g_rows = np.repeat(cp2, npp, axis=1).reshape(-1)     # (nc*nv*npp)
    g_colsj = np.tile(cp1, (1, nv)).reshape(-1)
    g_cols, (gru, gcu, gk_of), Kg = _ragged_to_ell(g_rows, g_colsj, n_p2)
    gkey = gru * np.int64(n_p1) + gcu
    gwant = g_rows * np.int64(n_p1) + g_colsj
    gpos = np.searchsorted(gkey, gwant)
    g_slot = gru[gpos] * np.int64(Kg) + gk_of[gpos]
    g_vals = np.zeros((n_p2 * Kg, dim))
    # grad[c,a,d,j] contributes to row cp2[c,a], col cp1[c,j], component d
    vals = grad.transpose(0, 1, 3, 2).reshape(-1, dim)   # (nc*nv*npp, dim)
    np.add.at(g_vals, g_slot, vals)
    g_vals = g_vals.reshape(n_p2, Kg, dim)

    # ---- B graph (p-node rows, u-node cols), static = G^T ---------------
    b_rows = np.repeat(cp1, nv, axis=1).reshape(-1)      # (nc*npp*nv)
    b_colsj = np.tile(cp2, (1, npp)).reshape(-1)
    b_cols, (bru, bcu, bk_of), Kb = _ragged_to_ell(b_rows, b_colsj, n_p1)
    bkey = bru * np.int64(n_p2) + bcu
    bwant = b_rows * np.int64(n_p2) + b_colsj
    bpos = np.searchsorted(bkey, bwant)
    b_slot = bru[bpos] * np.int64(Kb) + bk_of[bpos]
    b_vals = np.zeros((n_p1 * Kb, dim))
    # grad[c,b,d,j] contributes to row cp1[c,j], col cp2[c,b], component d
    bvals_src = grad.transpose(0, 3, 1, 2).reshape(-1, dim)  # (nc*npp*nv, dim)
    np.add.at(b_vals, b_slot, bvals_src)
    b_vals = b_vals.reshape(n_p1, Kb, dim)

    f = lambda x: jnp.asarray(x, dtype)
    from navierstokes_tpu.ops.assembly import curved_conv_inputs
    ci, cn, cphi, cdphys = curved_conv_inputs(space)
    return EllData(
        curv_ids=None if ci is None else jnp.asarray(ci),
        curv_nodes=None if ci is None else jnp.asarray(cn),
        curv_phi=None if ci is None else f(cphi),
        curv_dphys=None if ci is None else f(cdphys),
        cell_p2=jnp.asarray(space.cell_p2),
        detj=f(cells.detj), jinv=f(cells.jinv),
        t_hat=f(rs.T_hat),
        f_slot_scatter=f_slot_scatter,
        f_cols=jnp.asarray(f_cols.astype(np.int32)),
        f_diag_slot=jnp.asarray(diag_slot.astype(np.int32)),
        m_vals=f(m_vals), k_vals=f(k_vals),
        g_cols=jnp.asarray(g_cols.astype(np.int32)), g_vals=f(g_vals),
        b_cols=jnp.asarray(b_cols.astype(np.int32)), b_vals=f(b_vals),
    )


# ---------------------------------------------------------------------------
# jit-able operator pieces (f_vals is the per-step assembled F graph)
# ---------------------------------------------------------------------------


def convection_graph(ell: EllData, u: jax.Array) -> jax.Array:
    """Per-step convection in graph format: element matrices -> one sorted
    segment-sum into the (n_p2, K) slots."""
    # element matrices (nc, n_v, n_v) — same math as operators.py
    cells_like = _CellView(ell)
    c_elem = convection_matrices(cells_like, ell.t_hat, u)
    flat = c_elem.reshape(-1, 1)
    vals = ell.f_slot_scatter(flat)                     # (n_p2*K, 1)
    K = ell.f_cols.shape[1]
    return vals.reshape(-1, K)


class _CellView:
    """Duck-typed CellArrays view with just what convection_matrices needs."""

    def __init__(self, ell: EllData):
        self.cell_p2 = ell.cell_p2
        self.jinv = ell.jinv
        self.detj = ell.detj
        self.curv_ids = ell.curv_ids
        self.curv_nodes = ell.curv_nodes
        self.curv_phi = ell.curv_phi
        self.curv_dphys = ell.curv_dphys


def apply_f(ell: EllData, f_vals: jax.Array, xu: jax.Array) -> jax.Array:
    """(n_p2, dim) -> (n_p2, dim): y[i,d] = sum_k f_vals[i,k] x[cols[i,k],d]."""
    xg = jnp.take(xu, ell.f_cols, axis=0, mode="clip")               # (n_p2, K, dim)
    return jnp.einsum("ik,ikd->id", f_vals, xg)


def apply_bt(ell: EllData, xp: jax.Array) -> jax.Array:
    """G p: (n_p1,) -> (n_p2, dim)."""
    pg = jnp.take(xp, ell.g_cols, axis=0, mode="clip")               # (n_p2, Kg)
    return jnp.einsum("ikd,ik->id", ell.g_vals, pg)


def apply_b(ell: EllData, xu: jax.Array) -> jax.Array:
    """G^T u: (n_p2, dim) -> (n_p1,)."""
    ug = jnp.take(xu, ell.b_cols, axis=0, mode="clip")               # (n_p1, Kb, dim)
    return jnp.einsum("jkd,jkd->j", ell.b_vals, ug)


def f_diag(ell: EllData, f_vals: jax.Array) -> jax.Array:
    return jnp.take_along_axis(f_vals, ell.f_diag_slot[:, None],
                               axis=1)[:, 0]


def mass_apply(ell: EllData, u: jax.Array) -> jax.Array:
    xg = jnp.take(u, ell.f_cols, axis=0, mode="clip")
    return jnp.einsum("ik,ikd->id", ell.m_vals, xg)


def schur_diag(ell: EllData, node_weights: jax.Array) -> jax.Array:
    """diag(B W B^T)[j] ~= sum_{k,d} b_vals[j,k,d]^2 w[cols[j,k]]."""
    w = jnp.take(node_weights, ell.b_cols, axis=0, mode="clip")      # (n_p1, Kb)
    return jnp.einsum("jkd,jkd,jk->j", ell.b_vals, ell.b_vals, w)


class EllOps:
    """Ops-interface implementation over EllData (see models/navier_stokes).

    'f_cell' in the step function is the per-step (n_p2, K) graph values
    here, and 'a0' the static M/dt + nu*K graph."""

    def convection(self, params, u):
        return convection_graph(params.cells, u)

    def apply_blocks(self, params, f_vals, xu, xp, with_f=True, with_g=True,
                     with_gt=True):
        ell = params.cells
        yu = None
        if with_f:
            yu = apply_f(ell, f_vals, xu)
        if with_g:
            g = apply_bt(ell, xp)
            yu = g if yu is None else yu + g
        if yu is None:
            yu = jnp.zeros_like(xu)
        yp = apply_b(ell, xu) if with_gt else jnp.zeros_like(xp)
        # layout pin (see ops/operators.py)
        return yu + 0.0 * xu, yp + 0.0 * xp

    def f_diag(self, params, f_vals):
        return f_diag(params.cells, f_vals)

    def mass_apply(self, params, u):
        return mass_apply(params.cells, u)

    def schur_diag(self, params, node_weights):
        return schur_diag(params.cells, node_weights)
