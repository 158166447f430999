"""Host-assembled static operators in blocked-ELL form + the block-Jacobi
velocity preconditioner.

Two performance-critical replacements for round-1 machinery (reference
behavior: Trilinos assembled sparse matrices + ILU, src/NavierStokes.cpp:
934-963):

* ``assemble_ap`` — the Cahouet-Chabard pressure operator
  Ap = B diag(w) B^T assembled ONCE on the host into a compact P1-graph
  blocked ELL (~5 MB at 1M DoF).  Round 1 applied Ap matrix-free as
  B(w * B^T v), streaming ~1.3 GB of G/B block values per application —
  the assembled form is ~250x less memory traffic per V-cycle smoothing
  step.

* ``BlockJacobi`` — extracts the (tile) diagonal of the per-step F
  operator from its BSR blocks and inverts all tiles with batched dense
  matmuls.  Applying the inverse is a batched (tile,tile)@(tile,dim)
  matmul: zero gathers, aligned reads.  This is the replacement for the
  reference's ILU(0) on the velocity block
  (src/NavierStokes.cpp:958): triangular solves don't vectorize, dense
  tile inverses do.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

_static = dict(static=True)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class EllBlocked:
    """Square blocked-ELL matrix over one scalar field (P1 pressure).

    Values use the flat row-major layout (n_b, b, K*b) with K padded so
    K*b is a multiple of 128 — the matvec reduce then runs with the
    128-lane axis fully utilized (see ops/bsr.py BsrData)."""
    cols: jax.Array    # (n_b, K) int32 block columns
    vals: jax.Array    # (n_b, b, K*b)
    diag: jax.Array    # (n,) assembled diagonal
    n: int = dataclasses.field(metadata=_static)
    b: int = dataclasses.field(metadata=_static)


def _to_blocked_ell(rows, cols, vals, n, b, dtype):
    """COO (with duplicates) -> blocked ELL, summing duplicates."""
    n_b = -(-n // b)
    RI = rows // b
    CJ = cols // b
    stride = np.int64(n_b + 1)
    key = RI.astype(np.int64) * stride + CJ
    uk = np.unique(key)
    ru = (uk // stride).astype(np.int64)
    counts = np.bincount(ru, minlength=n_b)
    K = max(1, int(counts.max()))
    lane_k = max(1, 128 // b)
    K = -(-K // lane_k) * lane_k
    row_start = np.zeros(n_b + 1, np.int64)
    np.cumsum(counts, out=row_start[1:])
    k_of = np.arange(len(uk)) - row_start[ru]
    table = np.zeros((n_b, K), np.int64)
    table[ru, k_of] = uk % stride
    pos = np.searchsorted(uk, key)
    kb = k_of[pos]
    out = np.zeros((n_b, K, b, b))
    np.add.at(out, (RI, kb, rows % b, cols % b), vals)
    diag = np.zeros(n)
    d = rows == cols
    np.add.at(diag, rows[d], vals[d])
    flat = out.transpose(0, 2, 1, 3).reshape(n_b, b, K * b)
    ret = EllBlocked(cols=jnp.asarray(table.astype(np.int32)),
                     vals=jnp.asarray(flat, dtype),
                     diag=jnp.asarray(diag, dtype), n=n, b=b)
    # host copies (plain attributes) for setup-time consumers — avoids
    # pulling the device arrays back; these keep the (n_b, K, b, b) BLOCK
    # layout
    ret.host_vals = out
    ret.host_cols = table
    return ret


def ell_matvec(m: EllBlocked, x):
    """Blocked-ELL matvec: flat row-major elementwise mult-reduce."""
    n_b, K = m.cols.shape
    pad = n_b * m.b - m.n
    xb = jnp.pad(x, (0, pad)).reshape(n_b, m.b)
    xg = jnp.take(xb, m.cols, axis=0, mode="clip").reshape(n_b, K * m.b)
    if m.vals.dtype == jnp.bfloat16:
        prod = m.vals * xg.astype(jnp.bfloat16)[:, None, :]
        y = prod.astype(jnp.float32).sum(-1).astype(x.dtype)
    else:
        y = (m.vals * xg[:, None, :]).sum(-1)           # (n_b, b)
    return y.reshape(-1)[:m.n]


def assemble_ap(space, cells_host, w, dtype, b=16, dirichlet_nodes=None):
    """Ap = sum_d B_d diag(w) B_d^T on the P1-P1 graph (host, numpy).

    ``w``: (n_p2,) weights (BC mask / lumped mass).  B_d entries come from
    the same integrals as the reference's pressure-velocity coupling
    (src/NavierStokes.cpp:222-229): B[d][q, v] = -(grad phi_v)_d psi_q
    integrated — here taken from the per-cell grad tensor.

    ``dirichlet_nodes``: optional P1 node ids whose rows/cols are
    eliminated (unit diagonal, diag-mean scaled) — used by the projection
    scheme to pin phi = 0 on the outflow boundary, which removes the
    all-Neumann nullspace and the open-boundary instability."""
    import scipy.sparse as sp

    cp2 = np.asarray(space.cell_p2, np.int64)
    cp1 = np.asarray(space.cell_p1, np.int64)
    nc, nv = cp2.shape
    npp = cp1.shape[1]
    grad = np.asarray(cells_host.grad, np.float64)       # (nc, nv, dim, npp)
    dim = grad.shape[2]
    rows = np.repeat(cp1, nv, axis=1).ravel()            # p index
    cols = np.tile(cp2, (1, npp)).ravel()                # u node index
    ap = None
    for d in range(dim):
        v = grad[:, :, d, :].transpose(0, 2, 1).reshape(-1)
        B = sp.csr_matrix((v, (rows, cols)), shape=(space.n_p1, space.n_p2))
        t = (B.multiply(np.asarray(w)[None, :])) @ B.T
        ap = t if ap is None else ap + t
    if dirichlet_nodes is not None and len(dirichlet_nodes):
        ap = ap.tolil()
        scale = np.abs(ap.diagonal()).mean() + 1e-30
        ap[dirichlet_nodes, :] = 0.0
        ap[:, dirichlet_nodes] = 0.0
        ap[dirichlet_nodes, dirichlet_nodes] = scale
        ap = ap.tocsr()
    ap = ap.tocoo()
    out = _to_blocked_ell(ap.row.astype(np.int64), ap.col.astype(np.int64),
                          ap.data, space.n_p1, b, dtype)
    return out


def assemble_p1_stiffness(space, cells_host, dtype, b=16,
                          dirichlet_nodes=None):
    """Consistent P1 stiffness Laplacian  L[q, r] = int grad psi_q .
    grad psi_r dx  as a blocked ELL (host assembly).

    This is the PRESSURE-POISSON operator of the projection scheme
    (IPCS-style approximate projection).  Measured essential: using the
    compatible B W B^T instead excites an exponentially growing outflow
    mode on the cylinder channel; the consistent Laplacian is stable.
    ``dirichlet_nodes`` pins phi = 0 there (the outflow boundary)."""
    import scipy.sparse as sp

    from navierstokes_tpu.ops.assembly import geometric_factors
    detj, jinv = geometric_factors(space)
    dim = space.dim
    if dim == 2:
        gref = np.array([[-1., -1.], [1., 0.], [0., 1.]])
        meas = 0.5
    else:
        gref = np.array([[-1., -1., -1.],
                         [1., 0., 0.], [0., 1., 0.], [0., 0., 1.]])
        meas = 1.0 / 6.0
    gp = np.einsum("ax,cxd->cad", gref, jinv)        # physical gradients
    ke = np.einsum("cad,cbd,c->cab", gp, gp, detj * meas)
    cd = space.curved_data() if hasattr(space, "curved_data") else None
    if cd is not None:
        # boundary-snapped (curved) cells: per-point quadratic geometry
        wdet = cd.qw[None, :] * cd.detj_q
        gp_k = np.einsum("ax,kqxd->kqad", gref, cd.jinv_q)
        ke[cd.ids] = np.einsum("kq,kqad,kqbd->kab", wdet, gp_k, gp_k)
    cp1 = np.asarray(space.cell_p1, np.int64)
    npp = cp1.shape[1]
    rows = np.repeat(cp1, npp, axis=1).ravel()
    cols = np.tile(cp1, (1, npp)).ravel()
    L = sp.csr_matrix((ke.ravel(), (rows, cols)),
                      shape=(space.n_p1, space.n_p1))
    if dirichlet_nodes is not None and len(dirichlet_nodes):
        L = L.tolil()
        scale = np.abs(L.diagonal()).mean() + 1e-30
        L[dirichlet_nodes, :] = 0.0
        L[:, dirichlet_nodes] = 0.0
        L[dirichlet_nodes, dirichlet_nodes] = scale
        L = L.tocsr()
    L = L.tocoo()
    return _to_blocked_ell(L.row.astype(np.int64), L.col.astype(np.int64),
                           L.data, space.n_p1, b, dtype)


def coarse_from_ell(m: EllBlocked, agg_blocks: int):
    """Galerkin coarse matrix over aggregates of ``agg_blocks`` consecutive
    blocks: S_c[a, b] = sum of entries between the aggregates (host)."""
    n_b, K = m.cols.shape
    vals = getattr(m, "host_vals", None)
    cols = getattr(m, "host_cols", None)
    if vals is None:
        vals = np.asarray(jax.device_get(m.vals), np.float64)
        cols = np.asarray(m.cols)
    n_agg = -(-n_b // agg_blocks)
    ra = np.repeat(np.arange(n_b) // agg_blocks, K)
    ca = (cols // agg_blocks).reshape(-1)
    s = vals.sum(axis=(2, 3)).reshape(-1)
    sc = np.zeros((n_agg, n_agg))
    np.add.at(sc, (ra, ca), s)
    return sc


# ---------------------------------------------------------------------------
# block-Jacobi tile preconditioner for F
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BlockJacobiPlan:
    """Static gather plan: BSR pair slots -> (n_tiles, S*bu, S*bu) tile
    diagonals.  ``idx[t, s, s']`` is the FLAT element index of
    f_blk[v, 0, k*bu] for the (v, k) slot holding tile t's (s, s') block —
    the tile build then gathers scalars at idx + i*C + j, which produces
    the (n_tiles, S*bu, S*bu) result directly with a 128-multiple minor
    axis.  (The previous formulation reshaped f_blk into (n*K, bu, bu)
    blocks first, a narrow-minor layout that tiled memory layouts pad.)
    Missing pairs point at a trailing bu*C zero row appended by the
    consumer."""
    idx: jax.Array      # (n_tiles, S, S) int32 flat base indices
    n_tiles: int = dataclasses.field(metadata=_static)
    S: int = dataclasses.field(metadata=_static)   # block-rows per tile
    bu: int = dataclasses.field(metadata=_static)
    n_p2: int = dataclasses.field(metadata=_static)
    # tile formulation: "blocked" (gather whole (bu,bu) blocks — few long
    # gather rows, but narrow-minor (..., bu, bu) intermediates), "rows"
    # (gather bu-wide rows — smaller intermediates, but still a
    # (n_vb_ext*bu*KB, bu) reshape of the WHOLE value array), or
    # "scatter" (assemble the tile
    # values DIRECTLY from the per-cell convection matrices with a
    # presorted segment-sum, exactly like the flat-value convection
    # assembly, plus a host-precomputed static base — no gather, no
    # padded transient, output is the lane-perfect (n_tiles, SB, SB)).
    # See build_block_jacobi_plan for the auto rule and measurements.
    layout: str = dataclasses.field(metadata=_static, default="rows")
    # "scatter"-formulation arrays (None otherwise):
    con_row: object = None   # (ncon,) int32 source row = cell*n_v + a
    cpos: object = None      # (ncon, n_v) int32 dest column in the tile
    #                          (-1 = column outside this tile)
    seg: object = None       # (ncon,) int32 dest tile row, ascending
    # static segment-aligned chunking of the scatter segment-sum (same
    # transient-size concern as BsrData.con_splits)
    splits: tuple = dataclasses.field(metadata=_static, default=None)


def build_block_jacobi_plan(bsr, S: int = 8, layout: str = "auto",
                            cell_p2_host=None) -> BlockJacobiPlan:
    f_cols = getattr(bsr, "host_f_cols", None)           # (n_vb_ext, KB)
    if f_cols is None:
        f_cols = np.asarray(bsr.f_cols, np.int64)
    n_vb_ext, KB = f_cols.shape
    # overflow split (ops/bsr.py): rows past n_vb are virtual spill rows of
    # the physical row host_ovf_rows[v]; their slots belong to that row's
    # tile diagonal like any other
    ovf = getattr(bsr, "host_ovf_rows", None)
    n_vb = getattr(bsr, "n_vb", 0) or n_vb_ext
    if ovf is None and n_vb_ext > n_vb:
        ovf = np.asarray(bsr.ovf_rows, np.int64)
    row_phys = np.arange(n_vb_ext)
    if n_vb_ext > n_vb:
        row_phys[n_vb:] = ovf
    n_tiles = -(-n_vb // S)
    bu = bsr.bu
    C = KB * bu
    # base = flat index of f_blk[v, 0, k*bu]; missing pairs -> the zero
    # bu*C row the tile build appends after the n_vb_ext*bu*C real values
    zero_base = n_vb_ext * bu * C
    if zero_base + bu * C >= 2 ** 31:
        raise ValueError("block-Jacobi flat indices exceed int32 range "
                         f"(n_vb_ext={n_vb_ext}, C={C}); shard the operator")
    idx = np.full((n_tiles, S, S), zero_base, np.int64)
    r = np.repeat(row_phys, KB)
    v = np.repeat(np.arange(n_vb_ext), KB)
    k = np.tile(np.arange(KB), n_vb_ext)
    c = f_cols.reshape(-1)
    on_tile = (r // S) == (c // S)
    r, v, k, c = r[on_tile], v[on_tile], k[on_tile], c[on_tile]
    # ELL padding slots carry block-column 0 with zero values; write
    # k-descending, virtual rows first, so a real physical (r, 0) pair
    # (low k) overwrites any padding collision rather than the reverse
    order = np.lexsort((-k, -v))
    r, v, k = r[order], v[order], k[order]
    c = c[order]
    idx[r // S, r % S, c % S] = (v * bu * KB + k) * bu
    if layout == "auto":
        # "blocked" gathers whole (bu, bu) blocks (S*S long rows per tile
        # instead of SB*S short ones).  Its two transients — blocks
        # (n_vb_ext*KB, bu, bu) and tiles (n_tiles, S, S, bu, bu) — have
        # a narrow minor axis, which the accelerator the solver was first
        # built for padded to 128 (second-minor to 8); pick it only while
        # that padded sum stays under 8 GB (the 2D 1M-DoF bench mesh:
        # 7.6 GB; the 1.8M-DoF 3D mesh: ~22 GB).  Not yet re-derived on a
        # GPU, which pads nothing.
        minor = max(128, bu)
        smajor = max(8, bu)
        padded = (n_vb_ext * KB + n_tiles * S * S) * smajor * minor * 4
        if padded < 8e9:
            layout = "blocked"
        else:
            # past the blocked budget, prefer the transient-free scatter
            # assembly; "rows" (its own 8x-padded reshape of the whole
            # value array: the 3.39M-DoF OOM, logs/st_3d1_34M.log) only
            # if the cell map was not provided
            layout = "scatter" if cell_p2_host is not None else "rows"
    con_row = cpos = seg = None
    if layout == "scatter":
        if cell_p2_host is None:
            raise ValueError("layout='scatter' needs cell_p2_host")
        cp2 = np.asarray(cell_p2_host, np.int64)          # (nc, nv) UNpadded
        nc, nv = cp2.shape
        SB = S * bu
        r_all = cp2.reshape(-1)                           # row node of (c, a)
        order = np.argsort(r_all, kind="stable")
        src = order.astype(np.int64)                      # = c*nv + a
        seg_np = r_all[order]
        t_of = seg_np // SB
        cols = cp2[src // nv]                             # (ncon, nv)
        cpos_np = cols - (t_of * SB)[:, None]
        cpos_np = np.where((cpos_np >= 0) & (cpos_np < SB), cpos_np, -1)
        ncon = -(-len(src) // 8) * 8
        if ncon > len(src):
            padn = ncon - len(src)
            src = np.concatenate([src, np.zeros(padn, np.int64)])
            cpos_np = np.concatenate(
                [cpos_np, np.full((padn, nv), -1, np.int64)])
            seg_np = np.concatenate(
                [seg_np, np.full(padn, n_tiles * SB - 1, np.int64)])
        con_row = jnp.asarray(src.astype(np.int32))
        cpos = jnp.asarray(cpos_np.astype(np.int32))
        seg = jnp.asarray(seg_np.astype(np.int32))
        from navierstokes_tpu.ops.bsr import segsum_splits
        splits = segsum_splits(seg_np, SB, n_tiles * SB)
    else:
        splits = None
    ret = BlockJacobiPlan(idx=jnp.asarray(idx.astype(np.int32)),
                          n_tiles=n_tiles, S=S, bu=bsr.bu, n_p2=bsr.n_p2,
                          layout=layout, con_row=con_row, cpos=cpos,
                          seg=seg, splits=splits)
    # host copy for static_tiles_host (never pull the device idx back);
    # plain attribute — survives on the model-side object,
    # not through pytree flattening
    ret.host_idx = idx
    return ret


def static_tiles_host(plan: BlockJacobiPlan, idx_host, a0_flat_host,
                      Cw: int) -> np.ndarray:
    """Host (numpy) gather of the STATIC operator's tile diagonals for the
    "scatter" formulation: tiles0[t, s*bu+i, s2*bu+j] =
    a0[idx[t,s,s2] + i*Cw + j].  Computed once per (dt, nu) at setup —
    the per-step convection part is then segment-summed on device
    (block_jacobi_tiles) with no gather at all."""
    bu, S = plan.bu, plan.S
    a0e = np.concatenate([np.asarray(a0_flat_host, np.float64).reshape(-1),
                          np.zeros(bu * Cw)])
    base = np.asarray(idx_host, np.int64)                  # (t, S, S)
    off = np.arange(bu)[:, None] * Cw + np.arange(bu)[None, :]  # (bu, bu)
    g = a0e[base[:, :, None, :, None] + off[None, None, :, None, :]]
    # (t, s, i, s2, j) -> (t, s*bu+i, s2*bu+j)
    SB = S * bu
    return np.ascontiguousarray(g.reshape(plan.n_tiles, SB, SB))


def _tiles_scatter(plan: BlockJacobiPlan, c_elem, tiles0):
    """Device tile assembly for the "scatter" formulation: per-cell
    convection element matrices -> tile values via one-hot row expansion
    + presorted segment-sum (the same mechanism as the flat-value
    convection assembly, ops/bsr.convection_blk), added onto the static
    base.  No gather from the value array, no lane-padded transient —
    the round-5 fix for the 14.8 GiB 'rows'-reshape OOM at 3.39M DoF."""
    SB = plan.S * plan.bu
    if c_elem is None:
        return tiles0
    from navierstokes_tpu.ops.bsr import onehot_segsum
    nv = c_elem.shape[-1]
    c6 = c_elem.reshape(-1, nv)
    splits = plan.splits or ((0, plan.con_row.shape[0], 0,
                              plan.n_tiles * SB),)
    t = onehot_segsum(c6, plan.con_row, plan.cpos, plan.seg, SB, splits,
                      c_elem.dtype)
    return tiles0 + t.reshape(plan.n_tiles, SB, SB).astype(tiles0.dtype)


def block_jacobi_tiles(plan: BlockJacobiPlan, f_blk, mask_flat, sigma,
                       c_elem=None, tiles0=None):
    """Gather the tile diagonals of the BC-masked F.

    f_blk: flat row-major (n_vb_ext, bu, KB*bu) — see ops/bsr.BsrData;
    mask_flat: (n_p2,) 1=interior 0=Dirichlet.
    The masked operator is  M F M + sigma (I - M); tiles are built
    accordingly so the inverse is exact on constrained rows.

    Formulations, picked statically by ``plan.layout`` (see
    build_block_jacobi_plan): gathers cost by the NUMBER of gathered rows
    on the accelerator the solver was first built for, so "blocked" (S*S
    whole-(bu,bu)-block rows per tile) beat "rows" (SB*S bu-wide rows per
    tile) there — but its (..., bu, bu) intermediates were lane-padded,
    so "rows" or "scatter" take over at scale.  A scalar-element-wise
    gather (n_tiles*SB*SB single-element rows) was far slower than
    either."""
    bu = plan.bu
    SB = plan.S * bu
    if plan.layout == "scatter":
        t = _tiles_scatter(plan, c_elem, tiles0)
        n = plan.n_tiles * SB
        m = jnp.pad(mask_flat, (0, n - plan.n_p2)).reshape(plan.n_tiles, SB)
        t = t * m[:, :, None] * m[:, None, :]
        eye = jnp.eye(SB, dtype=t.dtype)
        t = t + (sigma * (1.0 - m))[:, :, None] * eye[None]
        return t.astype(jnp.float32)
    n_vb, bu, C = f_blk.shape
    KB = C // bu
    if plan.layout == "blocked":
        # gather whole (bu, bu) blocks: derive the block index v*KB + k
        # from the stored flat base (v*bu*KB + k)*bu
        blocks = f_blk.reshape(n_vb, bu, KB, bu).transpose(0, 2, 1, 3)
        flat = jnp.concatenate(
            [blocks.reshape(n_vb * KB, bu, bu),
             jnp.zeros((1, bu, bu), f_blk.dtype)], axis=0)
        base = plan.idx // bu                                  # v*bu*KB + k
        v = base // (bu * KB)
        bidx = jnp.minimum(v * KB + (base - v * (bu * KB)), n_vb * KB)
        tiles = jnp.take(flat, bidx, axis=0, mode="clip")      # (t,S,S,bu,bu)
        t = jnp.transpose(tiles, (0, 1, 3, 2, 4)).reshape(
            plan.n_tiles, SB, SB)
    else:
        # rows of width bu: slot (v, k) element-row i lives at row
        # idx//bu + i*KB of f_blk.reshape(-1, bu); C trailing zero rows
        # back the "missing pair" sentinel
        # (zero_base//bu + (bu-1)*KB < total)
        f_rows = jnp.concatenate(
            [f_blk.reshape(-1, bu), jnp.zeros((C, bu), f_blk.dtype)])
        i_off = jnp.arange(bu, dtype=jnp.int32) * KB           # (bu,)
        ridx = (plan.idx // bu)[:, :, None, :] \
            + i_off[None, None, :, None]                       # (t,S,bu,S)
        t = jnp.take(f_rows, ridx.reshape(plan.n_tiles, SB, plan.S),
                     axis=0, mode="clip")                      # (t,SB,S,bu)
        t = t.reshape(plan.n_tiles, SB, SB)
    n = plan.n_tiles * SB
    m = jnp.pad(mask_flat, (0, n - plan.n_p2)).reshape(plan.n_tiles, SB)
    t = t * m[:, :, None] * m[:, None, :]
    eye = jnp.eye(SB, dtype=t.dtype)
    t = t + (sigma * (1.0 - m))[:, :, None] * eye[None]
    # pad rows (beyond n_p2) have zero mask -> sigma on the diagonal: ok
    return t.astype(jnp.float32)


def block_jacobi_inverse(plan: BlockJacobiPlan, f_blk, mask_flat, sigma,
                         c_elem=None, tiles0=None):
    """Per-step exact tile inverse (batched LU) — the time loop uses
    block_jacobi_invert (Newton-Schulz from a static seed) instead; this
    exact form computes that seed."""
    t = block_jacobi_tiles(plan, f_blk, mask_flat, sigma,
                           c_elem=c_elem, tiles0=tiles0)
    out_dtype = f_blk.dtype if f_blk is not None else t.dtype
    return jnp.linalg.inv(t).astype(out_dtype)


def block_jacobi_invert(plan: BlockJacobiPlan, f_blk, mask_flat, sigma,
                        x0=None, iters: int = 3, c_elem=None, tiles0=None):
    """Per-step tile inverses: Newton-Schulz from a static seed, with an
    exact-LU fallback under a contraction guard.

    ``x0``: tile inverses of the STATIC part A0 (mass/dt + viscosity),
    computed once at setup.  F = A0 + C(u) differs by one convection
    increment, so X <- X (2I - A X) (batched matmuls) contracts the
    seed error quadratically; ``iters``=3 costs 2*iters 256^3 batched
    matmuls instead of a batched LU.  When the
    max tile row-sum norm of (I - A X0) >= 0.9 (convection-dominated
    tiles, e.g. CFL >> 1 impulsive starts), Newton may diverge — a
    lax.cond falls back to the exact LU for that step.  The result is a
    deterministic function of the step state (no cross-step carry), so
    checkpoint restarts stay bit-for-bit."""
    a = block_jacobi_tiles(plan, f_blk, mask_flat, sigma,
                           c_elem=c_elem, tiles0=tiles0)
    out_dtype = f_blk.dtype if f_blk is not None else a.dtype
    if x0 is None or iters <= 0:
        return jnp.linalg.inv(a).astype(out_dtype)
    x = x0.astype(jnp.float32)
    ax = jnp.matmul(a, x, preferred_element_type=jnp.float32)
    eye = jnp.eye(a.shape[-1], dtype=jnp.float32)
    r = jnp.abs(eye[None] - ax).sum(-1).max()

    def newton(_):
        xx, axx = x, ax
        for i in range(iters):
            xx = 2.0 * xx - jnp.matmul(xx, axx,
                                       preferred_element_type=jnp.float32)
            if i + 1 < iters:
                axx = jnp.matmul(a, xx,
                                 preferred_element_type=jnp.float32)
        return xx

    inv = jax.lax.cond(r < 0.9, newton,
                       lambda _: jnp.linalg.inv(a), None)
    return inv.astype(out_dtype)


def block_jacobi_apply(plan: BlockJacobiPlan, inv_tiles, r):
    """x = blockdiag(F_t)^-1 r  — batched dense matmul, gather-free."""
    n = plan.n_tiles * plan.S * plan.bu
    rb = jnp.pad(r, ((0, n - plan.n_p2), (0, 0))).reshape(
        plan.n_tiles, plan.S * plan.bu, -1)
    y = jnp.matmul(inv_tiles, rb.astype(inv_tiles.dtype))
    return y.reshape(n, -1)[:plan.n_p2].astype(r.dtype)


# ---------------------------------------------------------------------------
# scalar node-graph mass operator (keeps the big BSR static blocks off HBM)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NodeEll:
    """Scalar node-graph ELL matrix (one value per neighbor node)."""
    cols: jax.Array    # (n, K) int32
    vals: jax.Array    # (n, K)
    n: int = dataclasses.field(metadata=_static)


def build_mass_node_ell(space, cells_host, dtype) -> NodeEll:
    """Consistent P2 mass matrix as a scalar node ELL (~tens of MB at
    millions of DoFs vs GBs for the blocked form).  Used for the once-per-
    step M u^n application when the blocked static matrices are kept
    host-side (models/navier_stokes._build_static)."""
    import scipy.sparse as sp

    cp2 = np.asarray(space.cell_p2, np.int64)
    nc, nv = cp2.shape
    rows = np.repeat(cp2, nv, axis=1).ravel()
    cols = np.tile(cp2, (1, nv)).ravel()
    vals = np.asarray(cells_host.mass, np.float64).ravel()
    M = sp.csr_matrix((vals, (rows, cols)),
                      shape=(space.n_p2, space.n_p2))
    M.sum_duplicates()
    indptr, indices, data = M.indptr, M.indices, M.data
    counts = np.diff(indptr)
    K = int(counts.max())
    n = space.n_p2
    ctab = np.zeros((n, K), np.int64)
    vtab = np.zeros((n, K))
    for_rows = np.repeat(np.arange(n), counts)
    k_of = np.arange(len(indices)) - np.repeat(indptr[:-1], counts)
    ctab[for_rows, k_of] = indices
    vtab[for_rows, k_of] = data
    return NodeEll(cols=jnp.asarray(ctab.astype(np.int32)),
                   vals=jnp.asarray(vtab, dtype), n=n)


def node_mass_apply(m: NodeEll, u):
    """y[i, :] = sum_k vals[i, k] * u[cols[i, k], :]."""
    xg = jnp.take(u, m.cols, axis=0, mode="clip")       # (n, K, d)
    return (m.vals[:, :, None] * xg).sum(axis=1)
