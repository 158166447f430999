"""Incompressible Navier-Stokes solver — the flagship model.

JAX re-design of the reference's ``NavierStokes`` class
(src/NavierStokes.hpp:51-271, src/NavierStokes.cpp) with the same public
surface: ``setup``, ``set_re_number``, ``assemble``, ``solve_time_step``,
``solve(time_step=0)``, ``output``, ``export_data`` / ``import_data`` /
``post_process``, ``compute_forces``.

Numerics (parity with src/NavierStokes.cpp:133-330):
semi-implicit scheme — at each step solve the linear saddle-point system

    [ M/dt + nu K + C(u^n)   G ] [u^{n+1}]   [ M u^n / dt + f + neumann ]
    [ G^T                    0 ] [p^{n+1}] = [ 0                        ]

with Dirichlet velocity BCs eliminated by projection/lifting, solved by
flexible GMRES with the aSIMPLE (default) block preconditioner.

Execution model: ``output_step`` time steps run as ONE jitted
``lax.scan`` — assembly, Krylov solve, force integrals all on device, no
host round-trips inside the chunk (the reference crosses MPI/host
boundaries hundreds of times per step — SURVEY.md par.3.1).
"""

from __future__ import annotations

import dataclasses
import time as _walltime

import jax
import jax.numpy as jnp
import numpy as np

from navierstokes_tpu.config import InletConfig, SolverConfig
from navierstokes_tpu.fem.spaces import TaylorHoodSpace
from navierstokes_tpu.mesh.geometry import (Mesh, TAG_OBSTACLE, TAG_OUTLET,
                                            TAG_WALL_BOTTOM, TAG_WALL_TOP)
from navierstokes_tpu.mesh.msh_io import read_msh
from navierstokes_tpu.ops.assembly import (build_cell_arrays,
                                           build_face_arrays)
from navierstokes_tpu.ops.boundary import DirichletBC, build_dirichlet
from navierstokes_tpu.ops.forces import drag_lift, force_coefficients, \
    neumann_rhs
from navierstokes_tpu.ops.operators import build_scatter, convection_matrices
from navierstokes_tpu.parallel.sharded_ops import (ShardedOps,
                                                   SingleDeviceOps,
                                                   shard_problem)
from navierstokes_tpu.parallel.sharding import device_mesh
from navierstokes_tpu.solvers.krylov import fgmres
from navierstokes_tpu.solvers.preconditioners import (InnerSolve,
                                                      make_asimple,
                                                      make_ayosida,
                                                      make_identity)
from navierstokes_tpu.utils.checkpoint import export_state, import_state
from navierstokes_tpu.utils.csv_logger import ForcesCsv
from navierstokes_tpu.utils.runtime import at_matmul_precision
from navierstokes_tpu.utils.vtu import write_vtu_pvtu


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StepMetrics:
    """Per-step scalars, matching the csv schema minus host timings."""
    time: jax.Array
    iterations: jax.Array
    residual: jax.Array
    drag: jax.Array
    lift: jax.Array
    cd: jax.Array
    cl: jax.Array
    converged: jax.Array    # every Krylov solve of the step met its tol


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StepParams:
    """All device-resident step inputs, passed as jit ARGUMENTS (not trace
    constants) so compiled programs are value-independent: the persistent
    compilation cache then serves every scenario on a same-shaped mesh."""
    cells: object           # CellArrays
    a0_cell: jax.Array      # (nc, n_v, n_v) static part M/dt + nu K
    t_hat: jax.Array
    bc: DirichletBC
    rhs_neumann: jax.Array
    dt_mlump_inv: jax.Array
    nu: jax.Array           # scalar
    u_mean0: jax.Array      # steady mean inlet velocity (scalar)
    scat_v: object          # Scatter (velocity nodes)
    scat_p: object          # Scatter (pressure nodes)
    faces_obst: object      # FaceArrays | None (obstacle, tag 4)
    # Cahouet-Chabard data (None unless operator='bsr' and precond='cc'):
    ap_w: object            # (n_p2,) static masked 1/lumped-mass weights
    ap_schur_pin: object    # (n_p1,) 0/1: 0 at outlet-pinned AND
                            # transmission-crippled boundary pressure nodes;
                            # only populated for proj_poisson='schur'
                            # (see _build_cc_statics)
    ap: object              # EllBlocked: host-assembled Ap = B diag(w) B^T
    ap_sc_inv: object       # coarse inverse of Ap (static)
    ap_lam: object          # lambda_max estimate for Ap smoothing
    mp_lumped: object       # (n_p1,) lumped pressure mass
    bj_plan: object         # BlockJacobiPlan | None (F tile preconditioner)
    bj_x0: object           # static tile inverses of A0 (Newton seed)|None
    bj_tiles0: object       # static tile values (scatter formulation)|None
    # projection-scheme Poisson operator (phi = 0 pinned on the outlet):
    ap_dir: object          # EllBlocked | None
    ap_dir_sc_inv: object
    ap_dir_lam: object
    ap_dir_pin: object      # (n_p1,) 0/1 mask, 0 at pinned outlet nodes
    # forcing-term quadrature data (None unless a forcing fn is set):
    forcing_xq: object      # (nc, n_q, dim) physical quadrature points
    forcing_w: object       # (nc, n_q, n_a) qw*phi_a*detJ scatter weights
    mass_ell: object        # NodeEll | None: compact M for M u^n (bsr)


class NavierStokes:
    """Constructor mirrors the reference's
    (mesh, degree_velocity, degree_pressure, deltat, T, step —
    src/NavierStokes.hpp:173-189); everything else via SolverConfig /
    InletConfig."""

    def __init__(self, mesh, degree_velocity: int = 2,
                 degree_pressure: int = 1, deltat: float = 0.01,
                 T: float = 1.0, step: int = 10,
                 inlet: InletConfig | None = None,
                 config: SolverConfig | None = None,
                 forcing=None):
        self.config = config or SolverConfig()
        self.config.deltat = deltat
        self.config.t_final = T
        self.config.output_step = step
        self.inlet = inlet or InletConfig()
        # ForcingTerm hook (src/NavierStokes.hpp:56-65, integrand
        # cpp:240-243; identically zero in the reference): a jax-traceable
        # ``f(x (m, dim), t) -> (m, dim)`` evaluated at quadrature points
        # inside the jitted step.
        self.forcing = forcing
        self.degree_velocity = degree_velocity
        self.degree_pressure = degree_pressure
        self._mesh_source = mesh
        self.nu = self.config.nu
        self.mesh: Mesh | None = None
        self.space: TaylorHoodSpace | None = None
        self.time = 0.0
        self.drag = self.lift = self.cd = self.cl = 0.0
        self._is_setup = False

    # ------------------------------------------------------------------
    # setup & physics parameters
    # ------------------------------------------------------------------

    def set_re_number(self, Re: float):
        """nu = U_mean * ref_length / Re (parity:
        src/NavierStokes.cpp:332-341, Diameter=0.4 default)."""
        U = self.inlet.steady_mean_velocity()
        self.nu = (U * self.config.ref_length) / Re
        print(f"Reynolds number set to {Re} with nu = {self.nu}")
        if self._is_setup:
            self._build_static()  # refresh nu-dependent operators

    @at_matmul_precision
    def setup(self):
        cfg = self.config
        self.dtype = jnp.dtype(cfg.dtype)
        if isinstance(self._mesh_source, Mesh):
            self.mesh = self._mesh_source
        else:
            self.mesh = read_msh(str(self._mesh_source))
        # bandwidth-reducing node order keeps blocked operators compact
        self.mesh.reorder_spatial()
        self.space = TaylorHoodSpace(self.mesh, self.degree_velocity,
                                     self.degree_pressure)
        sp = self.space
        self.dim = sp.dim
        print(sp.mesh.summary())
        print(f"DoFs: velocity {sp.n_velocity_dofs} + pressure "
              f"{sp.n_pressure_dofs} = {sp.n_dofs}")

        # Curved (superparametric) boundary cells: snap P2 midside nodes
        # onto the analytic obstacle surface when the mesh provides
        # projectors.  This is the geometric-fidelity step the reference
        # gets from gmsh resolving the circle at local h
        # (mesh/domain2D.geo:10) — see fem/spaces.snap_boundaries.
        proj = getattr(self.mesh, "snap_projectors", None)
        if (cfg.curved_boundary and proj
                and self.degree_velocity == 2):  # snapping is P2 geometry
            snapped = sp.snap_boundaries(proj)
            if snapped:
                k = len(sp.curved_data().ids)
                print(f"curved boundary: tags {snapped} snapped "
                      f"({k} superparametric cells)")

        from navierstokes_tpu.ops.assembly import cell_arrays_numpy
        cells_host = cell_arrays_numpy(sp)
        self._cells_host = cells_host
        self.cells = build_cell_arrays(sp, dtype=self.dtype, host=cells_host)
        self.t_hat = jnp.asarray(sp.rs.T_hat, dtype=self.dtype)
        self.bc: DirichletBC = build_dirichlet(sp, self.inlet,
                                               dtype=self.dtype)

        # abs-lumped mass per node (host precompute; reference cpp:232-236)
        rows = np.einsum("c,a->ca", cells_host.detj, sp.rs.Mlump_hat)
        cd = sp.curved_data()
        if cd is not None:
            # curved cells: per-point |phi| accumulation with detJ(xi)
            wdet = cd.qw[None, :] * cd.detj_q
            absrow = np.abs(cd.phi_v) * np.abs(cd.phi_v).sum(
                axis=1, keepdims=True)                    # (n_cq, n_v)
            rows[cd.ids] = np.einsum("kq,qa->ka", wdet, absrow)
        lm = np.zeros(sp.n_p2)
        np.add.at(lm, np.asarray(sp.cell_p2).reshape(-1), rows.reshape(-1))
        self._lumped_host = lm

        # distribution: shard the operator over the device mesh when
        # requested.  The production (BSR) path is GSPMD-sharded: block
        # rows partitioned, DoF vectors replicated, XLA inserts the
        # collectives.  The legacy cells path keeps its explicit
        # shard_map formulation.
        n_dev = cfg.n_devices if cfg.n_devices > 0 else 1
        self.scat_v = self.scat_p = None
        if (cfg.operator == "bsr"
                and (self.degree_velocity, self.degree_pressure) != (2, 1)):
            # the BSR fast path's block machinery (graph build, Schur
            # V-cycle, block-Jacobi tiles) is tuned for the production
            # P2/P1 pair; arbitrary degree pairs run on the generic
            # element (cells) operator — same math, degree-generic
            print(f"operator 'bsr' is P2/P1-optimized; degrees "
                  f"({self.degree_velocity},{self.degree_pressure}) use "
                  "the generic 'cells' operator")
            cfg.operator = "cells"
        if n_dev > 1 and cfg.operator != "bsr":
            self.shard_mesh = device_mesh(n_dev)
            self._operator = "cells"
            self.cells, self.scat_v, self.scat_p, _ = shard_problem(
                self.cells, sp, self.shard_mesh, self.dtype)
            self._ops = ShardedOps(self.shard_mesh)
        elif cfg.operator == "bsr":
            from navierstokes_tpu.ops.bsr import BsrOps, build_bsr
            from navierstokes_tpu.solvers.schur import build_coarse_plan
            self.shard_mesh = device_mesh(n_dev) if n_dev > 1 else None
            self._operator = "bsr"
            blk = cfg.bsr_block or None
            # 128-row multiple keeps the block-row count aligned; lcm with
            # the device count keeps GSPMD device_put sharding even
            ROW_MULT = 128
            # static_device=False: M/K blocks stay host-side; only the
            # combined A0 is uploaded (_build_static) and the per-step
            # M u^n uses the compact node-ELL mass — halves the resident
            # F-family HBM (decisive for 3D fit)
            gb_kmax = cfg.bsr_gb_kmax
            if gb_kmax == -2:      # auto: split G/B under projection only
                # (the monolithic CC coarse assembly contracts G block
                # PAIRS within whole rows, solvers/schur.coarse_matrix)
                gb_kmax = -1 if cfg.scheme == "projection" else 0
            self.ell = build_bsr(sp, cells_host, dtype=self.dtype,
                                 bu=blk, bp=blk,
                                 row_multiple=int(np.lcm(ROW_MULT, n_dev)),
                                 static_device=False,
                                 f_kmax=cfg.bsr_f_kmax, gb_kmax=gb_kmax)
            # Once-per-step consistent-mass product: the node-ELL form is
            # compact but gathers (1,dim)-rows; the blocked form reuses the
            # F graph.  Blocked costs one extra F-sized buffer, so it is the
            # 2D default only; 3D keeps the compact form (memory fit).
            mfmt = cfg.mass_format
            if mfmt == "auto":
                mfmt = "blocked" if self.dim == 2 else "node"
            if mfmt == "blocked":
                e = self.ell
                host_attrs = {k: getattr(e, k) for k in dir(e)
                              if k.startswith("host_")}
                # cast on host: halves the upload
                m_host = np.asarray(e.host_m_blk, np.dtype(self.dtype))
                self.ell = dataclasses.replace(
                    e, m_blk=jnp.asarray(m_host, self.dtype))
                for k, v in host_attrs.items():   # plain (non-pytree) attrs
                    setattr(self.ell, k, v)
                self._mass_ell = None
            else:
                from navierstokes_tpu.ops.p1ell import build_mass_node_ell
                self._mass_ell = build_mass_node_ell(sp, cells_host,
                                                     self.dtype)
            self._ops = BsrOps(fused_f=self.shard_mesh is None)
            self._coarse_plan = build_coarse_plan(
                self.ell,
                cfg.schur_agg_blocks or max(1, 64 // self.ell.bp))
            self._build_cc_statics()
            if self.shard_mesh is not None:
                self._apply_gspmd_sharding()
        elif cfg.operator == "ell":
            from navierstokes_tpu.ops.ell import EllOps, build_ell
            self.shard_mesh = None
            self._operator = "ell"
            self.ell = build_ell(sp, cells_host, dtype=self.dtype)
            self._ops = EllOps()
        else:
            self.shard_mesh = None
            self._operator = "cells"
            self.scat_v = build_scatter(sp.cell_p2, sp.n_p2)
            self.scat_p = build_scatter(sp.cell_p1, sp.n_p1)
            self._ops = SingleDeviceOps()

        # boundary-face data
        tags = set(self.mesh.boundary_tags.tolist())
        self.faces_out = (build_face_arrays(sp, TAG_OUTLET, self.dtype)
                          if TAG_OUTLET in tags else None)
        self.faces_obst = (build_face_arrays(sp, TAG_OBSTACLE, self.dtype)
                           if TAG_OBSTACLE in tags else None)

        # forcing-term quadrature data: physical quad points + scatter
        # weights, precomputed once so the per-step forcing integral
        # (cpp:240-243) is a fused multiply + segment_sum inside the jit
        self._forcing_xq = self._forcing_w = self._forcing_scat = None
        if self.forcing is not None:
            from navierstokes_tpu.ops.assembly import geometric_factors
            detj, _ = geometric_factors(sp)
            verts = sp.mesh.points[sp.mesh.cells]       # (nc, dim+1, dim)
            qp = sp.rs.qp
            lam0 = 1.0 - qp.sum(axis=1)
            bary = np.concatenate([lam0[:, None], qp], axis=1)
            xq = np.einsum("qk,ckd->cqd", bary, verts)  # (nc, n_q, dim)
            wq = np.einsum("q,qa,c->cqa", sp.rs.qw, sp.rs.phi_v, detj)
            self._forcing_xq = jnp.asarray(xq, self.dtype)
            self._forcing_w = jnp.asarray(wq, self.dtype)
            self._forcing_scat = build_scatter(sp.cell_p2, sp.n_p2)

        # constant Neumann RHS (p_out, cpp:257-278); zero when p_out == 0
        if self.faces_out is not None and cfg.p_out != 0.0:
            scat = build_scatter(
                np.asarray(self.faces_out.vel_nodes), sp.n_p2)
            self.rhs_neumann = neumann_rhs(self.faces_out, cfg.p_out, scat)
        else:
            self.rhs_neumann = jnp.zeros((sp.n_p2, self.dim), self.dtype)

        self._build_static()
        self._chunks = {}
        self._is_setup = True

        # Advective-CFL instrumentation.  The BDF2 projection variant is
        # documented unstable at CFL >~ 2 (config.py proj_bdf2 notes).  The
        # authoritative number is the MEASURED CFL max_c max_{nodes of c}
        # |u| * dt / h_c computed from the live velocity field each chunk
        # (solve() prints it and warns on sustained excess); the static
        # estimate below is only a pre-run screen for grossly unstable
        # configurations.
        vols = np.abs(self.mesh.cell_volumes())
        h_c = (vols * (2.0 if self.dim == 2 else 6.0)) ** (1.0 / self.dim)
        self._cfl_dt_over_h = jnp.asarray(cfg.deltat / h_c, self.dtype)
        self._measured_cfl_fn = None
        self._cfl_warned = False
        if cfg.scheme == "projection" and cfg.proj_bdf2:
            cfl = self._static_cfl_estimate(h_c)
            if cfl > 2.0:
                print(f"WARNING: estimated advective CFL ~{cfl:.1f} > 2 "
                      f"(dt={cfg.deltat}); the BDF2 projection is unstable "
                      "in this regime — reduce deltat or set "
                      "proj_bdf2=False / scheme='monolithic'")
        return self

    def _static_cfl_estimate(self, h_c: np.ndarray) -> float:
        """Pre-run advective-CFL screen with a wall-aware velocity scale.

        The round-4 screen paired the GLOBAL h_min with the PEAK inlet
        velocity — a false positive on production meshes, whose smallest
        cells sit on no-slip boundaries where the advective velocity is
        set by the local wall strain rate, not the inlet peak (e.g. the
        1M-DoF bench mesh: h_min ~ 6.6e-4 on the cylinder surface, where
        the measured near-wall speed is ~0.1, not 1.5).  Here each cell's
        velocity scale is the inlet peak capped by a linear laminar
        boundary-layer profile u ~ u_m * d_wall / delta with
        delta = L_ref / sqrt(Re) (laminar flat-plate/cylinder scaling);
        d_wall is the centroid distance to the nearest no-slip boundary
        node.  The true per-step CFL is measured from the live field in
        solve() — this screen exists only to refuse configurations that
        are unstable even in the free stream (the regime the reference
        avoids by treating convection implicitly,
        src/NavierStokes.cpp:204-208)."""
        mesh = self.mesh
        u_peak = max(abs(self.inlet.u_m), 1e-30)
        u_cell = np.full(h_c.shape, u_peak)
        noslip = np.isin(mesh.boundary_tags,
                         (TAG_WALL_BOTTOM, TAG_WALL_TOP, TAG_OBSTACLE))
        if noslip.any():
            try:
                from scipy.spatial import cKDTree
                wall_pts = mesh.points[np.unique(
                    mesh.boundary_faces[noslip].ravel())]
                cent = mesh.points[mesh.cells].mean(axis=1)
                d = cKDTree(wall_pts).query(cent, k=1)[0]
                u_mean = max(self.inlet.steady_mean_velocity(), 1e-30)
                re = max(u_mean * self.config.ref_length / self.nu, 1.0)
                delta = max(self.config.ref_length / np.sqrt(re), 1e-12)
                u_cell = u_peak * np.minimum(1.0, d / delta)
            except Exception:
                pass  # screen only; the measured CFL is authoritative
        return float(np.max(u_cell * self.config.deltat / h_c))

    def measured_cfl(self, u=None) -> float:
        """Advective CFL of the (given or current) velocity field:
        max over cells of (max nodal speed in the cell) * dt / h_cell,
        h_cell the equilateral-equivalent size.  This is the per-step
        stability number the reference never needs (implicit convection,
        src/NavierStokes.cpp:204-208) but the extrapolated-convection
        projection scheme must respect."""
        if self._measured_cfl_fn is None:
            cell_p2 = jnp.asarray(self.space.cell_p2)
            dt_over_h = self._cfl_dt_over_h

            @jax.jit
            def f(u):
                speed = jnp.sqrt((u * u).sum(axis=-1))
                return (speed[cell_p2].max(axis=1) * dt_over_h).max()

            self._measured_cfl_fn = f
        return float(self._measured_cfl_fn(self._u if u is None else u))

    def _apply_gspmd_sharding(self):
        """Distribute the BSR fast path over the device mesh — the
        equivalent of the reference's MPI domain decomposition
        (src/NavierStokes.cpp:19-23, 292-294), GSPMD style: the operator's
        block rows (and the per-cell convection inputs) are sharded over
        the 1-D mesh axis; DoF vectors stay replicated (a few MB at the
        target scales); XLA's SPMD partitioner inserts the collectives
        (all-gather of row-sharded matvec outputs, reductions for the
        per-step assembly scatter) — no hand-written communication."""
        from jax.sharding import NamedSharding, PartitionSpec as P
        row = NamedSharding(self.shard_mesh, P("cells"))
        put = lambda a: jax.device_put(a, row)
        put_tree = lambda t: jax.tree.map(put, t)

        e = self.ell
        host_attrs = {k: getattr(e, k) for k in
                      ("host_f_cols", "host_ovf_rows", "host_g_cols",
                       "host_m_blk", "host_k_blk") if hasattr(e, k)}
        self.ell = dataclasses.replace(
            e,
            # per-cell convection inputs + slot scatter
            cell_p2=put(e.cell_p2), cell_p1=put(e.cell_p1),
            detj=put(e.detj), jinv=put(e.jinv),
            con_row=put(e.con_row), con_cpos=put(e.con_cpos),
            con_seg=put(e.con_seg),
            pp_slot_scatter=put_tree(e.pp_slot_scatter),
            # block graphs + static values, sharded by block row
            f_cols=put(e.f_cols),
            ovf_rows=put(e.ovf_rows) if e.ovf_rows is not None else None,
            m_blk=put(e.m_blk) if e.m_blk is not None else None,
            k_blk=put(e.k_blk) if e.k_blk is not None else None,
            g_cols=put(e.g_cols), g_blk=put(e.g_blk),
            b_cols=put(e.b_cols), b_blk=put(e.b_blk),
            g_spill=put(e.g_spill) if e.g_spill is not None else None,
            b_spill=put(e.b_spill) if e.b_spill is not None else None,
            pp_cols=put(e.pp_cols),
        )
        for k, v in host_attrs.items():
            setattr(self.ell, k, v)
        # The pressure-side statics (assembled Ap, coarse inverse, BJ tile
        # plan, diag_idx) are a few MB at the target scales — left
        # replicated; XLA partitions their per-step consumers as it sees
        # fit.  Sharding them would need their own row padding for no
        # measurable memory win.

    def _build_cc_statics(self):
        """Static Cahouet-Chabard data: the masked pressure operator
        Ap = B diag(mask/M_lumped) B^T is ASSEMBLED on the host into a
        compact P1 blocked ELL (~5 MB at 1M DoF) — round 1 applied it
        matrix-free through the G/B block values (~1.3 GB of HBM traffic
        per application).  Coarse matrix + inverse also host-built."""
        from navierstokes_tpu.ops.p1ell import (assemble_ap,
                                                build_block_jacobi_plan,
                                                coarse_from_ell, ell_matvec)
        from navierstokes_tpu.solvers.schur import estimate_lam_max
        sp = self.space
        # host mask copy: no pull of the device array back to the host
        mask_flat = getattr(self.bc, "host_mask",
                            np.asarray(self.bc.mask))[:, 0]
        w = jnp.asarray(mask_flat / self._lumped_host, self.dtype)
        self._ap_w = w
        self._ap = assemble_ap(sp, self._cells_host,
                               mask_flat / self._lumped_host, self.dtype,
                               b=self.ell.bp)
        agg = self.config.schur_agg_blocks or max(1, 64 // self.ell.bp)
        sc = coarse_from_ell(self._ap, agg)
        n = sc.shape[0]
        scale = np.abs(np.diag(sc)).mean() + 1e-30
        self._ap_sc_inv = jnp.asarray(
            np.linalg.inv(sc + 1e-8 * scale * np.eye(n)), self.dtype)
        d = self._ap.diag
        sdinv = jnp.where(d != 0, 1.0 / d, 1.0)
        # the operator flows through op= (a jit ARG): a closure would
        # inline it into the program as HLO constants
        self._ap_lam = estimate_lam_max(
            ell_matvec, sdinv, sp.n_p1, self.dtype, op=self._ap)
        # only when the F preconditioner actually uses the tiles: the plan,
        # the static tile base and the per-step Newton-Schulz rebuild are
        # the largest preconditioner buffers of the step
        self._bj_plan = (build_block_jacobi_plan(
            self.ell, S=self.config.bj_tile_blocks
            or max(1, 256 // self.ell.bu),
            layout=self.config.bj_tiles,
            cell_p2_host=np.asarray(sp.cell_p2))
            if self.config.f_precond == "bj" else None)
        # Projection-scheme Poisson operator: the CONSISTENT P1 stiffness
        # Laplacian (IPCS-style), phi pinned to 0 on the outlet P1 nodes
        # when an outflow exists.  NOT the compatible B W B^T: that choice
        # excites an exponentially growing outflow mode (measured on the
        # cylinder channel; see ops/p1ell.assemble_p1_stiffness).
        from navierstokes_tpu.ops.p1ell import assemble_p1_stiffness
        out_sel = self.mesh.boundary_tags == TAG_OUTLET
        out_nodes = (np.unique(self.mesh.boundary_faces[out_sel])
                     if np.any(out_sel) else None)
        self._ap_dir_pinned = out_nodes is not None
        # 0/1 mask matching the eliminated rows/cols of assemble_p1_stiffness
        # (rows/cols zeroed, diag=scale): the Poisson RHS must be zeroed at
        # the pinned nodes too, or the solve yields phi_outlet =
        # (B u*)/(dt_eff*scale) != 0 which feeds the velocity correction and
        # accumulates into p every step.
        pin = np.ones(sp.n_p1)
        if self._ap_dir_pinned:
            pin[out_nodes] = 0.0
        self._ap_dir_pin = jnp.asarray(pin, self.dtype)
        if self.config.proj_poisson == "schur":
            # Exact discrete projection (proj_poisson='schur') pin set.
            # S = B diag(mask/M_L) B^T loses most of its row weight at
            # pressure nodes whose velocity stencil is largely Dirichlet
            # (inlet/wall/obstacle nodes): demanding EXACT zero divergence
            # there forces O(100x) phi spikes through the few free
            # velocity DoFs and the coupled stepping grows a boundary
            # pressure mode exponentially (measured: NaN by step ~13 on
            # the h=0.08 cylinder channel, either BDF order).  Pin phi=0
            # at every node whose masked S diagonal keeps < 50% of its
            # unmasked weight — divergence there is left to the BC
            # re-imposition, exactly as the Laplacian variant leaves its
            # boundary layer — and keep the exact projection at every
            # remaining node.
            from navierstokes_tpu.ops import bsr as _B
            d_m = np.asarray(_B.schur_diag(self.ell, w))
            d_r = np.asarray(_B.schur_diag(
                self.ell, jnp.asarray(1.0 / self._lumped_host,
                                      self.dtype)))
            crippled = d_m < self.config.proj_schur_pin_ratio * d_r
            pin_s = pin * (~crippled)
            self._ap_schur_pin = jnp.asarray(pin_s, self.dtype)
        self._ap_dir = assemble_p1_stiffness(sp, self._cells_host,
                                             self.dtype, b=self.ell.bp,
                                             dirichlet_nodes=out_nodes)
        scd = coarse_from_ell(
            self._ap_dir,
            self.config.schur_agg_blocks or max(1, 64 // self.ell.bp))
        nd = scd.shape[0]
        sd_scale = np.abs(np.diag(scd)).mean() + 1e-30
        self._ap_dir_sc_inv = jnp.asarray(
            np.linalg.inv(scd + 1e-8 * sd_scale * np.eye(nd)), self.dtype)
        dd = self._ap_dir.diag
        sdinv_d = jnp.where(dd != 0, 1.0 / dd, 1.0)
        self._ap_dir_lam = estimate_lam_max(
            ell_matvec, sdinv_d, sp.n_p1, self.dtype, op=self._ap_dir)
        # lumped pressure mass: row sums of Mp = detJ * measure/(dim+1)
        from navierstokes_tpu.ops.assembly import geometric_factors
        detj, _ = geometric_factors(sp)
        coeff = (0.5 / 3.0) if self.dim == 2 else (1.0 / 6.0 / 4.0)
        mp_rows = np.repeat((detj * coeff)[:, None], sp.cell_p1.shape[1],
                            axis=1)
        cd = sp.curved_data()
        if cd is not None:
            # curved rows: int psi_i dx = sum_q w_q psi_i detJ(xi_q)
            wdet = cd.qw[None, :] * cd.detj_q
            mp_rows[cd.ids] = np.einsum("kq,qj->kj", wdet, cd.phi_p)
        mp = np.zeros(sp.n_p1)
        np.add.at(mp, np.asarray(sp.cell_p1).reshape(-1), mp_rows.reshape(-1))
        self._mp_lumped = jnp.asarray(mp, self.dtype)

    def _build_static(self):
        """nu/dt-dependent static operator A0 = c_t M/dt + nu K (element
        or graph format) and the dt/lumped-mass vector (for aYosida).
        c_t = 3/2 for the BDF2 projection scheme (folded here so the step
        does not materialize an extra full-size operator temp — decisive
        for 3D HBM fit)."""
        cfg = self.config
        self._bj_x0 = None      # Newton seed follows A0 (_bj_seed)
        self._bj_t0 = None      # static tile base follows A0 (scatter)
        dt = cfg.deltat
        ct = (1.5 if cfg.scheme == "projection" and cfg.proj_bdf2
              else 1.0)
        op = getattr(self, "_operator", "cells")
        if op == "ell":
            self.a0_cell = (ct / dt) * self.ell.m_vals \
                + self.nu * self.ell.k_vals
        elif op == "bsr":
            if self.ell.m_blk is not None and self.ell.k_blk is not None:
                self.a0_cell = (ct / dt) * self.ell.m_blk \
                    + self.nu * self.ell.k_blk
            else:
                # host combine + single upload (static blocks not resident)
                self.a0_cell = jnp.asarray(
                    (ct / dt) * self.ell.host_m_blk
                    + self.nu * self.ell.host_k_blk, self.dtype)
        else:
            self.a0_cell = (ct / dt) * self.cells.mass \
                + self.nu * self.cells.stiff
        self.dt_mlump_inv = jnp.asarray(
            (dt / self._lumped_host)[:, None], self.dtype)
        self._chunks = {}  # operators changed -> invalidate compiled chunks

    # ------------------------------------------------------------------
    # single time step (pure function of state, jit/scan-able)
    # ------------------------------------------------------------------

    def _time_factor(self, t):
        f = (jnp.sin(jnp.pi * t / self.inlet.period)
             if self.inlet.pulsating else jnp.asarray(1.0, self.dtype))
        r = self.inlet.ramp
        if r:
            f = f * jnp.where(t >= r, jnp.asarray(1.0, self.dtype),
                              0.5 - 0.5 * jnp.cos(jnp.pi * t / r))
        return f.astype(self.dtype)

    def _bj_tiles0_dev(self):
        """Static tile base for the "scatter" block-Jacobi formulation:
        the (n_tiles, SB, SB) diagonals of A0 = c_t M/dt + nu K, gathered
        ONCE on the host (ops/p1ell.static_tiles_host) — the per-step
        device work is then only the convection segment-sum."""
        plan = getattr(self, "_bj_plan", None)
        if plan is None or plan.layout != "scatter":
            return None
        if getattr(self, "_bj_t0", None) is None:
            from navierstokes_tpu.ops.p1ell import static_tiles_host
            cfg = self.config
            ct = (1.5 if cfg.scheme == "projection" and cfg.proj_bdf2
                  else 1.0)
            a0 = (ct / cfg.deltat) * self.ell.host_m_blk \
                + self.nu * self.ell.host_k_blk
            Cw = self.ell.f_cols.shape[1] * self.ell.bu
            self._bj_t0 = jnp.asarray(
                static_tiles_host(plan, plan.host_idx, a0, Cw), jnp.float32)
        return self._bj_t0

    @at_matmul_precision
    def _bj_seed(self):
        """Static Newton seed for the per-step block-Jacobi tile
        inversion: exact inverses of the BC-masked STATIC operator A0
        (mass/dt + viscosity), computed once per setup (ops/p1ell.py
        block_jacobi_invert).  A pure function of static data, so
        checkpoint restarts reproduce the continuous run bit-for-bit."""
        cfg = self.config
        if (cfg.bj_newton <= 0 or cfg.f_precond != "bj"
                or getattr(self, "_bj_plan", None) is None
                or self._operator != "bsr"):
            return None
        if getattr(self, "_bj_x0", None) is None:
            from navierstokes_tpu.ops.bsr import f_diag as bsr_f_diag
            from navierstokes_tpu.ops.p1ell import block_jacobi_inverse
            mflat = self.bc.mask[:, 0]
            d = bsr_f_diag(self.ell, self.a0_cell)
            sigma0 = jnp.sum(d * mflat) / jnp.maximum(jnp.sum(mflat), 1.0)
            if self._bj_plan.layout == "scatter":
                t0 = self._bj_tiles0_dev()
                self._bj_x0 = jax.jit(
                    lambda plan, m, s, t0: block_jacobi_inverse(
                        plan, None, m, s, tiles0=t0))(
                    self._bj_plan, mflat, sigma0, t0)
            else:
                self._bj_x0 = jax.jit(
                    lambda plan, f, m, s: block_jacobi_inverse(
                        plan, f, m, s))(self._bj_plan, self.a0_cell, mflat,
                                        sigma0)
        return self._bj_x0

    def _params(self) -> StepParams:
        opdata = self.ell if self._operator in ("ell", "bsr") else self.cells
        return StepParams(cells=opdata, a0_cell=self.a0_cell,
                          t_hat=self.t_hat, bc=self.bc,
                          rhs_neumann=self.rhs_neumann,
                          dt_mlump_inv=self.dt_mlump_inv,
                          nu=jnp.asarray(self.nu, self.dtype),
                          u_mean0=jnp.asarray(
                              self.inlet.steady_mean_velocity(), self.dtype),
                          scat_v=self.scat_v, scat_p=self.scat_p,
                          faces_obst=self.faces_obst,
                          ap_w=getattr(self, "_ap_w", None),
                          ap_schur_pin=getattr(self, "_ap_schur_pin", None),
                          ap=getattr(self, "_ap", None),
                          ap_sc_inv=getattr(self, "_ap_sc_inv", None),
                          ap_lam=getattr(self, "_ap_lam", None),
                          mp_lumped=getattr(self, "_mp_lumped", None),
                          bj_plan=getattr(self, "_bj_plan", None),
                          bj_x0=self._bj_seed(),
                          bj_tiles0=self._bj_tiles0_dev(),
                          ap_dir=getattr(self, "_ap_dir", None),
                          ap_dir_sc_inv=getattr(self, "_ap_dir_sc_inv",
                                                None),
                          ap_dir_lam=getattr(self, "_ap_dir_lam", None),
                          ap_dir_pin=getattr(self, "_ap_dir_pin", None),
                          forcing_xq=getattr(self, "_forcing_xq", None),
                          forcing_w=getattr(self, "_forcing_w", None),
                          mass_ell=getattr(self, "_mass_ell", None))

    def _step_projection(self, params: StepParams, u, p, t_prev,
                         u_prev=None, phi_prev=None):
        """Rotational incremental pressure-correction step — the
        production scheme (config.scheme='projection').

        Same spatial discretization, semi-implicit convection
        linearization (reference T1 form, cpp:204-208) and Dirichlet
        handling as the monolithic path, but the saddle-point solve is
        split [Guermond, Minev & Shen 2006] (BDF1 form; proj_bdf2=True
        upgrades to BDF2 with C(2u^n - u^{n-1}) and dt_eff = 2 dt/3):

            (M/dt + nu K + C(u^n)) u* = M u^n/dt + f - G p^n   [+ BCs]
            Lp phi = B u* / dt_eff      (consistent P1 Laplacian)
            u^{n+1} = u* - dt_eff W G phi   (W = diag(mask/M_l))
            p^{n+1} = p^n + phi + nu * Mp^{-1} (B u*)   [rotational]

        One BC-masked F BiCGStab solve + one V-cycle-preconditioned CG
        Poisson solve per step instead of 30-80 outer FGMRES iterations
        on the coupled system.  The velocity correction uses the SAME
        masked weights as Ap, so Dirichlet values are preserved exactly
        and div-freedom holds to the Poisson-solve tolerance."""
        from navierstokes_tpu.ops.p1ell import (block_jacobi_apply,
                                                block_jacobi_invert,
                                                ell_matvec)
        from navierstokes_tpu.solvers.krylov import bicgstab, cg
        from navierstokes_tpu.solvers.schur import make_vcycle_solver
        cfg = self.config
        ops = self._ops
        bc = params.bc
        mask = bc.mask
        dt = cfg.deltat
        t_new = t_prev + dt

        # BDF2 + extrapolated convection (proj_bdf2): F gets 3M/(2 dt),
        # convection is linearized at 2u^n - u^{n-1} (2nd order), and the
        # projection uses the effective step dt/alpha.  u_prev == u on the
        # very first step degrades gracefully to a consistent start-up.
        up = u if u_prev is None else u_prev
        if cfg.proj_bdf2:
            # a0_cell already carries the 3/2 BDF2 mass coefficient
            # (_build_static) — no extra full-size operator temp here
            alpha = 1.5
            u_adv = 2.0 * u - up
            u_t = (4.0 * u - up) / (2.0 * dt)    # M-weighted history term
        else:
            alpha = 1.0
            u_adv = u
            u_t = u / dt
        conv = ops.convection(params, u_adv)
        f_cell = params.a0_cell + conv
        dt_eff = dt / alpha
        d = ops.f_diag(params, f_cell)
        mflat = mask[:, 0]
        sigma = jnp.sum(d * mflat) / jnp.maximum(jnp.sum(mflat), 1.0)
        dinv = (1.0 / (d * mflat + sigma * (1.0 - mflat)))[:, None]
        zero_p = jnp.zeros(self.space.n_p1, self.dtype)

        # bf16 value reads inside the u* solve (vectors + accumulation stay
        # fp32); the attainable residual stays well below proj_tol
        use_bf16 = (cfg.inner_bf16 and self.dtype == jnp.dtype(jnp.float32))
        f_inner = f_cell.astype(jnp.bfloat16) if use_bf16 else f_cell

        def apply_F(xu):
            xum = xu * mask
            yu, _ = ops.apply_blocks(params, f_inner, xum, zero_p,
                                     with_g=False, with_gt=False)
            return (yu * mask + sigma * (xu - xum)).astype(self.dtype)

        def apply_Bt_raw(xp):
            yu, _ = ops.apply_blocks(params, f_cell, jnp.zeros_like(u), xp,
                                     with_f=False, with_gt=False)
            return yu

        def apply_B_raw(xu):
            _, yp = ops.apply_blocks(params, f_cell, xu, zero_p,
                                     with_f=False, with_g=False)
            return yp

        if cfg.f_precond == "bj" and params.bj_plan is not None:
            bj_kw = {}
            if params.bj_plan.layout == "scatter":
                # tile values re-assembled from the per-cell convection
                # matrices (XLA CSE merges this with ops.convection's
                # identical element-matrix computation)
                from navierstokes_tpu.ops.operators import \
                    convection_matrices
                bj_kw = dict(c_elem=convection_matrices(
                    params.cells, params.cells.t_hat, u_adv),
                    tiles0=params.bj_tiles0)
            inv_tiles = block_jacobi_invert(
                params.bj_plan, f_cell, mflat, sigma,
                x0=params.bj_x0, iters=cfg.bj_newton, **bj_kw)
            if use_bf16 or (cfg.bj_bf16
                            and self.dtype == jnp.dtype(jnp.float32)):
                inv_tiles = inv_tiles.astype(jnp.bfloat16)
            pre_f = lambda r: block_jacobi_apply(params.bj_plan, inv_tiles, r)
        else:
            pre_f = lambda r: r * dinv

        # ---- u* momentum solve ----
        # proj_p_extrap = theta: solve about the explicit pressure
        # p* = p^n + theta (p^n - p^{n-1}) instead of p^n — at theta=1 the
        # increment carries only the O(dt^2) change, shrinking the
        # open-boundary phi boundary layer, but the full extrapolation is
        # MEASURED DIVERGENT (config.py proj_p_extrap notes)
        theta = float(cfg.proj_p_extrap)
        p_ref = (p + theta * phi_prev
                 if theta != 0.0 and phi_prev is not None else p)
        factor = self._time_factor(t_new).astype(self.dtype)
        g = bc.lift(factor)
        b_u = (ops.mass_apply(params, u_t) + params.rhs_neumann
               - apply_Bt_raw(p_ref))
        if self.forcing is not None:
            xq = params.forcing_xq
            fq = self.forcing(xq.reshape(-1, self.dim), t_new)
            fq = jnp.asarray(fq, self.dtype).reshape(xq.shape)
            r_c = jnp.einsum("cqa,cqd->cad", params.forcing_w, fq)
            b_u = b_u + self._forcing_scat(r_c.reshape(-1, self.dim))
        fg, _ = ops.apply_blocks(params, f_cell, g, zero_p,
                                 with_g=False, with_gt=False)
        b_u = (b_u - fg) * mask + sigma * g
        tol = cfg.proj_tol
        if self.dtype == jnp.dtype(jnp.float32):
            tol = max(tol, 3.0e-6)
        u_guess = (u if u_prev is None else (2.0 * u - u_prev))
        res_f = bicgstab(apply_F, b_u, x0=u_guess * mask + g, tol=tol,
                         maxiter=cfg.proj_f_maxiter, precond=pre_f)
        u_star = res_f.x * mask + g

        # ---- pressure Poisson:  Ap phi = B u* / dt ----
        # Consistent P1 Laplacian, outlet-pinned when an outflow exists
        # (stable open-boundary condition); closed domains keep the
        # all-Neumann operator with the constant nullspace projected out.
        pinned = self._ap_dir_pinned
        ap_op = params.ap_dir
        sc_inv = params.ap_dir_sc_inv
        lam = params.ap_dir_lam
        apply_ap = lambda v: ell_matvec(ap_op, v)
        solve_ap = make_vcycle_solver(
            apply_ap, ap_op.diag, self._coarse_plan, sc_inv,
            n_cycles=1, smooth_k=cfg.schur_smooth_k, lam_max=lam)
        if not pinned:
            # all-Neumann operator (closed domain): keep the preconditioner
            # output mean-free, or the (regularized-singular) coarse inverse
            # injects the constant nullspace into CG's search directions and
            # p.Ap -> 0 blows the iteration up (measured: NaN at step 1 on a
            # closed box)
            _solve0 = solve_ap
            solve_ap = lambda r: (lambda z: z - jnp.mean(z))(_solve0(r))
        div_star = apply_B_raw(u_star)
        rhs_p = div_star / dt_eff
        if pinned:
            # consistent Dirichlet elimination: zero the RHS (and the
            # solution, against smoother drift) at the pinned outlet nodes
            rhs_p = rhs_p * params.ap_dir_pin
        else:
            rhs_p = rhs_p - jnp.mean(rhs_p)
        pin_phi = params.ap_dir_pin
        if cfg.proj_poisson == "schur":
            # EXACT discrete projection: CG on the compatible
            # S = B W B^T — with the masked W, EXACTLY the operator of
            # the velocity correction below, so div(u_new) = 0 to the CG
            # tolerance at every unpinned node — with the V-cycle on the
            # assembled Laplacian as the spectrally-equivalent
            # preconditioner.  Pinned at the outlet AND at the
            # transmission-crippled boundary nodes (_build_cc_statics).
            w_col = params.ap_w[:, None]
            pin_phi = params.ap_schur_pin

            def apply_p(xp):
                xm = xp * pin_phi
                y = apply_B_raw(w_col * apply_Bt_raw(xm))
                return y * pin_phi + (xp - xm)

            rhs_p = (div_star / dt_eff) * pin_phi
        else:
            apply_p = apply_ap
        # warm start: phi (the pressure increment) varies slowly between
        # consecutive steps in developed flow — the previous increment cuts
        # the CG iteration count materially at small dt.  Under p_extrap
        # the increment is the CHANGE of increments (near zero in smooth
        # flow), so zero is the better initial guess.
        phi_x0 = None if theta != 0.0 else phi_prev
        res_p = cg(apply_p, rhs_p, x0=phi_x0, tol=tol,
                   maxiter=cfg.proj_p_maxiter, precond=solve_ap)
        phi = (res_p.x * pin_phi
               if (pinned or cfg.proj_poisson == "schur")
               else res_p.x - jnp.mean(res_p.x))

        # ---- correction + rotational pressure update ----
        u_new = u_star - dt_eff * (params.ap_w[:, None] * apply_Bt_raw(phi))
        u_new = u_new * mask + g               # exact boundary values
        p_new = p_ref + phi
        if cfg.proj_rotational:
            # -nu div(u*) == +nu Mp^-1 (B u*) in this operator convention
            p_new = p_new + params.nu * (div_star / params.mp_lumped)
        if theta != 0.0:
            # carry the FULL per-step pressure change (incl. the rotational
            # term) so next step's p* = p + theta (p^n - p^{n-1}) exactly
            phi = p_new - p

        # ---- forces (cpp:831-929) ----
        if params.faces_obst is not None:
            drag, lift = drag_lift(params.faces_obst, u_new, p_new,
                                   params.nu, formula=cfg.force_formula)
            # pulsating drivers define get_mean_vel() WITH the sin factor
            # (tests/2D/test_03/src/test_03.cpp:41-44) — normalize with the
            # instantaneous mean there (force_coefficients clamps the
            # denominator against the sin ~ 0 crossings)
            u_norm = (params.u_mean0 * factor if self.inlet.pulsating
                      else params.u_mean0)
            cd, cl = force_coefficients(drag, lift, u_norm,
                                        cfg.ref_length, self.dim,
                                        cfg.span_3d)
        else:
            drag = lift = cd = cl = jnp.asarray(0.0, self.dtype)

        metrics = StepMetrics(time=t_new,
                              iterations=res_f.iterations
                              + res_p.iterations,
                              residual=jnp.maximum(res_f.residual,
                                                   res_p.residual),
                              drag=drag, lift=lift, cd=cd, cl=cl,
                              converged=res_f.converged & res_p.converged)
        return u_new, p_new, t_new, phi, metrics

    def _step_fn(self, params: StepParams, u, p, t_prev, u_prev=None,
                 phi_prev=None):
        """One semi-implicit step: returns
        (u_new, p_new, t_new, phi, metrics).  ``u_prev`` (solution at n-1)
        enables the second-order extrapolated initial guess 2u - u_prev
        for the outer Krylov solve; ``phi_prev`` warm-starts the
        projection scheme's pressure-increment solve (unused and passed
        through by the monolithic scheme)."""
        cfg = self.config
        if cfg.scheme == "projection":
            assert self._operator == "bsr", \
                "scheme='projection' requires operator='bsr'"
            return self._step_projection(params, u, p, t_prev,
                                         u_prev=u_prev, phi_prev=phi_prev)
        ops = self._ops
        bc = params.bc
        mask = bc.mask                                  # (n_p2, 1)
        dt = cfg.deltat
        t_new = t_prev + dt

        # ---- assemble (cpp:133-330): static + convection ----
        conv = ops.convection(params, u)
        f_cell = params.a0_cell + conv

        # diag of F + conditioning scale sigma for constrained rows
        d = ops.f_diag(params, f_cell)                  # (n_p2,)
        mflat = mask[:, 0]
        sigma = jnp.sum(d * mflat) / jnp.maximum(jnp.sum(mflat), 1.0)
        d_bc = d * mflat + sigma * (1.0 - mflat)
        dinv = (1.0 / d_bc)[:, None]

        # ---- BC-masked block operators ----
        def raw_F(xu):
            yu, _ = ops.apply_blocks(params, f_cell, xu, zero_p,
                                     with_g=False, with_gt=False)
            return yu

        def apply_A(x):
            xu, xp = x
            xum = xu * mask
            yu, yp = ops.apply_blocks(params, f_cell, xum, xp)
            yu = yu * mask + sigma * (xu - xum)
            return yu, yp

        zero_p = jnp.zeros(self.space.n_p1, self.dtype)

        # low-precision F values for the preconditioner's inner solves
        # (matrix bf16, vectors fp32 -> fp32 accumulation via promotion)
        use_bf16 = (cfg.inner_bf16 and self.dtype == jnp.dtype(jnp.float32))
        f_inner = f_cell.astype(jnp.bfloat16) if use_bf16 else f_cell

        def apply_F(xu):
            xum = xu * mask
            yu, _ = ops.apply_blocks(params, f_inner, xum, zero_p,
                                     with_g=False, with_gt=False)
            return (yu * mask + sigma * (xu - xum)).astype(self.dtype)

        def apply_Bt_raw(xp):
            yu, _ = ops.apply_blocks(params, f_cell, jnp.zeros_like(u), xp,
                                     with_f=False, with_gt=False)
            return yu

        def apply_B(xu):
            _, yp = ops.apply_blocks(params, f_cell, xu * mask, zero_p,
                                     with_f=False, with_g=False)
            return yp

        def apply_Bt(xp):
            return apply_Bt_raw(xp) * mask

        # ---- RHS (cpp:240-278): M u^n/dt + forcing + Neumann, lifted ----
        factor = self._time_factor(t_new).astype(self.dtype)
        g = bc.lift(factor)                             # lifted Dirichlet
        b_u = ops.mass_apply(params, u) / dt + params.rhs_neumann
        f_extra = None
        if self.forcing is not None:
            xq = params.forcing_xq
            fq = self.forcing(xq.reshape(-1, self.dim), t_new)
            fq = jnp.asarray(fq, self.dtype).reshape(xq.shape)
            r_c = jnp.einsum("cqa,cqd->cad", params.forcing_w, fq)
            f_extra = self._forcing_scat(r_c.reshape(-1, self.dim))
            b_u = b_u + f_extra
        ag_u, ag_p = ops.apply_blocks(params, f_cell, g, zero_p)
        b_u = (b_u - ag_u) * mask + sigma * g
        b_p = -ag_p

        # ---- preconditioner (cpp:344-397 chooses aSIMPLE) ----
        # F-block approximate solve: block-Jacobi tile inverses
        # (ops/p1ell.py, the ILU(0) replacement) under Richardson or
        # BiCGStab, else diagonal-scaled BiCGStab.
        if (cfg.f_precond == "bj" and params.bj_plan is not None
                and self._operator == "bsr"):
            from navierstokes_tpu.ops.p1ell import (block_jacobi_apply,
                                                    block_jacobi_invert)
            inv_dtype = (jnp.bfloat16
                         if (cfg.inner_bf16 or cfg.bj_bf16)
                         and self.dtype == jnp.dtype(jnp.float32)
                         else self.dtype)
            bj_kw = {}
            if params.bj_plan.layout == "scatter":
                # tile values re-assembled from the per-cell convection
                # matrices (XLA CSE merges this with ops.convection's
                # identical element-matrix computation)
                from navierstokes_tpu.ops.operators import \
                    convection_matrices
                bj_kw = dict(c_elem=convection_matrices(
                    params.cells, params.cells.t_hat, u),
                    tiles0=params.bj_tiles0)
            inv_tiles = block_jacobi_invert(
                params.bj_plan, f_cell, mflat, sigma,
                x0=params.bj_x0, iters=cfg.bj_newton,
                **bj_kw).astype(inv_dtype)
            pre_f = lambda r: block_jacobi_apply(params.bj_plan, inv_tiles, r)
        else:
            pre_f = lambda r: r * dinv

        if cfg.f_solver == "richardson":
            def solve_f(rhs):
                x = pre_f(rhs)
                for _ in range(cfg.inner_maxiter_f - 1):
                    x = x + pre_f(rhs - apply_F(x))
                return x

            inner_f = lambda op, rhs, pre=None: solve_f(rhs)
        else:
            _inner_f = InnerSolve(cfg.inner_tol, cfg.inner_maxiter_f,
                                  method=cfg.f_solver)
            inner_f = lambda op, rhs, pre=None: _inner_f(op, rhs, pre_f)
        inner_s = InnerSolve(cfg.inner_tol, cfg.inner_maxiter_s)

        def vcycle_s(node_weights, diag_s):
            """Chebyshev-smoothed two-level V-cycle Schur solve
            (solvers/schur.py) — the ILU replacement, h-independent; only
            available on the BSR operator."""
            if self._operator != "bsr":
                return None
            from navierstokes_tpu.solvers.schur import (coarse_inverse,
                                                        coarse_matrix,
                                                        estimate_lam_max,
                                                        make_vcycle_solver)
            sc = coarse_matrix(params.cells, self._coarse_plan, node_weights)
            sc_inv = coarse_inverse(sc)

            def apply_s(v):
                return apply_B(apply_Bt(v) * node_weights[:, None])

            sdinv = jnp.where(diag_s != 0, 1.0 / diag_s, 1.0)
            lam = estimate_lam_max(apply_s, sdinv, self.space.n_p1,
                                   self.dtype)
            return make_vcycle_solver(apply_s, diag_s, self._coarse_plan,
                                      sc_inv, n_cycles=cfg.schur_vcycles,
                                      smooth_k=cfg.schur_smooth_k,
                                      lam_max=lam)

        if cfg.preconditioner in ("cc", "pcd") and self._operator == "bsr":
            from navierstokes_tpu.ops.p1ell import ell_matvec
            from navierstokes_tpu.solvers.preconditioners import (
                make_cahouet_chabard, make_pcd)
            from navierstokes_tpu.solvers.schur import make_vcycle_solver

            def apply_ap(v):
                # host-assembled Ap (P1 blocked ELL, ~5 MB) — NOT the
                # matrix-free B(w B^T v) which streams the full G/B blocks
                return ell_matvec(params.ap, v)

            solve_ap = make_vcycle_solver(
                apply_ap, params.ap.diag, self._coarse_plan,
                params.ap_sc_inv, n_cycles=cfg.schur_vcycles,
                smooth_k=cfg.schur_smooth_k, lam_max=params.ap_lam)
            if cfg.preconditioner == "pcd":
                from navierstokes_tpu.ops.bsr import (apply_pp,
                                                      pressure_convection_blk)
                np_blk = pressure_convection_blk(params.cells, u)

                def apply_np(v):
                    return apply_pp(params.cells, np_blk, v)

                M = make_pcd(apply_F, apply_Bt, solve_ap, apply_ap,
                             apply_np, params.mp_lumped, dinv, dt,
                             params.nu, inner_f)
            else:
                M = make_cahouet_chabard(apply_F, apply_Bt, solve_ap,
                                         params.mp_lumped, dinv, dt,
                                         params.nu, inner_f)
        elif cfg.preconditioner in ("asimple", "cc", "pcd"):
            # ("cc"/"pcd" fall back to aSIMPLE on non-BSR operator paths)
            w = dinv[:, 0] * mflat
            diag_s = ops.schur_diag(params, w)
            M = make_asimple(apply_F, apply_B, apply_Bt, dinv, diag_s,
                             cfg.alpha, inner_f, inner_s,
                             solve_s=vcycle_s(w, diag_s))
        elif cfg.preconditioner == "ayosida":
            w = params.dt_mlump_inv[:, 0] * mflat
            diag_s = ops.schur_diag(params, w)
            M = make_ayosida(apply_F, apply_B, apply_Bt, dinv,
                             params.dt_mlump_inv, diag_s, inner_f, inner_s,
                             solve_s=vcycle_s(w, diag_s))
        else:
            M = make_identity()

        # ---- outer FGMRES, warm-started from the previous step ----
        # (deal.II GMRES starts from solution_owned and uses
        #  tol = 1e-6 * ||rhs||, cpp:348, 377; we add second-order
        #  extrapolation in time, which roughly halves the iterations at
        #  statistically-steady state)
        u_guess = u if u_prev is None else (2.0 * u - u_prev)
        x0 = (u_guess * mask + g, p)
        # fp32 attainable-residual floor: the true residual plateaus around
        # ~2e-6 * ||b|| in single precision; asking for less burns
        # iterations without improving the solution
        tol = cfg.outer_tol
        if self.dtype == jnp.dtype(jnp.float32):
            tol = max(tol, 3.0e-6)
        res = fgmres(apply_A, (b_u, b_p), x0=x0, tol=tol,
                     restart=cfg.outer_restart, maxiter=cfg.outer_maxiter,
                     precond=M)
        u_new, p_new = res.x
        true_res = res.residual
        if (cfg.refine > 0 and self._operator == "bsr"
                and params.cells.m_blk is not None
                and self.dtype == jnp.dtype(jnp.float32)):
            # compensated iterative refinement (solvers/refine.py):
            # df-accurate residual of the SAME masked system + fp32
            # correction solves with the step's preconditioner
            from navierstokes_tpu.solvers.refine import (refine_saddle,
                                                         rhs_df)
            b_df = rhs_df(params.cells, f_cell, mask, sigma,
                          params.cells.m_blk, u, g, dt,
                          params.rhs_neumann, extra=f_extra)

            def _corr(r):
                rr = fgmres(apply_A, r, tol=cfg.refine_tol,
                            restart=cfg.outer_restart,
                            maxiter=cfg.refine_maxiter, precond=M)
                return rr.x

            (u_new, p_new), true_res = refine_saddle(
                params.cells, f_cell, mask, sigma, b_df,
                (u_new, p_new), _corr, cfg.refine)
            # layout pin (see ops/operators.py): without it the refined
            # outputs can pick a different XLA:CPU layout than the scan
            # carry, which breaks donated-buffer reuse across chunk calls
            u_new = u_new + 0.0 * u
            p_new = p_new + 0.0 * p
        u_new = u_new * mask + g   # exact boundary values

        # ---- forces (cpp:831-929) ----
        if params.faces_obst is not None:
            drag, lift = drag_lift(params.faces_obst, u_new, p_new,
                                   params.nu, formula=cfg.force_formula)
            # each pulsating driver's get_mean_vel() includes the sin
            # factor (tests/2D/test_03/src/test_03.cpp:41-44, evaluated at
            # the assembled time), so normalize with the instantaneous
            # mean for pulsating inlets; steady drivers keep the constant
            # mean (src/NavierStokes.cpp:911)
            u_norm = (params.u_mean0 * factor if self.inlet.pulsating
                      else params.u_mean0)
            cd, cl = force_coefficients(drag, lift, u_norm,
                                        cfg.ref_length, self.dim,
                                        cfg.span_3d)
        else:
            drag = lift = cd = cl = jnp.asarray(0.0, self.dtype)

        metrics = StepMetrics(time=t_new, iterations=res.iterations,
                              residual=true_res, drag=drag, lift=lift,
                              cd=cd, cl=cl, converged=res.converged)
        phi = (jnp.zeros_like(p) if phi_prev is None else phi_prev)
        return u_new, p_new, t_new, phi, metrics

    def _chunk_fn(self, n_steps: int):
        """Compiled scan over n_steps time steps.  All mesh/operator data
        flows in through the params pytree argument — the compiled program
        is value-independent, so XLA's persistent cache can reuse it across
        scenarios and instances with the same mesh shapes.

        State tuple: (u, p, u_prev, phi, t) — ``phi`` is the projection
        scheme's last pressure increment (warm start; zeros to seed)."""
        if n_steps not in self._chunks:
            def run(params, u, p, u_prev, phi, t0):
                def body(carry, _):
                    u, p, u_prev, phi, t = carry
                    u_new, p_new, t, phi, m = self._step_fn(
                        params, u, p, t, u_prev=u_prev, phi_prev=phi)
                    return (u_new, p_new, u, phi, t), m

                (u, p, up, phi, t), ms = jax.lax.scan(
                    body, (u, p, u_prev, phi, t0), None, length=n_steps)
                return u, p, up, phi, t, ms

            self._chunks[n_steps] = jax.jit(at_matmul_precision(run),
                                            donate_argnums=(1, 2, 3, 4))
        return self._chunks[n_steps]

    # ------------------------------------------------------------------
    # reference-parity public API
    # ------------------------------------------------------------------

    @at_matmul_precision
    def assemble(self, time: float):
        """Expose the assembled operator at a given time (testing /
        introspection parity with cpp:133-330).  Format depends on the
        operator realization: per-cell element matrices ('cells') or
        graph values ('ell'/'bsr').  Callable any time after setup()
        (state lazily zero-initialized, matching the reference where
        assemble() precedes the first solve); ``time`` is recorded so a
        following solve_time_step() uses the inlet BC factor at
        ``time + dt`` exactly as the reference's loop does."""
        if not hasattr(self, "_u"):
            self._init_state(0)
        self.time = float(time)
        params = self._params()
        return params.a0_cell + self._ops.convection(params, self._u)

    def solve_time_step(self):
        """Advance exactly one step (parity with cpp:344-397).  Usable
        straight after setup() — state is lazily zero-initialized."""
        if not hasattr(self, "_u"):
            self._init_state(0)
        run = self._chunk_fn(1)
        self._u, self._p, self._u_prev, self._phi, t, ms = run(
            self._params(), self._u, self._p, self._u_prev, self._phi,
            jnp.asarray(self.time, self.dtype))
        self.time = float(t)
        m = jax.tree.map(lambda a: np.asarray(a)[0], ms)
        self._record(m)
        return m

    def _record(self, m: StepMetrics, idx=None):
        get = (lambda a: float(np.asarray(a)[idx]) if idx is not None
               else float(np.asarray(a)))
        self.drag, self.lift = get(m.drag), get(m.lift)
        self.cd, self.cl = get(m.cd), get(m.cl)

    def _init_state(self, time_step: int = 0):
        sp = self.space
        if time_step == 0:
            # InitialConditions are identically zero (hpp:140-163)
            self.time = 0.0
            self._u = jnp.zeros((sp.n_p2, self.dim), self.dtype)
            self._p = jnp.zeros(sp.n_p1, self.dtype)
            # distinct buffers: u/u_prev and p/phi are each donated to the
            # chunk separately
            self._u_prev = jnp.zeros((sp.n_p2, self.dim), self.dtype)
            self._phi = jnp.zeros(sp.n_p1, self.dtype)
        else:
            from navierstokes_tpu.utils.checkpoint import checkpoint_path
            u, p, t = import_state(self.config.cache_dir, time_step)
            self.time = t
            self._u = jnp.asarray(u, self.dtype)
            self._p = jnp.asarray(p, self.dtype)
            # u_prev + phi restore the extrapolation/warm-start history
            # (restart then reproduces the continuous run bit-for-bit)
            with np.load(checkpoint_path(self.config.cache_dir,
                                         time_step)) as z:
                up = z["u_prev"] if "u_prev" in z.files else np.array(u)
                phi = (z["phi"] if "phi" in z.files
                       else np.zeros_like(np.asarray(p)))
            self._u_prev = jnp.asarray(np.array(up), self.dtype)
            self._phi = jnp.asarray(np.array(phi), self.dtype)
            print(f"Continuing execution from time step {time_step}")

    @at_matmul_precision
    def _measure_prec_init(self, params) -> float:
        """On-device timing of the per-step preconditioner (re)build — the
        analogue of the reference's aSIMPLE initialize span (cpp:383-386).
        For the block-Jacobi F preconditioner this is the batched tile
        inversion; other configurations rebuild nothing per step (their
        setup is static) and report 0."""
        cfg = self.config
        if not (cfg.f_precond == "bj" and self._operator == "bsr"
                and getattr(self, "_bj_plan", None) is not None):
            return 0.0
        from navierstokes_tpu.ops.p1ell import block_jacobi_invert
        mflat = self.bc.mask[:, 0]
        # the step's actual conditioning scale (interior diag mean of A0) —
        # measuring with a placeholder sigma could change the Newton/LU
        # fallback branch and mis-time the rebuild
        d0 = self._ops.f_diag(params, params.a0_cell)
        sigma = jnp.sum(d0 * mflat) / jnp.maximum(jnp.sum(mflat), 1.0)
        # everything sizable rides as a jit ARG: a closed-over x0 (hundreds
        # of MB of tile seeds at 3D scale) would be inlined as HLO constants
        if params.bj_plan.layout == "scatter":
            # scatter rebuild: same element-matrix + segment-sum cost at
            # u=0 as at the real step state
            from navierstokes_tpu.ops.operators import convection_matrices
            fn = jax.jit(lambda plan, cells, m, x0, t0:
                         block_jacobi_invert(
                             plan, None, m, sigma, x0=x0,
                             iters=cfg.bj_newton, tiles0=t0,
                             c_elem=convection_matrices(
                                 cells, cells.t_hat,
                                 jnp.zeros((self.space.n_p2, self.dim),
                                           self.dtype))))
            args = (params.bj_plan, params.cells, mflat,
                    params.bj_x0, params.bj_tiles0)
        else:
            fn = jax.jit(lambda plan, fc, m, x0: block_jacobi_invert(
                plan, fc, m, sigma, x0=x0, iters=cfg.bj_newton))
            args = (params.bj_plan, params.a0_cell, mflat, params.bj_x0)
        jax.block_until_ready(fn(*args))                   # compile
        t0 = _walltime.perf_counter()
        jax.block_until_ready(fn(*args))
        return _walltime.perf_counter() - t0

    def solve(self, time_step: int = 0, csv_path: str | None = None):
        """Full time loop (parity with cpp:439-499): ICs or restart, then
        chunked stepping with csv + VTU + checkpoint every output_step.
        Each chunk runs up to the next output step, at most
        ``steps_per_chunk`` steps when that is set; the per-step metrics of
        the run are kept, as host arrays, in ``self.history``."""
        assert self._is_setup, "call setup() first"
        cfg = self.config
        self._init_state(time_step)
        self.export_data(time_step)

        dt = cfg.deltat
        n_total = int(np.floor(cfg.t_final / dt + 0.5)) - time_step
        out_every = cfg.output_step

        csv = ForcesCsv(csv_path or cfg.csv_path)
        params = self._params()
        t_prec = self._measure_prec_init(params)
        ts = time_step
        done = 0
        self.history = []
        # every chunk-length variant is a separately compiled program with
        # its own temporaries; steps_per_chunk caps the length for runs
        # near the device-memory limit
        k_cap = cfg.steps_per_chunk if cfg.steps_per_chunk > 0 else n_total
        while done < n_total:
            k_align = (out_every - (ts % out_every)) if out_every else n_total
            k = max(1, min(k_align, n_total - done, k_cap))
            run = self._chunk_fn(k)
            t0 = _walltime.perf_counter()
            self._u, self._p, self._u_prev, self._phi, t_dev, ms = run(
                params, self._u, self._p, self._u_prev, self._phi,
                jnp.asarray(self.time, self.dtype))
            ms = jax.tree.map(np.asarray, ms)
            wall = _walltime.perf_counter() - t0
            self.time = float(t_dev)
            self.history.append(ms)
            per_step = wall / k
            # reference csv schema (cpp:383-390): time_prec_init = the
            # per-step preconditioner (re)build, time_sol = the rest of the
            # step.  The whole step is one fused XLA program here, so the
            # build cost is measured once on-device (_measure_prec_init)
            # and the solve share is wall-per-step minus it.
            t_sol = max(per_step - t_prec, 0.0)
            for i in range(k):
                csv.row(ms.time[i], dt, ms.iterations[i], t_prec, t_sol,
                        ms.drag[i], ms.lift[i], ms.cd[i], ms.cl[i])
            self._record(ms, idx=-1)
            done += k
            ts += k
            cfl = self.measured_cfl()
            print(f"n = {ts:4d}, t = {self.time:.4f}: "
                  f"{int(ms.iterations[-1])} FGMRES its "
                  f"(res {float(ms.residual[-1]):.1e}), "
                  f"Cd = {self.cd:.5f}, Cl = {self.cl:.5f} "
                  f"(CFL {cfl:.2f}, {per_step * 1e3:.1f} ms/step)")
            if (cfl > 2.5 and not self._cfl_warned
                    and cfg.scheme == "projection" and cfg.proj_bdf2):
                self._cfl_warned = True
                print(f"WARNING: measured advective CFL {cfl:.2f} > 2.5 — "
                      "the BDF2 projection is unstable in this regime; "
                      "reduce deltat or set proj_bdf2=False")
            if out_every and ts % out_every == 0:
                self.output(ts)
                self.export_data(ts)
        csv.close()
        return self

    # ---- I/O parity ---------------------------------------------------

    def output(self, time_step: int):
        """VTU/PVTU dump (parity with cpp:400-436)."""
        sp = self.space
        part = self._partitioning_field()
        p_p2 = sp.pressure_at_p2_nodes(np.asarray(self._p))
        write_vtu_pvtu(self.config.output_dir, "output-stokes", time_step,
                       sp.p2_coords, np.asarray(sp.cell_p2),
                       np.asarray(self._u), p_p2, part)

    def _partitioning_field(self):
        try:
            from navierstokes_tpu.parallel.sharding import cell_partitioning
            return cell_partitioning(self.space.mesh.n_cells,
                                     self.config.n_devices)
        except Exception:
            return np.zeros(self.space.mesh.n_cells)

    def export_data(self, time_step: int):
        export_state(self.config.cache_dir, time_step, self._u, self._p,
                     self.time, extra=dict(u_prev=np.asarray(self._u_prev),
                                           phi=np.asarray(self._phi)))

    def import_data(self, time_step: int):
        self._init_state(time_step)

    @at_matmul_precision
    def compute_forces(self, time: float | None = None):
        """Force recomputation on the current state (cpp:831-929)."""
        drag, lift = drag_lift(self.faces_obst, self._u, self._p, self.nu,
                               formula=self.config.force_formula)
        t = self.time if time is None else time
        # pulsating drivers' get_mean_vel() carries the sin factor
        # (tests/2D/test_03/src/test_03.cpp:41-44); steady ones don't
        u_norm = (self.inlet.mean_velocity(t) if self.inlet.pulsating
                  else self.inlet.steady_mean_velocity())
        cd, cl = force_coefficients(float(drag), float(lift), u_norm,
                                    self.config.ref_length, self.dim,
                                    self.config.span_3d)
        self.drag, self.lift = float(drag), float(lift)
        self.cd, self.cl = float(cd), float(cl)
        return self.cd, self.cl

    def post_process(self, initial_time_step: int, final_time_step: int,
                     step: int):
        """Replay checkpoints: import -> forces -> VTU, without re-solving
        (parity with cpp:808-828 + src/postprocess.cpp)."""
        results = []
        for ts in range(initial_time_step, final_time_step + 1, step):
            self._init_state(ts)
            cd, cl = self.compute_forces(self.time)
            self.output(ts)
            results.append((ts, self.time, cd, cl))
            print(f"post-process ts={ts}: Cd={cd:.5f} Cl={cl:.5f}")
        return results
