"""Runtime configuration for the Navier-Stokes framework.

The reference configures everything at compile time (macro ``DIM``,
``NS_INPUT`` inlet injection, hard-coded constants nu/p_out/Diameter —
src/NavierStokes.hpp:54, :77-122, :254-256) plus constructor arguments
(mesh, degrees, dt, T, step — src/NavierStokes.hpp:173-189).  Here all of
that is a runtime dataclass, so one build serves every scenario.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional


@dataclasses.dataclass
class InletConfig:
    """Inlet velocity profile (x-component only, like every reference scenario).

    Profiles found in the reference drivers:
      * ``uniform``:      u_x = u_m                           (tests/2D/test_naca, src/main default 3.0)
      * ``parabolic``:    u_x = 4 u_m y (H - y) / H^2         (tests/2D/test_01, test_02)
      * ``biparabolic``:  u_x = 16 u_m y z (H-y)(H-z) / H^4   (tests/3D/test_01, test_02)
    ``pulsating=True`` multiplies by sin(pi t / period)        (tests/{2,3}D/test_03).

    ``mean_velocity()`` reproduces each driver's ``get_mean_vel()``:
    uniform -> u_m; parabolic -> 2 u_m / 3; biparabolic -> 4 u_m / 9
    (tests/2D/test_02/src/test_02.cpp:39-42, tests/3D/test_01/src/test_01.cpp:39-42),
    with the same sin factor when pulsating (tests/2D/test_03/src/test_03.cpp:41-44).
    """

    kind: str = "parabolic"  # uniform | parabolic | biparabolic | custom
    u_m: float = 1.5
    height: float = 0.41
    pulsating: bool = False
    period: float = 8.0
    # Smooth (C1, raised-cosine) start-up ramp length in seconds; 0 = the
    # reference's impulsive start.  An impulsive start at CFL >~ 4 puts the
    # first few solves on a knife edge (stagnating Krylov iterations that
    # can amplify epsilon-level perturbations into divergence at 1M DoF);
    # a short ramp removes the pathology without changing the developed
    # flow the benchmarks measure.
    ramp: float = 0.0
    # Optional override: fn(points[(n, dim)], t) -> (n,) u_x values, or
    # (n, dim) full velocity vectors (reference InletVelocity::vector_value,
    # src/NavierStokes.hpp:77-122 — every shipped driver is x-only but the
    # hook is a full dim-vector Function)
    profile_fn: Optional[Callable] = None
    # Optional override of the mean velocity used for Re and Cd/Cl normalization.
    mean_override: Optional[float] = None

    def time_factor(self, t: float) -> float:
        f = math.sin(math.pi * t / self.period) if self.pulsating else 1.0
        if self.ramp and t < self.ramp:
            f *= 0.5 - 0.5 * math.cos(math.pi * t / self.ramp)
        return f

    def mean_velocity(self, t: float = 0.0) -> float:
        if self.mean_override is not None:
            base = self.mean_override
        elif self.kind == "uniform":
            base = self.u_m
        elif self.kind == "parabolic":
            base = 2.0 * self.u_m / 3.0
        elif self.kind == "biparabolic":
            base = 4.0 * self.u_m / 9.0
        else:
            raise ValueError(
                f"mean_override required for custom inlet kind {self.kind!r}")
        return base * self.time_factor(t)

    def steady_mean_velocity(self) -> float:
        """Mean velocity without the pulsation factor (used by set_re_number,
        matching the reference which calls get_mean_vel() at setup time where
        sin-time profiles would otherwise give 0 — src/NavierStokes.cpp:332-341
        evaluates get_mean_vel() before the time loop)."""
        if self.mean_override is not None:
            return self.mean_override
        if self.kind == "uniform":
            return self.u_m
        if self.kind == "parabolic":
            return 2.0 * self.u_m / 3.0
        if self.kind == "biparabolic":
            return 4.0 * self.u_m / 9.0
        raise ValueError(f"mean_override required for custom inlet {self.kind!r}")

    def evaluate(self, points, t: float):
        """Inlet velocity at the given coordinates (host-side numpy):
        (n,) u_x values for the builtin profiles, or whatever profile_fn
        returns — (n,) x-only or (n, dim) full vectors."""
        import numpy as np

        pts = np.asarray(points)
        if self.profile_fn is not None:
            # passthrough: the fn receives t and owns any time dependence
            return np.asarray(self.profile_fn(pts, t))
        H = self.height
        if self.kind == "uniform":
            vals = np.full(pts.shape[0], self.u_m)
        elif self.kind == "parabolic":
            y = pts[:, 1]
            vals = 4.0 * self.u_m * y * (H - y) / (H * H)
        elif self.kind == "biparabolic":
            y, z = pts[:, 1], pts[:, 2]
            vals = 16.0 * self.u_m * y * z * (H - y) * (H - z) / (H ** 4)
        else:
            raise ValueError(f"unknown inlet kind {self.kind!r}")
        return vals * self.time_factor(t)


@dataclasses.dataclass
class SolverConfig:
    """All solver knobs.  Defaults mirror the reference's hard-coded values."""

    # Physics (src/NavierStokes.hpp:254-256)
    nu: float = 1.0e-3
    p_out: float = 0.0
    # Reference length used in Cd/Cl normalization.  The reference hard-codes
    # 0.4 (src/NavierStokes.hpp:256) even for the d=0.1 cylinder; we keep that
    # default for output parity but expose it (see BASELINE.md normalization
    # caveat).
    ref_length: float = 0.4
    # 3D span factor: reference divides by an extra 0.41 in 3D
    # (src/NavierStokes.cpp:913-917).
    span_3d: float = 0.41
    # Viscous force term (ops/forces.py): "reference" = n.grad(u).t, the
    # reference's contraction (vanishes on no-slip walls — its printed
    # coefficients carry no friction); "st" = t.grad(u).n, the
    # Schaefer-Turek definition (use for benchmark comparisons).
    force_formula: str = "reference"

    # Time stepping (ctor args, src/NavierStokes.hpp:173-189)
    deltat: float = 0.01
    t_final: float = 2.0
    output_step: int = 10  # VTU + checkpoint every this many steps

    # FE degrees (always 2/1 in the reference drivers)
    degree_velocity: int = 2
    degree_pressure: int = 1

    # Time-stepping scheme:
    #   "monolithic" — reference parity: the full saddle-point system per
    #                  step, FGMRES + block preconditioner (cpp:344-397)
    #   "projection" — rotational incremental pressure-correction
    #                  [Timmermans/Guermond-Minev-Shen]: one BC-masked
    #                  F-solve + one pressure-Poisson solve per step.
    #                  Same semi-implicit convection linearization and
    #                  dt order; O(dt^2) pressure splitting error.  The
    #                  production scheme (needs operator='bsr').
    scheme: str = "monolithic"
    proj_f_maxiter: int = 150     # BiCGStab budget for the u* solve
    # CG budget for the pressure Poisson.  At the 1M-DoF bench mesh the
    # V-cycle-preconditioned CG needs up to ~53 iterations at start-up and
    # where the inlet ramp ends (measured on an H100): a cap of 50 left
    # those steps unconverged.  Converging steps stop at proj_tol anyway.
    proj_p_maxiter: int = 100
    proj_rotational: bool = True  # rotational pressure update (+nu div u*)
    # BDF2 time derivative + second-order extrapolated convection
    # linearization C(2u^n - u^{n-1}) for the projection scheme: true
    # O(dt^2) velocity accuracy (the BDF1 variant inherits the monolithic
    # reference's first-order local error, which dominates Cl_max).
    # STABILITY DOMAIN: the extrapolated convection is explicit — measured
    # stable at CFL <~ 2 (all VALIDATION.md runs) but unstable at the
    # CFL~8 bench point; use proj_bdf2=False there (reference-matching
    # temporal order).
    proj_bdf2: bool = True
    # Explicit-pressure extrapolation weight theta in the momentum
    # equation: solve for the increment about
    # p* = p^n + theta (p^n - p^{n-1}) instead of about p^n (theta=0).
    # theta=1 is the formally second-order explicit pressure that would
    # shrink the incremental scheme's open-boundary phi boundary layer
    # (the dphi/dn=0-on-Dirichlet inconsistency capping it at O(dt^1.5)
    # near open boundaries); it is also the classical stability trap of
    # pressure-correction methods — MEASURED DIVERGENT on the
    # manufactured open-boundary problem (scripts/exp_pextrap.py), see
    # VALIDATION.md for the partial-theta study.  Default 0 (plain
    # incremental scheme).
    proj_p_extrap: float = 0.0
    # Pressure-Poisson operator of the projection step:
    #   "laplacian" — assembled consistent P1 stiffness (default; an
    #       APPROXIMATE projection: the corrected velocity's divergence
    #       is zero only up to the Lp-vs-B W B^T discrepancy per step)
    #   "schur" — CG on the COMPATIBLE operator S = B W B^T (W =
    #       diag(mask/M_lumped), exactly the weights of the velocity
    #       correction) preconditioned by the SAME Laplacian V-cycle;
    #       the discrete projection is then exact to the CG tolerance.
    #       The bare compatible operator was measured to excite a
    #       growing outflow mode in round 2 (ops/p1ell.assemble_p1_stiffness
    #       notes); here it is outlet-PINNED like the Laplacian (phi=0
    #       rows/cols at outlet P1 nodes), which anchors that mode,
    #       AND pinned at every transmission-crippled boundary pressure
    #       node (see proj_schur_pin_ratio) — without the latter the
    #       boundary rows whose velocity stencil is largely Dirichlet
    #       demand O(100x) phi spikes and the stepping blows up
    #       (measured round 5; models/navier_stokes._build_cc_statics).
    #       Costs one apply_bt+apply_b pair per CG iteration on top of
    #       the V-cycle.
    proj_poisson: str = "laplacian"
    # proj_poisson='schur' pin threshold: pin phi=0 at pressure nodes
    # whose masked S diagonal keeps less than this fraction of its
    # unmasked weight (their divergence is left to the BC re-imposition,
    # as the Laplacian variant leaves its boundary layer everywhere).
    # 1.0-eps pins every Dirichlet-adjacent node (exactness only at
    # pure-interior nodes); smaller keeps more nodes exact but risks the
    # measured boundary-mode instability.
    proj_schur_pin_ratio: float = 0.95
    # Relative tolerance of the projection sub-solves.  1e-4 is matched to
    # the O(dt^2) splitting error: measured Cd within 0.3% of the fully
    # (1e-6) converged projection at the 1M-DoF bench point, with ~2.3x
    # fewer Krylov iterations.
    proj_tol: float = 1.0e-4

    # Outer Krylov (src/NavierStokes.cpp:344-397)
    outer_tol: float = 1.0e-6     # relative to ||rhs||
    outer_maxiter: int = 200      # reference allows 10000
    outer_restart: int = 64       # larger basis measurably cuts iterations
    # Compensated (double-float) iterative-refinement passes after the
    # monolithic solve (solvers/refine.py).  Breaks the fp32 attainable-
    # residual floor (~3e-6*||b||) that washed out small force
    # coefficients (2D-1 Cl, VALIDATION.md round 2) — the fp32
    # stand-in for the reference's all-f64 solve
    # (src/NavierStokes.cpp:348, 377).  0 = off.  Monolithic BSR fp32
    # only (the projection scheme's splitting error dominates its solver
    # floor, so refinement is not wired there).
    refine: int = 0
    refine_tol: float = 1.0e-2    # relative tol of each correction solve
    refine_maxiter: int = 60
    # Block preconditioner:
    #   "cc"      — Cahouet-Chabard Schur approximation (static pressure-
    #               Laplacian V-cycle + pressure mass): h/dt-robust, the
    #               performance default
    #   "pcd"     — pressure convection-diffusion (CC + per-step pressure
    #               convection operator): better at CFL > 1
    #   "asimple" — reference parity (src/NavierStokes.cpp:934-995); O(100)
    #               outer iterations at CFL > 1 by construction
    #   "ayosida" — reference alternate (cpp:998-1051)
    #   "identity"
    preconditioner: str = "cc"
    alpha: float = 0.5            # aSIMPLE damping (src/NavierStokes.hpp:306)

    # Inner solves (reference: ILU-GMRES, rtol 1e-2, src/NavierStokes.cpp:972-973).
    # Here the ILU is replaced by block-Jacobi or Jacobi preconditioning with
    # a fixed iteration cap (statically shaped under jit).
    inner_tol: float = 1.0e-2
    inner_maxiter_f: int = 10
    inner_maxiter_s: int = 20
    # F-block preconditioner inside the inner velocity solve:
    #   "bj"     — tile-diagonal dense inverse (batched matmul Newton-Schulz,
    #              rebuilt per step; the ILU(0) replacement — ops/p1ell.py)
    #   "jacobi" — diagonal scaling only
    f_precond: str = "bj"
    # F-solve strategy: "bicgstab" = Krylov inner solve (2 matvecs/iter);
    # "richardson" = inner_maxiter_f preconditioned Richardson sweeps
    # (cheapest per sweep but MEASURED UNSTABLE at the bench operating
    # point, CFL~8: outer FGMRES stalls at res ~3e-3 — scripts/exp_iters.py)
    f_solver: str = "bicgstab"
    # BSR block-rows per block-Jacobi tile (tile size = this * bu nodes).
    # 0 => auto = max(1, 256 // bu), i.e. 256-node tiles regardless of the
    # BSR block size: a stronger preconditioner than 128-node tiles (fewer
    # BiCGStab iterations at the 1M-DoF bench point).
    bj_tile_blocks: int = 0
    # Block-Jacobi tile formulation (ops/p1ell.block_jacobi_tiles):
    # "blocked" gathers whole (bu,bu) blocks (few long gather rows) but
    # its intermediates have a narrow minor axis, which the accelerator
    # the solver was first built for padded to 128 lanes; "rows" gathers
    # bu-wide rows; "scatter" assembles the tile values directly from the
    # per-cell convection matrices via a presorted segment-sum on top of
    # a host-precomputed static base (no gather, no padded transient).
    # "auto" picks blocked while that padded footprint stays < 8 GB,
    # scatter beyond.  Not yet re-derived on a GPU.
    bj_tiles: str = "auto"
    # Read the F-block values in bfloat16 inside the PRECONDITIONER's inner
    # solves (vectors and accumulation stay fp32).  Not measured on a GPU
    # yet; kept as an option.
    inner_bf16: bool = False
    # Keep the inverted block-Jacobi tiles (the dominant preconditioner
    # HBM stream, ~tile_nodes^2 * n_tiles bytes) in bfloat16 — only the
    # preconditioner apply; operator/vectors/accumulation stay fp32.
    # MEASURED DIVERGENT at the CFL~8 1M-DoF bench point (BiCGStab stalls
    # at the iteration budget, then NaN — same failure signature round 2
    # attributed to inner_bf16, which also casts these tiles).  Usable at
    # CFL <~ 2; default off.
    bj_bf16: bool = False
    # Newton-Schulz iterations for the per-step block-Jacobi tile
    # inversion, seeded by the static-operator inverses (ops/p1ell.py
    # block_jacobi_invert): 2*bj_newton batched 256^3 matmuls instead of a
    # batched LU; falls back to the LU in-graph when the seed is out of
    # the contraction region.  0 = exact LU every step.
    bj_newton: int = 3
    # Consistent-mass realization for the once-per-step M u^n product:
    #   "auto"    — blocked in 2D (reuses the F gather structure),
    #               node-ELL in 3D (compact: the blocked form would double
    #               the resident F-family memory)
    #   "blocked" | "node" — force either
    # Robustness note (diagnosed on-chip at the 1M-DoF CFL~8 bench point):
    # an IMPULSIVE start there sits on a knife edge — steps 2-4 stagnate
    # near the BiCGStab iteration cap and ANY epsilon-level change to the
    # arithmetic (the blocked form's different fp32 summation order, bf16
    # preconditioner tiles) can tip a near-stagnating solve into outright
    # failure and NaN within ~3 further steps, while the node form happens
    # to survive.  With a short inlet ramp (InletConfig.ramp ~ 4 dt) the
    # same blocked configuration is robustly stable (30/30 steps, its
    # 117 -> 46).  Use `ramp` for impulsive high-CFL starts.
    mass_format: str = "auto"

    # Curved (superparametric P2) geometry on obstacle boundaries: when the
    # mesh carries analytic boundary projectors (Mesh.snap_projectors, set
    # by the native generators), midside P2 nodes on those boundaries are
    # snapped onto the exact curve/surface and the touched cells + faces
    # use per-quadrature-point quadratic geometry (exact element matrices,
    # convection, normals and force integrals).  This is what gmsh+deal.II
    # get from resolving the circle at local h (mesh/domain2D.geo:10) and
    # it is what lands 2D-1 Cl inside the published band.  Inert for
    # polygonal/gmsh meshes without projectors.
    curved_boundary: bool = True

    # Numerics
    dtype: str = "float32"        # compute dtype on device
    # Operator realization:
    #   "bsr"   — block-sparse-row over Hilbert-ordered node blocks: few wide
    #             gathers + batched small matmuls per matvec, per-step
    #             assembly via one presorted segment-sum (fastest; default)
    #   "ell"   — per-node graph: one (n, K)-row gather per matvec
    #   "cells" — element gather/scatter on every matvec (reference
    #             formulation; used by the sharded path)
    operator: str = "bsr"
    # BSR block size (velocity AND pressure block rows).  0 => auto = 16.
    # Larger blocks mean fewer gather rows per matvec but a larger value
    # stream (value GB 0.26/0.38/0.65 at bu 16/32/64 on a 672k-DoF 2D
    # mesh) that the per-step convection scatter and block-Jacobi rebuild
    # also pay.  16 won the end-to-end A/B on the accelerator the solver
    # was first built for; not yet re-measured on a GPU.
    bsr_block: int = 0
    # Overflow split of the F block-ELL (ops/bsr.py): rows with more than
    # this many column-block slots spill the excess into virtual rows,
    # trimming ELL padding from every matvec's gather + value streams
    # (K_max 16 vs mean 9.5 on the 1M-DoF 2D graph -> ~30% less traffic).
    # 0 disables; -1 picks the row-count 90th percentile at build time
    # (default; validated at the 1M-DoF bench point: identical physics).
    bsr_f_kmax: int = -1
    # Overflow split of the G/B (pressure-coupling) block graphs, same
    # trick applied to the static gradient/divergence values: the unsplit
    # max-K ELL is only 0.44 / 0.67 full on the 305k-DoF 3D graph, so the
    # split cuts ~2 GiB of resident fp32 values at 3.39M DoF plus the
    # matching per-apply traffic.  -2 = auto (split
    # under the projection scheme; whole rows under monolithic — the CC
    # coarse assembly needs G block PAIRS within whole rows,
    # solvers/schur.coarse_matrix); -1 = split; 0 = off.
    bsr_gb_kmax: int = -2
    # Two-level Schur solve (solvers/schur.py): pressure BSR blocks per
    # aggregate (coarse size = n_p1 / (bp * this)), V-cycle count and
    # Chebyshev smoothing steps per cycle.  0 => auto = max(1, 64 // bp),
    # i.e. 64-node aggregates independent of the BSR block size (the
    # round-3-validated coarse size at bp=16).
    schur_agg_blocks: int = 0
    schur_vcycles: int = 2
    schur_smooth_k: int = 3
    # Time loop chunking: how many time steps run inside one jitted scan call.
    steps_per_chunk: int = 0      # 0 => use output_step

    # Output
    output_dir: str = "output"
    cache_dir: str = "cache"
    csv_path: str = "forces_vs_time.csv"

    # Distribution
    n_devices: int = 0  # 0 => all visible devices; 1 => single device

    def resolved_steps_per_chunk(self) -> int:
        return self.steps_per_chunk if self.steps_per_chunk > 0 else max(1, self.output_step)
