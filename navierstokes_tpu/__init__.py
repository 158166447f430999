"""navierstokes_tpu — an incompressible Navier-Stokes framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the reference
deal.II/Trilinos/MPI solver (denisuntila/NavierStokes-Capoferri_Cecchettini_Untila):

* Taylor-Hood P2/P1 simplex finite elements in 2D (triangles) and 3D (tets)
  (reference: src/NavierStokes.cpp:31-57).
* Semi-implicit (linearized-convection) time stepping for the incompressible
  Navier-Stokes equations (reference: src/NavierStokes.cpp:133-330).
* Monolithic velocity-pressure system solved by jitted FGMRES with an
  algebraic-SIMPLE (or Yosida) block preconditioner
  (reference: src/NavierStokes.cpp:344-397, 934-1051).
* Boundary-integral drag/lift (Cd/Cl) postprocessing
  (reference: src/NavierStokes.cpp:831-929).
* Rank/device-count independent checkpoint & replay
  (reference: src/NavierStokes.cpp:501-828).

Everything on the compute path is batched, statically-shaped JAX that XLA
compiles for the GPU; distribution uses `jax.sharding.Mesh` + `shard_map`
(cells sharded, DoF vectors replicated, scatter reductions via psum) instead of
MPI domain decomposition.
"""

__version__ = "0.1.0"

from navierstokes_tpu.config import SolverConfig, InletConfig  # noqa: F401


def __getattr__(name):
    # lazy to keep `import navierstokes_tpu.fem` usable before models exist
    if name == "NavierStokes":
        from navierstokes_tpu.models.navier_stokes import NavierStokes
        return NavierStokes
    raise AttributeError(name)
