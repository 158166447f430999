"""Schaefer-Turek benchmark regression on a GPU (long-running).

Asserts the published coefficient intervals, with a small slack for the
moderate meshes.  Runs only where JAX finds a GPU (see tests/conftest.py
for the command)."""

import pytest

pytestmark = pytest.mark.chip


def test_st_2d1_coefficients(gpu, tmp_path):
    from navierstokes_tpu.config import InletConfig, SolverConfig
    from navierstokes_tpu.mesh import channel_with_cylinder_2d
    from navierstokes_tpu.models.navier_stokes import NavierStokes
    from navierstokes_tpu.utils.analysis import load_forces

    csv = str(tmp_path / "forces.csv")
    mesh = channel_with_cylinder_2d(h=0.012, h_near=0.004)
    inlet = InletConfig(kind="parabolic", u_m=0.3, height=0.41)
    cfg = SolverConfig(nu=1e-3, ref_length=0.1, force_formula="st",
                       output_dir=str(tmp_path / "o"),
                       cache_dir=str(tmp_path / "c"), csv_path=csv)
    ns = NavierStokes(mesh, 2, 1, deltat=0.01, T=4.0, step=400, inlet=inlet,
                      config=cfg)
    ns.setup()
    ns.solve()

    df = load_forces(csv)
    tail = df.iloc[int(len(df) * 0.75):]
    cd = float(tail["Cd"].mean())
    cl = float(tail["Cl"].mean())
    # published: Cd 5.57-5.59, Cl 0.0104-0.0110; allow ~1.5% mesh slack
    assert 5.48 < cd < 5.68, cd
    assert -0.01 < cl < 0.03, cl


def test_st_2d2_projection_coefficients(gpu, tmp_path):
    """Validated production configuration (VALIDATION.md bolded row):
    BDF2 projection, h=0.015 + wake band, dt=0.00125 -> Cd_max 3.224,
    Cl_max 1.019, St 0.300."""
    from navierstokes_tpu.config import InletConfig, SolverConfig
    from navierstokes_tpu.mesh import channel_with_cylinder_2d
    from navierstokes_tpu.models.navier_stokes import NavierStokes
    from navierstokes_tpu.utils.analysis import load_forces, strouhal

    csv = str(tmp_path / "forces.csv")
    mesh = channel_with_cylinder_2d(h=0.015, h_near=0.005, wake_levels=1)
    inlet = InletConfig(kind="parabolic", u_m=1.5, height=0.41)
    cfg = SolverConfig(nu=1e-3, ref_length=0.1, force_formula="st",
                       scheme="projection",
                       output_dir=str(tmp_path / "o"),
                       cache_dir=str(tmp_path / "c"), csv_path=csv)
    ns = NavierStokes(mesh, 2, 1, deltat=0.00125, T=8.0, step=1600,
                      inlet=inlet, config=cfg)
    ns.setup()
    ns.solve()

    df = load_forces(csv)
    tail = df.iloc[int(len(df) * 0.6):]
    cd_max = float(tail["Cd"].max())
    cl_max = float(tail["Cl"].max())
    st = strouhal(csv, ref_length=0.1, u_mean=1.0)
    # published: 3.22-3.24 / 0.99-1.01 / 0.295-0.305 (+ small mesh slack)
    assert 3.20 < cd_max < 3.27, cd_max
    assert 0.95 < cl_max < 1.07, cl_max
    assert 0.29 < st < 0.31, st
