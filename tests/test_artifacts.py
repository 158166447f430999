"""Sanity assertions over committed scenario traces (artifacts/).

The reference validates its scenario drivers by eyeballing
forces_vs_time.csv plots (analysis/plot_coefficients.ipynb); here every
committed campaign trace gets an automated check: finite tail, physically
plausible coefficient ranges, and monotone time.  Each test skips if its
artifact has not been produced yet (the campaign runs on an accelerator,
scripts/run_scenarios.py).

Reference counterparts: tests/{2,3}D/test_0{2,3}/src/*.cpp and
mesh/domain3D2.geo.
"""

import os

import numpy as np
import pytest

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts")

# name -> (cd_lo, cd_hi, cl_absmax, pulsating) in the REFERENCE
# normalization the scenario actually runs (registry re/mean conventions;
# loose bands — the point is "physically plausible and finite", not
# benchmark accuracy).  Pulsating drivers normalize by the INSTANTANEOUS
# mean velocity (reference get_mean_vel carries sin(pi t/8),
# tests/2D/test_03/src/test_03.cpp:41-44), so the printed Cd/Cl blow up
# as sin -> 0 at t -> 0, 8 BY CONSTRUCTION — exactly as the reference's
# own output does.  Their statistics therefore mask |sin| < 0.2; the raw
# Drag/Lift columns are checked unmasked.
CASES = {
    "scenario_2d-test3.csv": (0.0, 50.0, 60.0, True),
    # 3D Re=100 square column (reference tests/3D/test_02)
    "scenario_3d-test2.csv": (0.5, 15.0, 10.0, False),
    # 3D pulsating (reference tests/3D/test_03)
    "scenario_3d-test3.csv": (0.0, 50.0, 60.0, True),
    # 3D circular cylinder duct at true Re=5 ("Re=20" reference quirk)
    "scenario_3d-cylinder.csv": (0.5, 30.0, 10.0, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_scenario_trace(name):
    path = os.path.join(ART, name)
    if not os.path.exists(path):
        pytest.skip(f"{name} not produced yet (run scripts/run_scenarios.py)")
    d = np.genfromtxt(path, delimiter=",", names=True)
    assert len(d) >= 50, "trace too short to be a real run"
    t = d["time"]
    assert np.all(np.diff(t) > 0), "time not monotone"
    lo, hi, clmax, pulsating = CASES[name]
    tail = d[int(0.6 * len(d)):]
    for col in ("Drag", "Lift"):
        assert np.isfinite(tail[col]).all(), f"{col} has non-finite entries"
    assert float(np.max(np.abs(tail["Drag"]))) < 1e3
    if pulsating:
        tail = tail[np.abs(np.sin(np.pi * tail["time"] / 8.0)) >= 0.2]
    for col in ("Cd", "Cl"):
        assert np.isfinite(tail[col]).all(), f"{col} has non-finite entries"
    cd_mean = float(np.mean(tail["Cd"]))
    assert lo <= cd_mean <= hi, f"tail mean Cd {cd_mean} outside [{lo},{hi}]"
    assert float(np.max(np.abs(tail["Cl"]))) <= clmax


def test_2d2_dt_convergence_traces():
    """Regression caps over the committed Schaefer-Turek 2D-2 dt-study
    traces (VALIDATION.md).  The Cd_max band here (3.20-3.25) is a
    slightly LOOSENED regression cap around the published interval
    3.22-3.24 — it guards the committed traces against code regressions
    without flaking on the ~0.5% run-to-run spread; the published-band
    claims themselves live in VALIDATION.md with the exact per-trace
    values.  Cl_max is checked against the recorded dt-convergence values
    (non-monotone in dt — BDF2 temporal dissipation damps the shedding
    amplitude; see VALIDATION).  St must sit inside the published
    interval at every committed dt.
    Reference counterpart: tests/2D/test_02/src/test_02.cpp:57-58."""
    # name -> (cd_cap_hi, cl_cap): regression caps around each committed
    # trace's measured (Cd_max, Cl_max) — the (h, dt)-refinement study
    # spans 3.217-3.252 / 1.017-1.085 (VALIDATION.md: the projection
    # scheme's time-converged lift amplitude sits ABOVE the published
    # band and the monolithic path below it; these caps freeze each
    # committed trace, they are not the published intervals)
    cases = {
        "st_2d2_projection_bdf2_h015_dt00125.csv": (3.25, 1.03),
        "st_2d2_projection_bdf2_h015_dt0000625.csv": (3.25, 1.06),
        "st_2d2_projection_bdf2_h0125_dt00125.csv": (3.25, 1.03),
        "st_2d2_projection_bdf2_h0125_dt0000625.csv": (3.26, 1.10),
        "st_2d2_monolithic_h015_dt00125.csv": (3.24, 1.045),
        "st_2d2_monolithic_h015_dt0000625.csv": (3.24, 1.035),
        # the three-way in-band runs at dt=0.0003125 — BOTH schemes sit
        # inside all three published intervals simultaneously:
        # projection BDF2: Cd_max 3.2269 / Cl_max 0.9965 / St 0.3002
        # monolithic BDF1: Cd_max 3.2333 / Cl_max 1.0090 / St 0.3002
        "st_2d2_projection_bdf2_h015_dt00003125.csv": (3.24, 1.01),
        "st_2d2_monolithic_h015_dt00003125.csv": (3.24, 1.01),
    }
    u_mean = 2.0 * 1.5 / 3.0
    for name, (cd_cap, cl_cap) in cases.items():
        path = os.path.join(ART, name)
        if not os.path.exists(path):
            pytest.skip(f"{name} not produced yet")
        d = np.genfromtxt(path, delimiter=",", names=True)
        t = d["time"]
        m = t > 0.6 * t[-1]
        cd_max = float(d["Cd"][m].max())
        cl_max = float(d["Cl"][m].max())
        assert 3.20 <= cd_max <= cd_cap, (name, cd_max)
        assert 0.95 <= cl_max <= cl_cap, (name, cl_max)
        # Strouhal from the mean upward-zero-crossing period of Cl; the
        # strict-inequality pair counts a sample landing exactly on 0
        # once (sign-diff > 0 would count it twice and skew the period).
        # A crossing is a period boundary only if Cl then climbs to a
        # real shedding peak (>= 0.5 max) before the next crossing —
        # small positive wiggles during the negative phase (the
        # monolithic Picard path brushes +0.003 mid-period) otherwise
        # inject spurious boundaries that split real periods.
        y = d["Cl"][m]
        tt = t[m]
        s = np.where((y[:-1] < 0) & (y[1:] >= 0))[0]
        assert len(s) >= 3, "too few shedding periods in the tail"
        peak = 0.5 * float(y.max())
        real = [i for i in range(len(s) - 1)
                if float(y[s[i]:s[i + 1]].max()) >= peak]
        valid = [s[i] for i in real] + [s[real[-1] + 1]]
        st = 0.1 / (float(np.diff(tt[valid]).mean()) * u_mean)
        assert 0.295 <= st <= 0.305, (name, st)
