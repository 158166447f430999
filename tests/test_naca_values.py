"""Value-level NACA 2408 sweep validation (VERDICT r2 item 7).

The committed sweep artifacts (artifacts/naca_sweep/output_<angle>.csv,
produced by the `sweep-naca` CLI in an earlier round) are
checked against thin-airfoil theory: the lift-curve slope of a 2D airfoil
is 2*pi/rad inviscid; at the sweep's Re = U*c/nu = 1.0*0.4/1e-3 = 400 the
viscous (decambering + thick-BL) correction reduces it to ~55-100% of
that, and the camber (NACA 2408: 2% camber -> alpha_0 ~ -2 deg) makes
Cl(0) > 0 but below the inviscid 2*pi*|alpha_0| bound.

Reference behavior: tests/2D/test_naca/run_test.sh produces exactly these
per-angle force curves (uniform inlet U=1.0, chord 0.4 — the reference's
Diameter=0.4 normalization IS the chord here, so printed Cl is the
standard convention).
"""

import csv
import math
import os

import numpy as np
import pytest

ART = os.path.join(os.path.dirname(__file__), "..", "artifacts",
                   "naca_sweep")


def _final_cl(angle):
    path = os.path.join(ART, f"output_{angle}.csv")
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return float(rows[-1]["Cl"])


@pytest.mark.skipif(not os.path.isdir(ART), reason="sweep artifacts absent")
def test_naca_lift_slope_vs_thin_airfoil():
    angles = np.array([0.0, 2.0, 4.0, 8.0])
    cl = np.array([_final_cl(int(a)) for a in angles])

    # monotone increasing below stall
    assert np.all(np.diff(cl) > 0), cl

    # linear fit: slope per degree
    A = np.vstack([angles, np.ones_like(angles)]).T
    (slope, cl0), res, _, _ = np.linalg.lstsq(A, cl, rcond=None)
    two_pi_per_deg = 2.0 * math.pi * math.pi / 180.0      # 0.1097 / deg
    assert 0.55 * two_pi_per_deg < slope < 1.0 * two_pi_per_deg, slope

    # linearity below stall (R^2)
    ss_tot = ((cl - cl.mean()) ** 2).sum()
    r2 = 1.0 - float(res[0]) / ss_tot
    assert r2 > 0.98, r2

    # camber lift at zero AoA: positive, below the inviscid bound
    # 2*pi*alpha_0 with alpha_0 ~ 2.07 deg for 2% camber at 40% chord
    assert 0.0 < cl0 < 2.0 * math.pi * math.radians(2.5), cl0
