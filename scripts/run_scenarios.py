"""Scenario campaign driver (VERDICT round-2 item 5).

Runs the previously-unexercised scenario drivers end-to-end on the
attached accelerator, archives each forces csv under artifacts/, and prints a
tail summary (mean/max Cd, Cl over the last 40%) per run.  Each run is
a subprocess of the production CLI — the same entry point a user runs —
bounded by a wall-clock timeout.

Usage:
    python scripts/run_scenarios.py [name ...]
Default campaign: 2d-test3 (full T=8 pulsation period), 3d-test2,
3d-test3 (full period), 3d-cylinder.

Reference counterparts: tests/{2,3}D/test_0{2,3}/src/*.cpp and
mesh/domain3D2.geo in /root/reference (scenario params mirrored in
navierstokes_tpu/scenarios/registry.py).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> (extra CLI args, timeout_s).  All run the production projection
# scheme (the validated fast path, VALIDATION.md); the monolithic
# reference-parity path is exercised by the bench side-measurement and
# the 2d validation runs.
CAMPAIGN = {
    "2d-test3": (["--T", "8.0", "--scheme", "projection"], 5400),
    "3d-test2": (["--scheme", "projection"], 5400),
    "3d-test3": (["--T", "8.0", "--scheme", "projection"], 10800),
    "3d-cylinder": (["--scheme", "projection"], 5400),
}


def tail_stats(csv_path, pulsating=False):
    d = np.genfromtxt(csv_path, delimiter=",", names=True)
    n = len(d)
    tail = d[int(0.6 * n):]
    if pulsating:
        # instantaneous-mean normalization (reference get_mean_vel carries
        # sin(pi t/8)): Cd/Cl -> inf as sin -> 0 by construction; mask
        tail = tail[np.abs(np.sin(np.pi * tail["time"] / 8.0)) >= 0.2]
    return dict(
        rows=n,
        t_last=round(float(d["time"][-1]), 4),
        cd_tail_mean=round(float(np.mean(tail["Cd"])), 4),
        cd_tail_max=round(float(np.max(tail["Cd"])), 4),
        cl_tail_mean=round(float(np.mean(tail["Cl"])), 5),
        cl_tail_absmax=round(float(np.max(np.abs(tail["Cl"]))), 5),
        finite=bool(np.isfinite(tail["Cd"]).all()
                    and np.isfinite(tail["Cl"]).all()),
    )


def main():
    names = sys.argv[1:] or list(CAMPAIGN)
    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    summary = {}
    for name in names:
        extra, tmo = CAMPAIGN.get(name, ([], 5400))
        workdir = f"/tmp/campaign/{name}"
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir, exist_ok=True)
        csv = os.path.join(workdir, "forces.csv")
        cmd = [sys.executable, "-u", "-m", "navierstokes_tpu.scenarios.cli",
               "run", name,
               "--output-dir", os.path.join(workdir, "out"),
               "--cache-dir", os.path.join(workdir, "cache"),
               "--csv", csv] + extra
        print(f"=== {name}: {' '.join(cmd[3:])}", flush=True)
        r = subprocess.run(cmd, cwd=ROOT, timeout=tmo,
                           stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        tail = "\n".join(r.stdout.strip().splitlines()[-6:])
        print(tail, flush=True)
        if r.returncode != 0:
            summary[name] = dict(rc=r.returncode)
            print(f"{name}: FAILED rc={r.returncode}", flush=True)
            continue
        dst = os.path.join(ROOT, "artifacts", f"scenario_{name}.csv")
        shutil.copyfile(csv, dst)
        summary[name] = dict(rc=0, **tail_stats(dst, "test3" in name))
        print(f"{name}: {summary[name]}", flush=True)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
