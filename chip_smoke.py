"""Smoke run of the solver's main path on a GPU.

One process drives the card; only nvidia-smi runs as a child.  Phases, in
order, each printing one line of findings; any failure exits non-zero:

  device  JAX must report a GPU; prints the card's name and power limit.
  parity  a small cylinder channel, on the GPU and on the CPU backend of
          this process: 5 projection BDF2 steps and 2 monolithic
          Cahouet-Chabard steps with 2 compensated (df32) refinement
          passes, u/p/Cd/Cl compared.
  df32    the error-free transforms of ops/df32.py, compiled for the card,
          against numpy float64.
  main    the bench configuration (bench.py: 2D-2, Re=100, 1,014,414 DoF,
          projection BDF2, dt=0.00125, fp32) through setup()/solve() for
          64 steps with CSV, VTU and checkpoints; a restart from step 32
          that must reproduce steps 33-64; then 3 monolithic steps.
  3d      the 3d-test1 scenario (square column, Re=20) through the
          scenario registry, 2 steps.

With ``--devices N`` only the sharded path runs: the bench configuration
for 16 steps on N devices (GSPMD row-sharded BSR) against one device.

Every program runs at the package's matmul precision ("highest",
navierstokes_tpu/utils/runtime.py).  A failed phase is reported and the
rest still run; the exit code is then 1 and no result line is printed.
Otherwise the last line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.

Usage: python chip_smoke.py [--devices N]
"""

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

import bench

# Two runs of the same fp32 program that differ only in the order of their
# sums (two backends, atomics, a restart, a sharded reduction) may differ
# in u and p, in relative L2, by FIELD_TOL = 10x the projection sub-solves'
# tolerance (config.py proj_tol=1e-4).  The monolithic parity pair adds two
# compensated refinement passes (solvers/refine.py), so its solves leave
# no fp32 residual floor and what remains is the operator's own fp32
# rounding times the saddle system's conditioning: on one CPU, such a run
# and an fp64 one differ by 2.8e-4 in p after 2 steps (7.6e-4 without the
# refinement), inside the same bound.  Cd and Cl may differ by FORCE_TOL
# of the magnitude of (Cd, Cl) (Cl alone is ~0 in a symmetric start-up,
# so its own relative error means nothing).
FIELD_TOL = 1e-3
FORCE_TOL = 1e-3


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def force_err(cd_a, cl_a, cd_b, cl_b):
    """Largest Cd/Cl difference (scalars or per-step arrays) relative to
    the largest |(Cd, Cl)| of the reference."""
    cd_a, cl_a, cd_b, cl_b = (np.asarray(x, np.float64)
                              for x in (cd_a, cl_a, cd_b, cl_b))
    scale = max(float(np.max(np.hypot(cd_b, cl_b))), 1e-30)
    return float(max(np.max(np.abs(cd_a - cd_b)),
                     np.max(np.abs(cl_a - cl_b))) / scale)


def compare(phase, label, a, b):
    """a, b: (u, p, cd, cl).  Returns the summary text; raises on excess."""
    eu, ep = rel_l2(a[0], b[0]), rel_l2(a[1], b[1])
    ef = force_err(a[2], a[3], b[2], b[3])
    text = (f"{label}: u {eu:.2e} p {ep:.2e} (tol {FIELD_TOL:.0e}), "
            f"Cd/Cl {ef:.2e} (tol {FORCE_TOL:.0e})")
    check(eu <= FIELD_TOL and ep <= FIELD_TOL and ef <= FORCE_TOL,
          f"{phase} {text}")
    return text


def peak_bytes(device):
    return device.memory_stats()["peak_bytes_in_use"]


def history(ns):
    """Concatenated per-step metrics of the last solve(), as numpy."""
    keys = ("time", "iterations", "residual", "cd", "cl", "converged")
    return {k: np.concatenate([np.atleast_1d(getattr(m, k))
                               for m in ns.history]) for k in keys}


def phase_device(n_devices):
    import jax
    dev = bench.require_gpu()
    devs = jax.devices()
    check(len(devs) >= n_devices,
          f"device: {n_devices} devices asked for, JAX sees {len(devs)}")
    for line in bench.card_lines():
        print(line, flush=True)
    say("device", f"platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)} jax={jax.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    return dev


def run_small(device, scheme, n_steps, tmp, h=0.05, **cfg):
    """n_steps of a small Re=100 cylinder channel on ``device``, through
    setup()/solve(); returns (u, p, cd, cl) at the end."""
    import jax

    from navierstokes_tpu.config import InletConfig
    from navierstokes_tpu.mesh import channel_with_cylinder_2d
    from navierstokes_tpu.models.navier_stokes import NavierStokes

    dt = 0.005
    out = os.path.join(tmp, f"{device.platform}{device.id}_{scheme}")
    with jax.default_device(device):
        ns = NavierStokes(channel_with_cylinder_2d(h=h), 2, 1, deltat=dt,
                          T=n_steps * dt, step=n_steps,
                          inlet=InletConfig(kind="parabolic", u_m=1.5,
                                            height=0.41),
                          config=bench.bench_config(out, scheme=scheme,
                                                    **cfg))
        ns.set_re_number(100)
        ns.setup()
        ns.solve()
        u, p = np.asarray(ns._u), np.asarray(ns._p)
    hist = history(ns)
    check(hist["converged"].all(),
          f"parity: {scheme} on {device.platform} did not converge "
          f"(iterations {hist['iterations'].tolist()})")
    return u, p, ns.cd, ns.cl


def phase_parity(dev, ref, tmp, h=0.05):
    """The small problem on ``dev`` against the same on ``ref``."""
    texts = []
    for scheme, n_steps, refine in (("projection", 5, 0),
                                    ("monolithic", 2, 2)):
        a = run_small(dev, scheme, n_steps, tmp, h, refine=refine)
        b = run_small(ref, scheme, n_steps, tmp, h, refine=refine)
        texts.append(compare("parity", f"{scheme} x{n_steps} refine="
                             f"{refine}", a, b))
    say("parity", f"{dev.platform} vs {ref.platform}, h={h}, matmul "
        f"precision highest: " + "; ".join(texts))


def phase_df32(device):
    """ops/df32.py on ``device``, jitted (fused, as refine runs it),
    checked against float64 as tests/test_df32.py does."""
    import jax
    import jax.numpy as jnp

    from navierstokes_tpu.ops import df32

    rng = np.random.default_rng(0)
    put = lambda x: jax.device_put(jnp.asarray(x, jnp.float32), device)
    f64 = lambda x: np.asarray(x, np.float64)
    n = 4096
    a, b = put(rng.standard_normal(n)), put(rng.standard_normal(n) * 1e-6)
    s, e = jax.jit(df32.two_sum)(a, b)
    sum_ok = np.array_equal(f64(s) + f64(e), f64(a) + f64(b))
    b = put(rng.standard_normal(n))
    p, e = jax.jit(df32.two_prod)(a, b)
    prod_bad = int(np.sum(f64(p) + f64(e) != f64(a) * f64(b)))

    a64, b64 = rng.standard_normal(n), rng.standard_normal(n)
    b64[n // 2:] = -(a64[:n // 2] * b64[:n // 2])[::-1] / a64[n // 2:]
    a, b = put(a64), put(b64)
    exact = float(np.dot(f64(a), f64(b)))
    hi, lo = jax.jit(df32.df_dot)(a, b)
    dot_err = abs(float(hi) + float(lo) - exact) / float(
        np.sum(np.abs(f64(a) * f64(b))))

    vals64 = rng.standard_normal((32, 16, 128))
    x64 = rng.standard_normal((32, 128))
    (vh, vl), (xh, xl) = df32.df_from_f64(vals64), df32.df_from_f64(x64)
    hi, lo = jax.jit(df32.df_matvec_flat)(put(vh), put(xh), put(xl),
                                          put(vl))
    scale = np.abs(vals64 * x64[:, None, :]).sum(-1).max()
    mv_err = float(np.abs(f64(hi) + f64(lo) - np.einsum(
        "nbc,nc->nb", vals64, x64)).max() / scale)
    text = (f"on {device.platform}: two_sum exact={sum_ok}, two_prod "
            f"inexact={prod_bad}/{n}, df_dot err {dot_err:.2e} (tol 1e-12), "
            f"df_matvec_flat err {mv_err:.2e} (tol 1e-11)")
    check(sum_ok and prod_bad == 0 and dot_err <= 1e-12 and mv_err <= 1e-11,
          f"df32 {text}")
    say("df32", text)


def bench_solver(tmp, n_steps, output_step, **cfg):
    from navierstokes_tpu.models.navier_stokes import NavierStokes
    ns = NavierStokes(bench.build_mesh(), 2, 1, deltat=bench.DT,
                      T=n_steps * bench.DT, step=output_step,
                      inlet=bench.bench_inlet(),
                      config=bench.bench_config(tmp, **cfg))
    ns.set_re_number(100)
    t0 = time.perf_counter()
    ns.setup()
    return ns, time.perf_counter() - t0


def check_run(phase, ns, max_iters):
    """Finite fields, converged solves under their iteration caps."""
    hist = history(ns)
    check(np.isfinite(np.asarray(ns._u)).all()
          and np.isfinite(np.asarray(ns._p)).all()
          and np.isfinite(hist["cd"]).all(), f"{phase}: non-finite fields")
    bad = np.flatnonzero(~hist["converged"])
    check(bad.size == 0,
          f"{phase}: unconverged steps {(bad + 1).tolist()} with "
          f"iterations {hist['iterations'][bad].tolist()} and residuals "
          f"{hist['residual'][bad].tolist()}")
    check(hist["iterations"].max() < max_iters,
          f"{phase}: iterations {hist['iterations'].max()} at the cap "
          f"{max_iters}")
    return hist


def phase_main(tmp):
    import jax

    n_steps, out_every = 64, 32
    ns, setup_s = bench_solver(os.path.join(tmp, "main"), n_steps, out_every)
    cfg = ns.config
    t0 = time.perf_counter()
    ns.solve()
    first_s = time.perf_counter() - t0
    hist = check_run("main", ns,
                     cfg.proj_f_maxiter + cfg.proj_p_maxiter)
    u1, p1 = np.asarray(ns._u), np.asarray(ns._p)
    cfl = ns.measured_cfl()
    files = sorted(os.listdir(cfg.output_dir)) + sorted(
        os.listdir(cfg.cache_dir))
    check(any(f.endswith(".vtu") for f in files)
          and any("32" in f and f.endswith(".npz") for f in files)
          and os.path.getsize(cfg.csv_path) > 0,
          f"main: missing outputs {files}")

    t0 = time.perf_counter()
    ns.solve(time_step=32, csv_path=os.path.join(tmp, "main", "re.csv"))
    restart_s = time.perf_counter() - t0
    hist_r = check_run("main restart", ns,
                       cfg.proj_f_maxiter + cfg.proj_p_maxiter)
    bitwise = (np.array_equal(np.asarray(ns._u), u1)
               and np.array_equal(np.asarray(ns._p), p1))
    restart = compare("main", "restart 33-64 vs continuous",
                      (ns._u, ns._p, hist_r["cd"], hist_r["cl"]),
                      (u1, p1, hist["cd"][32:], hist["cl"][32:]))
    peak = peak_bytes(jax.devices()[0])
    cd, cl = float(hist["cd"][-1]), float(hist["cl"][-1])
    check(cfl < 2.5, f"main: measured CFL {cfl:.3f} >= 2.5")
    # t = 0.08 s, just past the 0.05 s inlet ramp: the start-up drag of
    # the committed h=0.015 trace (artifacts/) is Cd 2.40, Cl -0.013
    check(1.5 < cd < 4.0 and abs(cl) < 0.1,
          f"main: Cd {cd:.4f} / Cl {cl:.4f} outside 1.5<Cd<4, |Cl|<0.1")

    ns_m, setup_m = bench_solver(os.path.join(tmp, "mono"), 3, 3,
                                 scheme="monolithic")
    t0 = time.perf_counter()
    ns_m.solve()
    mono_s = time.perf_counter() - t0
    hist_m = check_run("main monolithic", ns_m,
                       ns_m.config.outer_maxiter)
    say("main", f"{ns.space.n_dofs} DoF; setup {setup_s:.1f} s; 64 steps "
        f"incl. first compile {first_s:.1f} s; restart steps 33-64 "
        f"{restart_s:.2f} s = {1e3 * restart_s / 32:.1f} ms/step "
        f"(host output included); bitwise restart {bitwise}; {restart}; "
        f"peak {peak / 2**30:.2f} GiB; iterations "
        f"{hist['iterations'].min()}-{hist['iterations'].max()}; CFL "
        f"{cfl:.3f}; Cd {cd:.5f} Cl {cl:.5f}; monolithic x3 (setup "
        f"{setup_m:.1f} s, run {mono_s:.1f} s): iterations "
        f"{hist_m['iterations'].tolist()}, Cd {float(hist_m['cd'][-1]):.5f}")


def phase_3d(tmp, h=0.04):
    from navierstokes_tpu.config import SolverConfig
    from navierstokes_tpu.scenarios.registry import build_solver

    out = os.path.join(tmp, "3d")
    cfg = SolverConfig(output_dir=os.path.join(out, "output"),
                       cache_dir=os.path.join(out, "cache"),
                       csv_path=os.path.join(out, "forces.csv"),
                       n_devices=1)
    ns = build_solver("3d-test1", h=h, config=cfg, output_step=2)
    ns.config.t_final = 2 * ns.config.deltat
    t0 = time.perf_counter()
    ns.setup()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ns.solve()
    run_s = time.perf_counter() - t0
    hist = check_run("3d", ns, cfg.outer_maxiter)
    say("3d", f"3d-test1 h={h}: {ns.space.n_dofs} DoF; setup {setup_s:.1f} "
        f"s; 2 steps incl. compile {run_s:.1f} s; iterations "
        f"{hist['iterations'].tolist()}; Cd {ns.cd:.5f} Cl {ns.cl:.5f}")


def phase_devices(n, tmp, n_steps=16):
    """The bench configuration sharded over n devices against one."""
    import jax

    runs = {}
    for nd in (n, 1):
        ns, setup_s = bench_solver(os.path.join(tmp, f"dev{nd}"), n_steps,
                                   n_steps, n_devices=nd)
        t0 = time.perf_counter()
        ns.solve()
        hist = check_run(f"devices {nd}", ns,
                         ns.config.proj_f_maxiter + ns.config.proj_p_maxiter)
        runs[nd] = (ns, hist, setup_s, time.perf_counter() - t0)
        if nd == n:
            sharded = ns.ell.f_cols.sharding.device_set
            check(sharded == set(jax.devices()[:n]),
                  f"devices: F graph sits on {sharded}, not on all {n}")
            peaks = [peak_bytes(d) for d in jax.devices()[:n]]
            check(min(peaks) > 0.2 * max(peaks),
                  f"devices: lopsided peak memory {peaks}")
    (ns_n, h_n, su_n, run_n), (ns_1, h_1, su_1, run_1) = runs[n], runs[1]
    text = compare("devices", f"{n} devices vs 1",
                   (ns_n._u, ns_n._p, h_n["cd"][-1], h_n["cl"][-1]),
                   (ns_1._u, ns_1._p, h_1["cd"][-1], h_1["cl"][-1]))
    say(f"devices {n}", f"{ns_n.space.n_dofs} DoF x{n_steps} steps; {text}; "
        f"setup {su_n:.1f}/{su_1:.1f} s, run incl. compile {run_n:.1f}/"
        f"{run_1:.1f} s; peak GiB per device " + ", ".join(
            f"{p / 2**30:.2f}" for p in peaks) + f"; iterations {n} dev "
        f"{h_n['iterations'].tolist()} / 1 dev {h_1['iterations'].tolist()}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="run only the sharded phase on this many devices")
    args = ap.parse_args(argv)

    import jax

    from navierstokes_tpu.utils.runtime import configure_compile_cache

    dev = phase_device(args.devices)
    configure_compile_cache()
    failed = []
    with tempfile.TemporaryDirectory(prefix="nstpu_smoke_") as tmp:
        if args.devices > 1:
            phases = [("devices", lambda: phase_devices(args.devices, tmp))]
        else:
            phases = [("parity", lambda: phase_parity(
                          dev, jax.devices("cpu")[0], tmp)),
                      ("df32", lambda: phase_df32(dev)),
                      ("main", lambda: phase_main(tmp)),
                      ("3d", lambda: phase_3d(tmp))]
        for name, fn in phases:
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:       # report it, run the other phases
                traceback.print_exc()
                failed.append(name)
            say(name, f"{'FAILED' if name in failed else 'ok'}, wall "
                f"{time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"FAILED phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
