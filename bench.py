"""Headline benchmark: time steps per second, 2D-2 cylinder at ~1M DoF.

Configuration: the Schaefer-Turek 2D-2 scenario (Re=100, parabolic inlet
U_m=1.5, nu=1e-3, Cd/Cl normalized by D=0.1 and the mean inlet velocity)
on the committed 1,014,414-DoF mesh (``.bench_mesh.npz``), the production
projection scheme (rotational incremental pressure-correction, BDF2 +
extrapolated convection) at dt=0.00125, fp32, one GPU.  The dt lies in the
physics-validated family (VALIDATION.md: this scheme and mesh family give
Cd_max 3.224 / Cl_max 1.019 / St 0.300 at dt=0.00125).  A raised-cosine
inlet ramp over the first 40 steps removes the impulsive-start iteration
spike, so the measured window, past it, reflects the running scheme.  The
reference-parity monolithic path is timed as well and reported on stderr.

Steps run as ``CHUNK``-step scans, as ``NavierStokes.solve`` runs them.
Compilation and the warm-up chunks are set-up; the window is one chunk,
timed to ``block_until_ready``.  ``hbm_frac`` divides XLA's post-fusion
"bytes accessed" estimate of a one-step program by the window's time per
step and the card's published HBM peak.  XLA counts each Krylov loop body
once, whatever its trip count, so this is a lower bound of the traffic.

vs_baseline: the reference publishes no numbers (BASELINE.md).  We compare
against an estimated 0.125 steps/s for the deal.II/Trilinos reference at
1M DoF on a single CPU node.

Needs a GPU that ``PEAKS`` knows; fails on any other device.  Prints ONE
JSON line on stdout; progress goes to stderr.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

DEALII_BASELINE_STEPS_PER_SEC = 0.125
DT = 0.00125
CHUNK = 16
WARMUP_CHUNKS = 3        # 48 steps: past the 40-step inlet ramp
MONO_WARMUP_STEPS = 5
MONO_STEPS = 10

# Published peaks per device_kind (NVIDIA H100 SXM5 data sheet: dense
# rates at the 700 W power limit; fp32 without tensor cores).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops": 67e12,
                              "bf16_flops": 989e12},
}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def peaks_for(device_kind: str) -> dict:
    """Peak rates of a device; a device missing from PEAKS is an error."""
    if device_kind not in PEAKS:
        raise ValueError(f"no published peaks for device_kind "
                         f"{device_kind!r}; add it to bench.PEAKS")
    return PEAKS[device_kind]


def require_gpu():
    """The first JAX device, which must be a GPU; exits otherwise."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX reports platform {dev.platform!r} "
                         f"({dev.device_kind}); this run needs a GPU")
    return dev


def card_lines() -> list[str]:
    """Name and power limit of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def build_mesh():
    """The ~1M-DoF cylinder-channel mesh, generated once and committed."""
    import numpy as np

    from navierstokes_tpu.mesh import channel_with_cylinder_2d
    from navierstokes_tpu.mesh.geometry import Mesh

    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_mesh.npz")
    if os.path.exists(cache):
        z = np.load(cache)
        return Mesh(2, z["points"], z["cells"], z["bfaces"], z["btags"])
    h = 0.0037
    log(f"generating bench mesh (h={h}) ...")
    mesh = channel_with_cylinder_2d(h=h, h_near=h / 2)
    np.savez(cache, points=mesh.points, cells=mesh.cells,
             bfaces=mesh.boundary_faces, btags=mesh.boundary_tags)
    return mesh


def bench_inlet():
    from navierstokes_tpu.config import InletConfig
    # ramp: raised-cosine inlet start-up over the first 40 steps
    return InletConfig(kind="parabolic", u_m=1.5, height=0.41, ramp=0.05)


def bench_config(out_dir: str, **overrides):
    """The bench SolverConfig, writing its outputs under ``out_dir``.
    nu=1e-3 / ref_length=0.1 / force_formula="st": the Schaefer-Turek 2D-2
    normalization of the validation runs (VALIDATION.md)."""
    from navierstokes_tpu.config import SolverConfig
    kw = dict(dtype="float32", nu=1.0e-3, ref_length=0.1,
              force_formula="st", scheme="projection", proj_bdf2=True,
              outer_maxiter=128, n_devices=1,
              output_dir=os.path.join(out_dir, "output"),
              cache_dir=os.path.join(out_dir, "cache"),
              csv_path=os.path.join(out_dir, "forces.csv"))
    kw.update(overrides)
    return SolverConfig(**kw)


def _timed_chunks(run, params, state, n_chunks):
    """Run ``n_chunks`` chunks from ``state``; returns (state, metrics of
    the last chunk, wall seconds to block_until_ready)."""
    import jax
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        *state, ms = run(params, *state)
    jax.block_until_ready((state, ms))
    return state, ms, time.perf_counter() - t0


def main():
    import jax

    from navierstokes_tpu.utils.runtime import configure_compile_cache

    dev = require_gpu()
    peaks = peaks_for(dev.device_kind)
    cards = card_lines()
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}; "
        f"card: {'; '.join(cards)}")
    configure_compile_cache()

    with tempfile.TemporaryDirectory(prefix="nstpu_bench_") as out_dir:
        result = _run(out_dir, peaks)
    result.update(device={"platform": dev.platform, "kind": dev.device_kind,
                          "count": len(jax.devices())}, card=cards)
    print(json.dumps(result))


def _run(out_dir, peaks):
    """The measured run; returns the result fields."""
    import jax.numpy as jnp

    from navierstokes_tpu.models.navier_stokes import NavierStokes
    from navierstokes_tpu.utils.profiling import flop_estimate

    ns = NavierStokes(build_mesh(), 2, 1, deltat=DT, T=1.0, step=CHUNK,
                      inlet=bench_inlet(), config=bench_config(out_dir))
    ns.set_re_number(100)
    t0 = time.perf_counter()
    ns.setup()
    setup_s = time.perf_counter() - t0
    n_dofs = ns.space.n_dofs
    ns._init_state(0)
    params = ns._params()
    run = ns._chunk_fn(CHUNK)
    state = [ns._u, ns._p, ns._u_prev, ns._phi, jnp.asarray(0.0, ns.dtype)]
    cost = flop_estimate(ns._chunk_fn(1), params, *state)

    state, ms, warm_s = _timed_chunks(run, params, state, WARMUP_CHUNKS)
    log(f"setup {setup_s:.1f} s; warm-up {WARMUP_CHUNKS * CHUNK} steps "
        f"incl. compile {warm_s:.1f} s")
    state, ms, wall = _timed_chunks(run, params, state, 1)
    steps_per_sec = CHUNK / wall
    cfl = ns.measured_cfl(state[0])
    log(f"measured: {CHUNK} steps in {wall:.4f} s -> {steps_per_sec:.4f} "
        f"steps/s; iters {[int(i) for i in ms.iterations]}; "
        f"Cd={float(ms.cd[-1]):.4f} Cl={float(ms.cl[-1]):.4f}; "
        f"CFL {cfl:.3f}")
    bytes_per_step = cost["bytes accessed"]
    flops_per_step = cost["flops"]
    hbm_frac = bytes_per_step * steps_per_sec / peaks["hbm_bytes_per_s"]
    log(f"XLA estimate: {flops_per_step:.4g} flops/step, "
        f"{bytes_per_step:.4g} bytes/step -> "
        f"{bytes_per_step * steps_per_sec / 1e9:.1f} GB/s = "
        f"{100 * hbm_frac:.2f}% of the published HBM peak")

    # reference-parity monolithic path from the developed state; the
    # static operator is rebuilt for the scheme's time coefficient
    ns.config.scheme = "monolithic"
    ns._build_static()
    params_m = ns._params()
    run_m = ns._chunk_fn(1)
    state_m, ms_m, _ = _timed_chunks(run_m, params_m, state,
                                     MONO_WARMUP_STEPS)
    state_m, ms_m, wall_m = _timed_chunks(run_m, params_m, state_m,
                                          MONO_STEPS)
    log(f"monolithic (reference-parity): {MONO_STEPS} steps in "
        f"{wall_m:.3f} s -> {MONO_STEPS / wall_m:.4f} steps/s; "
        f"last iters {int(ms_m.iterations[0])}")

    return {
        "metric": f"timesteps/sec, 2D cylinder Re=100, {n_dofs} DoF, fp32, "
                  "1 GPU",
        "value": steps_per_sec,
        "unit": "steps/s",
        "vs_baseline": steps_per_sec / DEALII_BASELINE_STEPS_PER_SEC,
        "setup_s": setup_s,
        "monolithic_steps_per_s": MONO_STEPS / wall_m,
        "flops_per_step": flops_per_step,
        "bytes_per_step": bytes_per_step,
        "hbm_frac": hbm_frac,
    }


if __name__ == "__main__":
    main()
