"""Process-wide runtime settings (compile cache, matmul precision), the
bench peak table and the GPU smoke run's phases, checked on the CPU."""

import glob
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from navierstokes_tpu.config import SolverConfig
from navierstokes_tpu.mesh import channel_with_cylinder_2d
from navierstokes_tpu.models.navier_stokes import NavierStokes
from navierstokes_tpu.utils import runtime

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402

_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_enable_compilation_cache",
               "jax_persistent_cache_min_compile_time_secs")


@pytest.fixture
def cache_config():
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


@pytest.mark.parametrize("env_dir, backend, expect", [
    ("/elsewhere/jax_cache", "gpu", "from the environment"),
    (None, "gpu", "in the checkout"),
    (None, "cpu", "off"),
])
def test_compile_cache_placement(monkeypatch, cache_config, env_dir,
                                 backend, expect):
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", "/as/jax/read/it")
    got = runtime.configure_compile_cache(backend)
    if expect == "from the environment":
        # no directory set in code: JAX keeps what it read
        assert got == jax.config.jax_compilation_cache_dir == "/as/jax/read/it"
    elif expect == "in the checkout":
        assert got == jax.config.jax_compilation_cache_dir \
            == str(REPO / ".jax_cache")
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()
    else:
        assert got is None
        assert not jax.config.jax_enable_compilation_cache


def _small_solver(tmp_path, scheme):
    cfg = SolverConfig(output_dir=str(tmp_path / "o"),
                       cache_dir=str(tmp_path / "c"),
                       csv_path=str(tmp_path / "f.csv"), n_devices=1,
                       dtype="float32", scheme=scheme)
    return NavierStokes(channel_with_cylinder_2d(h=0.15), 2, 1, deltat=0.01,
                        T=0.01, step=1, config=cfg)


def _dots(text):
    return [line for line in text.splitlines() if "dot_general" in line]


@pytest.mark.parametrize("program", ["setup", "projection step",
                                     "monolithic step"])
def test_programs_lower_at_highest_precision(tmp_path, program):
    """Every dot of the solver's programs is pinned to HIGHEST, so no GPU
    runs an fp32 product in TF32.  Setup's programs (the block-Jacobi seed,
    the lambda_max estimates, eager ops) are captured from JAX's IR dump;
    the step from its lowering."""
    scheme = "monolithic" if program == "monolithic step" else "projection"
    ns = _small_solver(tmp_path, scheme)
    if program == "setup":
        jax.config.update("jax_dump_ir_to", str(tmp_path / "ir"))
        try:
            ns.setup()
            ns._init_state(0)
            ns._params()
        finally:
            jax.config.update("jax_dump_ir_to", "")
        files = glob.glob(str(tmp_path / "ir" / "*.mlir"))
        assert files
        dots = [d for f in files for d in _dots(Path(f).read_text())]
    else:
        ns.setup()
        ns._init_state(0)
        lowered = ns._chunk_fn(1).lower(
            ns._params(), ns._u, ns._p, ns._u_prev, ns._phi,
            jnp.asarray(0.0, ns.dtype))
        dots = _dots(lowered.as_text())
        assert dots
    assert all("precision = [HIGHEST, HIGHEST]" in d for d in dots), [
        d.strip()[:160] for d in dots if "HIGHEST" not in d]


def test_peak_table_refuses_unknown_device():
    assert bench.peaks_for("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] \
        == 3.35e12
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks_for("Quadro RTX 9000")


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("phase", ["parity", "df32"])
def test_chip_smoke_phase_on_cpu(tmp_path, phase):
    """The GPU smoke run's comparison logic, CPU device against CPU
    device: identical programs must agree within the stated tolerances."""
    cpu = jax.devices("cpu")
    if phase == "parity":
        chip_smoke.phase_parity(cpu[0], cpu[1], str(tmp_path), h=0.1)
    else:
        chip_smoke.phase_df32(cpu[0])
