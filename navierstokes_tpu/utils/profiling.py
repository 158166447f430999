"""Tracing / profiling / debug hooks.

The reference's observability is two std::chrono spans per step
(src/NavierStokes.cpp:347, 375-390).  JAX equivalents:

* ``trace(dir)``      — jax.profiler trace context (view in TensorBoard /
                        xprof); wraps any region, e.g. a solve chunk.
* ``annotate(name)``  — named trace region for step phases.
* ``debug_mode()``    — enables jax_debug_nans + disables donation, the
                        stand-in for the sanitizers the reference never had
                        (SURVEY.md par.5: no TSan/ASan).
* ``flop_estimate``   — XLA cost analysis of a compiled step (FLOP
                        accounting per time step).
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    with jax.profiler.trace(log_dir):
        yield


def annotate(name: str):
    return jax.profiler.TraceAnnotation(name)


@contextlib.contextmanager
def debug_mode():
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def flop_estimate(jitted_fn, *args, **kwargs) -> dict:
    """FLOPs / bytes-accessed estimate of one compiled call."""
    lowered = jitted_fn.lower(*args, **kwargs)
    compiled = lowered.compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, list):  # per-device list on some backends
        ca = ca[0] if ca else {}
    return {k: ca.get(k) for k in ("flops", "bytes accessed",
                                   "optimal_seconds") if ca and k in ca}
