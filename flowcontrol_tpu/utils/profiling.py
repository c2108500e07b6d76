"""Profiling helpers: per-step timing (reference parity) + jax.profiler traces.

The reference measures wall time per step into the timeseries `runtime`
column and summarizes with utils.fem.summarize_timings (ref: SURVEY §5.1);
both exist here. This module adds the device layer: XLA profile traces.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def trace(logdir: str = "/tmp/flowcontrol_tpu_trace"):
    """Capture a jax.profiler trace around a code block (view in XProf)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str, results: dict | None = None):
    """Wall-time a block (host side), storing into ``results[label]``."""
    t0 = time.time()
    yield
    dt = time.time() - t0
    if results is not None:
        results[label] = dt


def device_memory_stats() -> dict:
    """Live device memory statistics where the backend exposes them."""
    import jax

    out = {}
    for d in jax.devices():
        try:
            out[str(d)] = d.memory_stats()
        except Exception:
            out[str(d)] = None
    return out
