"""Profiling / tracing — the upgrade of the reference's cudaEvent-based
``CudaTimeCalculator`` (include/CudaTimeCalculator.cuh).

Two layers:

- ``trace(dir)``: captures a full ``jax.profiler`` device trace
  (HLO-level timeline) viewable in TensorBoard / Perfetto.  A trace that
  cannot start raises: a measurement that asked for a trace and silently
  got none would be read as one.
- ``annotate(name)``: a ``jax.profiler.TraceAnnotation`` context so host
  stages (reordering, packing) show up on the same timeline as device
  work.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import jax


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Capture a jax.profiler device trace into ``log_dir``."""
    jax.profiler.start_trace(str(log_dir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named host-side span on the profiler timeline."""
    return jax.profiler.TraceAnnotation(name)
