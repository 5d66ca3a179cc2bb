"""Timing utilities — the counterpart of CudaTimeCalculator
(include/CudaTimeCalculator.cuh): wall-clock around ``block_until_ready``
with warmup iterations so compile time is excluded."""

from __future__ import annotations

import time
from typing import Callable

import jax


class Timer:
    """Simple start/stop wall timer returning milliseconds."""

    def __init__(self):
        self._start = None
        self._elapsed_ms = 0.0

    def start(self):
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        self._elapsed_ms = (time.perf_counter() - self._start) * 1e3
        return self._elapsed_ms

    @property
    def ms(self) -> float:
        return self._elapsed_ms

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def _block(out):
    return jax.tree_util.tree_map(
        lambda x: x.block_until_ready() if hasattr(x, "block_until_ready")
        else x, out)


def time_jax_fn(fn: Callable, *args, iterations: int = 10,
                warmup: int = 2) -> tuple[float, object]:
    """Average wall time (ms) of ``fn(*args)`` over ``iterations`` after
    ``warmup`` runs (reference averages over numIterations=10,
    src/sddmmKernel.cu:2565,2653)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = _block(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iterations):
        out = _block(fn(*args))
    elapsed_ms = (time.perf_counter() - t0) * 1e3 / iterations
    return elapsed_ms, out


def gflops(nnz: int, k: int, time_ms: float) -> float:
    """GFLOPS = 2*NNZ*K / time (reference include/Logger.hpp:178-180)."""
    if time_ms <= 0:
        return 0.0
    return 2.0 * nnz * k / (time_ms * 1e6)


def diff_time_ms(run_many, run_one, iterations: int,
                 repeats: int = 3) -> float:
    """Difference the wall time of an N-iteration and a 1-iteration
    device program (each a zero-arg callable that blocks on completion),
    which removes the fixed dispatch/transfer latency.  Retries and
    falls back to the undifferenced upper bound when host jitter
    produces a degenerate (<= 1 us) difference."""
    def best(f):
        f()
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            f()
            times.append(time.perf_counter() - t0)
        return min(times)

    if iterations < 2:
        # Differencing needs >= 2 iterations; report the undifferenced
        # upper bound (includes dispatch/transfer latency).
        return best(run_many) * 1e3 / max(iterations, 1)
    t_many, t_one = best(run_many), best(run_one)
    if t_many - t_one <= 1e-6 and iterations > 1:
        t_many = min(t_many, best(run_many))
        t_one = min(t_one, best(run_one))
        if t_many - t_one <= 1e-6:
            return t_many * 1e3 / iterations
    return max(t_many - t_one, 1e-6) * 1e3 / (iterations - 1)


def measure_loop_ms(body, args, iterations: int = 20,
                    repeats: int = 3) -> float:
    """Loop-differenced device time (ms/call) of ``body(carry, *args)``
    (the diff_time_ms methodology, reusable for any op)."""
    import jax
    import jax.numpy as jnp

    def looped(n):
        @jax.jit
        def f(*a):
            def it(_, c):
                return jnp.float32(1e-38) * jnp.sum(
                    body(c, *a)).astype(jnp.float32)
            return jax.lax.fori_loop(0, n, it, jnp.float32(0.0))
        return f

    f_many, f_one = looped(iterations), looped(1)
    return diff_time_ms(lambda: float(f_many(*args)),
                        lambda: float(f_one(*args)),
                        iterations, repeats)
