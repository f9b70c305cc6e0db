"""Profiling / timing utilities.

Parity with the reference's tracing subsystem (SURVEY.md §5): cProfile
decorator dumping per-process stats
(run_aeroelasticity_static_w_feedback.py:34-50) and stage timers around
solves (utils_dolfinx.py:320-333) — plus JAX-native additions: device-sync
timers and jax.profiler trace capture for device timelines.
"""

from __future__ import annotations

import cProfile
import contextlib
import functools
import os
import time


def profile(filename: str | None = None, comm=None):
    """cProfile decorator; dumps stats to `<filename>.<n>` where n is the
    process index (reference profile() parity — MPI rank becomes process id
    here; under single-controller JAX there is one host process)."""

    def decorator(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            pr = cProfile.Profile()
            pr.enable()
            try:
                return f(*args, **kwargs)
            finally:
                pr.disable()
                if filename:
                    pr.dump_stats(f"{filename}.{os.getpid()}")

        return wrapper

    return decorator


class Timer:
    """Stage timer with device synchronization.

    >>> with Timer("solve nonlinear") as t: ...
    prints "Solve nonlinear finished in ... seconds" style messages
    (utils_dolfinx.py:320-333 parity)."""

    def __init__(self, name: str = "", sync: bool = True, report: bool = True):
        self.name = name
        self.sync = sync
        self.report = report
        self.elapsed = 0.0

    def _sync(self):
        if self.sync:
            try:
                import jax

                jax.block_until_ready(
                    jax.device_put(0.0))  # cheap full-queue sync point
            except Exception:
                pass

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.elapsed = time.perf_counter() - self._t0
        if self.report:
            print(f"{self.name} finished in {self.elapsed:.6f} seconds")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler trace (TensorBoard-viewable device timeline)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimers:
    """Accumulating named stage timers (dynamic-FSI run scripts keep
    per-stage totals, run_aeroelasticity_dynamic.py:412-433)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self):
        for k in sorted(self.totals):
            print(f"  {k}: {self.totals[k]:.3f}s over {self.counts[k]} calls")
