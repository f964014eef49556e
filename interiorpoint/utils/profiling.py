"""Profiling utilities: wall-clock solve timing, jax.profiler traces and
the device idle share read back from them.

Replacement for the reference's cProfile wrapper
(reference: time_profiling.py:105-118): ``time_solve`` times ``solve()``
the way the reference's benchmark loops do (reference:
testSolver.py:150-159), with the compiling first call apart;
``device_trace`` captures an XLA device trace viewable in
TensorBoard/Perfetto, and ``idle_share`` reduces one to the share of a
host span during which the device ran nothing.
"""

from __future__ import annotations

import contextlib
import glob
import os
import subprocess
import time

import jax


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the cards, read in a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_solve(solver, reps=3, **solve_kwargs):
    """(first_s, [steady_s, ...]) of ``solver.solve()``, which ends in a
    blocking fetch; the first call compiles."""
    t0 = time.perf_counter()
    solver.solve(**solve_kwargs)
    first = time.perf_counter() - t0
    steady = []
    for _ in range(reps):
        t0 = time.perf_counter()
        solver.solve(**solve_kwargs)
        steady.append(time.perf_counter() - t0)
    return first, steady


@contextlib.contextmanager
def device_trace(logdir, span="traced"):
    """Capture a jax.profiler trace around a block of work, inside a host
    span named ``span`` (the window ``idle_share`` reads)."""
    with jax.profiler.trace(logdir):
        with jax.profiler.TraceAnnotation(span):
            yield logdir


def busy_ns(intervals, lo, hi):
    """Length of the union of sorted ``(start, end)`` intervals clipped to
    [lo, hi]."""
    total, end = 0.0, lo
    for s, e in intervals:
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def idle_share(logdir, span="traced"):
    """Share of the host span ``span`` during which the first GPU ran no
    operation: one minus the union of the intervals on its stream lines
    (kernels and copies) over the span's length.  The derived lines of a
    device plane ("XLA Modules", "Steps", ...) span whole programs, gaps
    included, and are not counted."""
    path = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    window, ops = None, None
    for plane in data.planes:
        if plane.name.startswith("/device:GPU") and ops is None:
            ops = sorted((e.start_ns, e.start_ns + e.duration_ns)
                         for line in plane.lines
                         if line.name.startswith("Stream")
                         for e in line.events)
        elif plane.name.startswith("/host"):
            for line in plane.lines:
                for e in line.events:
                    if e.name == span:
                        window = (e.start_ns, e.start_ns + e.duration_ns)
    if window is None or not ops:
        raise RuntimeError(f"trace {path} lacks the span or GPU operations")
    lo, hi = window
    return dict(idle_share=1.0 - busy_ns(ops, lo, hi) / (hi - lo),
                window_s=(hi - lo) * 1e-9, device_ops=len(ops))
