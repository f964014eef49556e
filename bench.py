"""Solve time and time per iteration of the solvers on an NVIDIA GPU.

Every JSON line names the device it ran on.  Without a GPU the script
exits non-zero: a CPU time is no measurement of the card.  Times are
host-clock wall times around a solve that ends in a blocking fetch, after
one warm-up solve that compiles; the warm-up is reported apart as
``first_s``.  Problems and solver settings are the reference benchmark's
recipes (``utils/generators.py``).

    python bench.py --suite lp --n 1000 --algorithm pd --reps 5
    python bench.py --iteration [--trace-dir DIR]

``--iteration`` measures the LP recipe at n = 1000 and 5000 with each
engine: the time of one Newton step (barrier) or one Mehrotra iteration
(pd), as the steady solve's wall time over its iteration count, and the
device idle share of one steady solve, read from a ``jax.profiler``
trace.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

import numpy as np

from interiorpoint.utils.profiling import (
    device_trace, gpu_name_and_power_limit, idle_share, time_solve)


def device_info():
    """Platform, kind and count of JAX's devices; exits without a GPU."""
    import jax

    devices = jax.devices()
    info = dict(platform=devices[0].platform, kind=devices[0].device_kind,
                count=len(devices))
    if info["platform"] != "gpu":
        sys.exit(f"no GPU found ({info}): bench.py measures an NVIDIA GPU")
    return info


def make_solver(suite, n, algorithm="barrier", seed=1):
    from interiorpoint import LassoSolver, LPSolver, QPSolver, SOCPSolver
    from interiorpoint.utils import generators as g

    rng = np.random.RandomState(seed)
    common = dict(check_cvxpy=False, dtype="float64")
    if suite == "lasso":
        p = g.generate_lasso(n, rng=rng)
        return LassoSolver(p["A"], p["b"], reg=p["reg"],
                           **g.RECIPE_SETTINGS["lasso"], **common)
    p = {"lp": g.generate_lp, "qp": g.generate_qp,
         "socp": g.generate_socp}[suite](n, rng=rng)
    cls = {"lp": LPSolver, "qp": QPSolver, "socp": SOCPSolver}[suite]
    return cls(**p, **g.RECIPE_SETTINGS[suite], **common,
               suppress_print=True, algorithm=algorithm)


def iterations(solver):
    """Newton steps (barrier) or Mehrotra iterations (pd) of the last
    solve."""
    if solver.algorithm == "pd":
        return int(solver.outer_iters)
    return int(sum(solver.inner_iters))


def bench_suite(args, info):
    solver = make_solver(args.suite, args.n, args.algorithm)
    first, steady = time_solve(solver, args.reps)
    q1, med, q3 = (statistics.quantiles(steady, n=4, method="inclusive")
                   if len(steady) > 1 else (steady[0],) * 3)
    objective = (np.mean(solver.solutions) if args.suite == "lasso"
                 else solver.value)
    return dict(suite=args.suite, n=args.n, algorithm=args.algorithm,
                first_s=first, median_s=med, q1_s=q1, q3_s=q3,
                samples=len(steady), objective=float(objective), device=info)


def bench_iteration(args, info):
    records = []
    for n in (1000, 5000):
        for algorithm in ("barrier", "pd"):
            solver = make_solver("lp", n, algorithm)
            first, steady = time_solve(solver, args.reps)
            its = iterations(solver)
            med = statistics.median(steady)
            trace_dir = (os.path.join(args.trace_dir, f"lp{n}_{algorithm}")
                         if args.trace_dir else tempfile.mkdtemp())
            rec = dict(suite="lp", n=n, algorithm=algorithm, first_s=first,
                       median_s=med, steady_s=steady, iterations=its,
                       s_per_iteration=med / its,
                       objective=float(solver.value), device=info)
            with device_trace(trace_dir):
                solver.solve()
            rec.update(idle_share(trace_dir))
            rec["device_ops_per_iteration"] = rec["device_ops"] / its
            records.append(rec)
            print(json.dumps(rec), flush=True)
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--suite", default="lp",
                   choices=["lp", "qp", "socp", "lasso"])
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--algorithm", default="barrier",
                   choices=["barrier", "pd", "auto"])
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--iteration", action="store_true",
                   help="time per iteration and idle share, LP n=1000/5000")
    p.add_argument("--trace-dir", default=None,
                   help="keep the profiler traces of --iteration here")
    args = p.parse_args(argv)

    import jax
    from interiorpoint.utils.compile_cache import enable_compile_cache

    jax.config.update("jax_enable_x64", True)
    info = device_info()
    print(f"# nvidia-smi: {gpu_name_and_power_limit()}", flush=True)
    enable_compile_cache()
    if args.iteration:
        bench_iteration(args, info)
    else:
        print(json.dumps(bench_suite(args, info)))


if __name__ == "__main__":
    main()
