"""Benchmark harness: reference-parity sweeps over problem dimension.

Port target: reference testSolver.py — test_LP (:15-276), test_QP
(:437-808), test_SOCP (:810-1034), test_LASSO (:1036-1292), test_LP_sparse
(:278-435), main (:1305-1333).  Solver hyperparameters per problem class
match the reference's benchmark calls exactly; results are written as
reference-format CSVs (utils/csvio.py) consumable by utils/plotting.py.

Oracle columns: CVXPY/CLARABEL when installed, scipy-HiGHS for LP
otherwise; reps halve at n≥1000 and drop to 3 at n≥2500
(reference: testSolver.py:66-71).

Usage: python benchmarks/run_benchmarks.py --suite lp --dims 100 500 1000
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
from time import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

from interiorpoint import (  # noqa: E402
    LassoSolver, LPSolver, QPSolver, SOCPSolver)
from interiorpoint.utils import generators, oracle  # noqa: E402
from interiorpoint.utils.compile_cache import enable_compile_cache  # noqa: E402
from interiorpoint.utils.csvio import write_results  # noqa: E402


def _reps_for(n, N):
    """(reference: testSolver.py:66-71)"""
    if n < 1000:
        return N
    if n < 2500:
        return max(1, N // 2)
    return min(3, N)


def _timed(fn):
    t0 = time()
    val = fn()
    return time() - t0, val


# Above this problem size, unload every compiled executable between
# cells, so that loaded programs and allocator fragmentation left by one
# large cell do not starve the next; the persistent compile cache makes
# the re-warm cheap.
_CLEAR_CACHES_MIN_N = 3000


def _release(n=0):
    """Per-cell device hygiene: collect (and, for large cells, unload
    compiled executables) BEFORE the next cell constructs its device
    arrays.  The suites construct and solve inside a per-cell closure,
    so that a solver's device buffers die by refcount at cell exit
    instead of living on through the next rep's construction; this
    collect clears any cyclic stragglers."""
    gc.collect()
    if n >= _CLEAR_CACHES_MIN_N:
        import jax
        jax.clear_caches()
        gc.collect()


def _cell(fn, suite, n, i, on_fail):
    """Run one (suite, n, rep) cell with fault isolation that also covers
    device-state recovery: on device-memory exhaustion, drop every cached
    executable and live buffer and retry the cell once.  A cell that still
    fails calls ``on_fail()`` (record NaN) and the sweep moves on (reference
    endurance target: 19 dims x 10 reps in one process,
    testSolver.py:1305-1333).  Returns fn()'s result, or None on
    unrecovered failure."""
    import jax

    for attempt in (0, 1):
        try:
            return fn()
        except Exception as e:
            print(f"{suite} n={n} rep={i} attempt={attempt} FAILED: "
                  f"{type(e).__name__}: {str(e)[:200]}", flush=True)
            gc.collect()
            if attempt == 0 and "RESOURCE_EXHAUSTED" in str(e):
                # reclaim: executables + donated/live buffers, then retry
                jax.clear_caches()
                gc.collect()
                continue
            on_fail()
            return None



def test_LP(dims, N=10, outdir=".", verbose=True, check_oracle=True):
    np.random.seed(1)  # (reference: testSolver.py:32)
    num_tests = len(dims)
    t_ours = np.zeros((num_tests, N))
    t_orc = np.zeros((num_tests, N))
    v_ours = np.zeros((num_tests, N))
    v_orc = np.zeros((num_tests, N))
    bt_hist = None
    for count, n in enumerate(dims):
        reps = _reps_for(n, N)
        for i in range(reps):
            p = generators.generate_lp(n)
            if check_oracle:
                dt, (status, val, _) = _timed(lambda: oracle.check_lp(
                    p["c"], p["A"], p["b"], p["C"], p["d"],
                    np.full(n, -3.0), np.full(n, 3.0)))
                t_orc[count, i], v_orc[count, i] = dt, val

            hist_box = []

            def run():
                solver = LPSolver(**p, **generators.RECIPE_SETTINGS["lp"],
                                  suppress_print=True, check_cvxpy=False)
                solver.solve()  # warm the jit cache (one-time compile)
                dt, val = _timed(solver.solve)
                if getattr(solver, "backtrack_hist", None) is not None:
                    hist_box.append(solver.backtrack_hist)
                return dt, val

            def fail(c=count, j=i):
                t_ours[c, j] = v_ours[c, j] = np.nan

            out = _cell(run, "LP", n, i, fail)
            _release(n)
            if out is None:
                continue
            dt, val = out
            t_ours[count, i], v_ours[count, i] = dt, val
            if hist_box:
                bt_hist = (hist_box[0] if bt_hist is None
                           else bt_hist + hist_box[0])
            if verbose:
                print(f"LP n={n} rep={i}: ours {dt:.3f}s val={val:.5f}"
                      + (f" oracle {v_orc[count, i]:.5f}" if check_oracle
                         else ""))
    if bt_hist is not None:
        # accepted-candidate distribution for make_plots.py's
        # backtrack_distribution.png (reference instrumentation)
        np.savetxt(os.path.join(outdir, "backtrack_hist.csv"), bt_hist,
                   delimiter=",", fmt="%d")
    write_results(os.path.join(outdir, "testResults_ours_LP.csv"), t_ours)
    write_results(os.path.join(outdir, "testResults_ours_LPValues.csv"),
                  v_ours)
    if check_oracle:
        write_results(os.path.join(outdir, "testResults_oracle_LP.csv"),
                      t_orc)
        write_results(
            os.path.join(outdir, "testResults_oracle_LPValues.csv"), v_orc)
    return t_ours, v_ours


def test_QP(dims, N=10, outdir=".", verbose=True, check_oracle=True):
    np.random.seed(1)
    num_tests = len(dims)
    t_ours = np.zeros((num_tests, N))
    v_ours = np.zeros((num_tests, N))
    for count, n in enumerate(dims):
        reps = _reps_for(n, N)
        for i in range(reps):
            p = generators.generate_qp(n)

            def run():
                solver = QPSolver(**p, **generators.RECIPE_SETTINGS["qp"],
                                  suppress_print=True, check_cvxpy=False)
                solver.solve()
                dt, val = _timed(solver.solve)
                return dt, val

            def fail(c=count, j=i):
                t_ours[c, j] = v_ours[c, j] = np.nan

            out = _cell(run, "QP", n, i, fail)
            _release(n)
            if out is None:
                continue
            dt, val = out
            t_ours[count, i], v_ours[count, i] = dt, val
            if verbose:
                print(f"QP n={n} rep={i}: ours {dt:.3f}s val={val:.5f}")
    write_results(os.path.join(outdir, "testResults_ours_QP.csv"), t_ours)
    write_results(os.path.join(outdir, "testResults_ours_QPValues.csv"),
                  v_ours)
    return t_ours, v_ours


def test_SOCP(dims, N=10, outdir=".", verbose=True):
    np.random.seed(1)
    num_tests = len(dims)
    t_ours = np.zeros((num_tests, N))
    v_ours = np.zeros((num_tests, N))
    for count, n in enumerate(dims):
        reps = _reps_for(n, N)
        for i in range(reps):
            p = generators.generate_socp(n)
            x0 = p.pop("x0")

            def run():
                solver = SOCPSolver(**p, **generators.RECIPE_SETTINGS["socp"],
                                    suppress_print=True, check_cvxpy=False,
                                    x0=x0)
                solver.solve()
                dt, val = _timed(solver.solve)
                return dt, val

            def fail(c=count, j=i):
                t_ours[c, j] = v_ours[c, j] = np.nan

            out = _cell(run, "SOCP", n, i, fail)
            _release(n)
            if out is None:
                continue
            dt, val = out
            t_ours[count, i], v_ours[count, i] = dt, val
            if verbose:
                print(f"SOCP n={n} rep={i}: ours {dt:.3f}s val={val:.5f}")
    write_results(os.path.join(outdir, "testResults_ours_SOCP.csv"), t_ours)
    write_results(os.path.join(outdir, "testResults_ours_SOCPValues.csv"),
                  v_ours)
    return t_ours, v_ours


def test_LASSO(dims, N=10, outdir=".", verbose=True, num_problems=30):
    np.random.seed(1)
    num_tests = len(dims)
    t_ours = np.zeros((num_tests, N))
    v_ours = np.zeros((num_tests, N, num_problems))
    for count, n in enumerate(dims):
        reps = _reps_for(n, N)
        for i in range(reps):
            p = generators.generate_lasso(n, num_problems=num_problems)

            def run():
                solver = LassoSolver(p["A"], p["b"], reg=p["reg"],
                                     **generators.RECIPE_SETTINGS["lasso"],
                                     check_cvxpy=False)
                solver.solve()
                dt, (X, sols, gaps, iters) = _timed(solver.solve)
                return dt, np.asarray(sols)

            def fail(c=count, j=i):
                t_ours[c, j] = np.nan
                v_ours[c, j, :] = np.nan

            out = _cell(run, "LASSO", n, i, fail)
            _release(n)
            if out is None:
                continue
            dt, sols = out
            t_ours[count, i] = dt
            v_ours[count, i, :] = sols
            if verbose:
                print(f"LASSO n={n} rep={i}: ours {dt:.3f}s "
                      f"mean obj {np.mean(v_ours[count, i]):.5f}")
    write_results(os.path.join(outdir, "testResults_ours_LASSOTimes.csv"),
                  t_ours)
    np.save(os.path.join(outdir, "testResults_ours_LASSOValues.npy"), v_ours)
    return t_ours, v_ours


def test_LP_sparse(data_dir, data_files, N=10, outdir=".", verbose=True):
    """MIPLIB .npy instances (reference: testSolver.py:278-435)."""
    from interiorpoint.utils.miplib import load_lp_npy

    t_ours = np.zeros((len(data_files), N))
    v_ours = np.zeros((len(data_files), N))
    for count, fname in enumerate(data_files):
        c, A, b, C, d, ub, lb = load_lp_npy(os.path.join(data_dir, fname))
        for i in range(N):
            solver = LPSolver(
                c=c, A=A, b=b, C=C, d=d, lower_bound=lb, upper_bound=ub,
                **generators.RECIPE_SETTINGS["lp"], suppress_print=True,
                check_cvxpy=False)
            solver.solve()
            dt, val = _timed(solver.solve)
            t_ours[count, i], v_ours[count, i] = dt, val
            if verbose:
                print(f"{fname} rep={i}: {dt:.3f}s val={val:.5f}")
    write_results(os.path.join(outdir, "testResults_ours_LP_sparse.csv"),
                  t_ours)
    return t_ours, v_ours


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--suite", nargs="+",
                   default=["lp", "lasso", "qp", "socp"])
    # default order: cheap suites first, the most memory-hungry (SOCP)
    # last, so a worst-case device failure costs the fewest artifacts
    p.add_argument("--dims", nargs="+", type=int,
                   default=[100, 500, 1000])  # full ref sweep goes to 5000
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--outdir", type=str, default="benchmarks/results")
    p.add_argument("--no-oracle", action="store_true")
    args = p.parse_args()
    enable_compile_cache()
    os.makedirs(args.outdir, exist_ok=True)
    # one suite's failure must not cost the others their CSVs; suites
    # run in the CLI order (cheapest-first lets a time-boxed sweep keep
    # the most artifacts)
    runners = {"lp": lambda: test_LP(args.dims, N=args.reps,
                                     outdir=args.outdir,
                                     check_oracle=not args.no_oracle),
               "qp": lambda: test_QP(args.dims, N=args.reps,
                                     outdir=args.outdir),
               "socp": lambda: test_SOCP(args.dims, N=args.reps,
                                         outdir=args.outdir),
               "lasso": lambda: test_LASSO(args.dims, N=args.reps,
                                           outdir=args.outdir)}
    for name in args.suite:
        try:
            runners[name]()
        except Exception as e:
            print(f"suite {name} FAILED: {type(e).__name__}: "
                  f"{str(e)[:300]}", flush=True)


if __name__ == "__main__":
    main()
