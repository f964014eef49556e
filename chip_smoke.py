"""Smoke run of the solvers on NVIDIA GPUs.

One card (the default) drives the user entry points — ``LPSolver``,
``QPSolver`` and ``SOCPSolver`` with ``algorithm="barrier"`` and
``algorithm="pd"``, ``LassoSolver`` and ``solve_batch`` — in float64 at
the reference benchmark's largest size, n = 5000, plus an infeasible-start
LP that runs phase one and a 256-instance LP batch.  Every answer is
checked against a plain reference (HiGHS, the KKT certificate of
``utils/certify.py``, the other engine, the LASSO subgradient condition,
per-instance solves).  ``--four-cards`` instead runs the sharded solves
on four cards and compares each with the same instance solved on one.

Each phase prints one ``phase {...}`` JSON line: wall time of the first
solve (compile + run) and of one steady solve, both ending in a blocking
fetch; iterations; the objective; its error against the reference beside
the tolerance, the precision and the reason for the tolerance.  These are
smoke numbers, not a benchmark.  The last line is
``{"ok": true, "device": {...}}``; any failed phase makes the script exit
non-zero without it, and so does a machine where JAX finds no GPU.

    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # four cards, sharded solves only
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import numpy as np
import jax
import jax.numpy as jnp

from interiorpoint import LassoSolver, LPSolver, QPSolver, SOCPSolver
from interiorpoint.models.problem import make_lp
from interiorpoint.utils.certify import certify
from interiorpoint.utils.config import AdmmConfig, SolverConfig
from interiorpoint.utils.generators import (
    RECIPE_SETTINGS, generate_lasso, generate_lp, generate_qp, generate_socp)
from interiorpoint.utils.profiling import gpu_name_and_power_limit, time_solve

LP_SETTINGS = RECIPE_SETTINGS["lp"]
QP_SETTINGS = RECIPE_SETTINGS["qp"]
SOCP_SETTINGS = RECIPE_SETTINGS["socp"]
LASSO_SETTINGS = RECIPE_SETTINGS["lasso"]
COMMON = dict(suppress_print=True, check_cvxpy=False, dtype="float64")

# Equality residual and slack bound of the KKT certificate (kkt_check).
KKT_EQ_TOL = 1e-8


def gap_tol(eps, f_ref):
    """|f − f_ref| ≤ ε·(1 + |f_ref|): the duality-gap stop at ε bounds
    each solve's distance to the optimum."""
    return eps * (1.0 + abs(f_ref))


def _iters(solver):
    if solver.algorithm == "pd":
        return {"pd_iterations": solver.outer_iters}
    return {"newton_steps": int(sum(solver.inner_iters)),
            "barrier_stages": solver.outer_iters}


def kkt_check(solver, gap_tolerance):
    """The KKT certificate (utils/certify.py) of a solve stopped at ε:
    the equality residual relative to 1 + ‖b‖∞ (the null-space solve keeps
    it at rounding), the least inequality slack (≥ 0 up to rounding: pd
    iterates sit on active bounds) and the duality gap, held to the same
    ε·(1 + |f_ref|) as the objective.
    Stationarity and complementarity of the recovered duals are reported
    beside it, not held to a bound: at a gap of 1e-4 the certificate's
    active set is not reliably identifiable."""
    cert = certify(solver)
    b = solver._eq[1]
    eq_rel = cert.eq_residual / (1.0 + (0.0 if b is None
                                        else float(np.abs(b).max())))
    ok = (eq_rel <= KKT_EQ_TOL and cert.min_slack >= -KKT_EQ_TOL
          and cert.dual_gap <= gap_tolerance)
    return dict(kkt_eq_residual_rel=eq_rel, kkt_min_slack=cert.min_slack,
                kkt_dual_gap=cert.dual_gap, kkt_eq_tol=KKT_EQ_TOL,
                kkt_gap_tol=gap_tolerance, kkt_stationarity=cert.stationarity,
                kkt_complementarity=cert.complementarity, kkt_ok=bool(ok))


def engine_pair(name, cls, problem, settings, n):
    """Solve one instance with the barrier and the pd engine: each must
    certify, and their objectives must agree within the gap tolerance."""
    eps = settings["epsilon"]
    solved = {}
    for algorithm in ("barrier", "pd"):
        t0 = time.perf_counter()
        solver = cls(**problem, **settings, **COMMON, algorithm=algorithm)
        setup = time.perf_counter() - t0
        first, (steady,) = time_solve(solver, 1)
        solved[algorithm] = (solver, setup, first, steady)
    records = []
    for algorithm, other in (("barrier", "pd"), ("pd", "barrier")):
        solver, setup, first, steady = solved[algorithm]
        f_ref = solved[other][0].value
        err = abs(solver.value - f_ref)
        tol = gap_tol(eps, f_ref)
        kkt = kkt_check(solver, tol)
        records.append(dict(
            phase=f"{name}{n}_{algorithm}", setup_s=setup, first_s=first,
            steady_s=steady, **_iters(solver), objective=solver.value,
            reference=f"{name}{n}_{other} objective", err=err, tol=tol,
            tol_reason="eps*(1+|f_ref|), duality-gap stop", **kkt,
            precision="float64", ok=bool(err <= tol and kkt["kkt_ok"])))
    return records


def phase_lp(n=5000, seed=1):
    problem = generate_lp(n, rng=np.random.RandomState(seed))
    return engine_pair("lp", LPSolver, problem, LP_SETTINGS, n)


def phase_qp(n=5000, seed=1):
    problem = generate_qp(n, rng=np.random.RandomState(seed))
    return engine_pair("qp", QPSolver, problem, QP_SETTINGS, n)


def phase_socp(n=5000, seed=1):
    # 50 equalities in the recipe; fewer only where n is too small for 50
    problem = generate_socp(n, k=min(50, n // 4),
                            rng=np.random.RandomState(seed))
    x0 = problem.pop("x0")
    return engine_pair("socp", SOCPSolver, problem,
                       dict(SOCP_SETTINGS, x0=x0), n)


def lasso_residual(A, b, reg, X, add_bias):
    """Worst subgradient residual of the batched LASSO optimality
    condition Aᵀ(AX−b)/m ∈ −λ·∂‖X‖₁ (the bias row is unregularized)."""
    if add_bias:
        A = np.hstack([np.ones((A.shape[0], 1)), A])
    G = A.T @ (A @ X - b) / A.shape[0]
    lam = np.broadcast_to(np.atleast_1d(reg), (X.shape[1],))[None, :]
    lam = np.broadcast_to(lam, X.shape).copy()
    if add_bias:
        lam[0] = 0.0
    on = np.abs(X) > 1e-9
    res = np.where(on, G + lam * np.sign(X),
                   np.maximum(np.abs(G) - lam, 0.0))
    return float(np.abs(res).max())


LASSO_TOL_REASON = ("sqrt(n)*eps_rel*|[1 A]^T b|_inf/m: ADMM's l2 stop at "
                    "eps_rel, read in the inf-norm, relative to the "
                    "gradient at x=0")


def lasso_tol(A, b, eps_rel):
    """Bound on the subgradient residual of a solve stopped at eps_rel."""
    g0 = max(np.abs(b.sum(axis=0)).max(), np.abs(A.T @ b).max())
    return float(np.sqrt(A.shape[1] + 1) * eps_rel * g0 / A.shape[0])


def phase_lasso(n=5000, seed=1):
    p = generate_lasso(n, rng=np.random.RandomState(seed))
    t0 = time.perf_counter()
    solver = LassoSolver(p["A"], p["b"], reg=p["reg"], **LASSO_SETTINGS,
                         check_cvxpy=False, dtype="float64")
    setup = time.perf_counter() - t0
    first, (steady,) = time_solve(solver, 1)
    err = lasso_residual(p["A"], p["b"], p["reg"], solver.X, True)
    tol = lasso_tol(p["A"], p["b"], LASSO_SETTINGS["eps_rel"])
    return [dict(phase=f"lasso{n}", setup_s=setup, first_s=first,
                 steady_s=steady, admm_iterations=solver.num_iterations,
                 objective=float(np.mean(solver.solutions)),
                 reference="subgradient optimality residual", err=err,
                 tol=tol, tol_reason=LASSO_TOL_REASON,
                 precision="float64", ok=bool(err <= tol))]


def phase_lp_phase_one(n=1000, seed=2):
    """Infeasible start: x0 = 0 violates about half of Cx ≤ d, so the
    barrier runs phase one first.  Reference: HiGHS."""
    from scipy.optimize import linprog

    problem = generate_lp(n, rng=np.random.RandomState(seed))
    solver = LPSolver(**problem, **LP_SETTINGS, **COMMON)
    x0 = np.zeros(n)
    first, (steady,) = time_solve(solver, 1, x0=x0)
    ran = bool(solver.last_metrics["phase1_ran"])
    ref = linprog(problem["c"], A_ub=problem["C"], b_ub=problem["d"],
                  A_eq=problem["A"], b_eq=problem["b"],
                  bounds=(-3.0, 3.0), method="highs")
    err = abs(solver.value - ref.fun)
    tol = gap_tol(LP_SETTINGS["epsilon"], ref.fun)
    return [dict(phase=f"lp{n}_phase_one", first_s=first, steady_s=steady,
                 **_iters(solver), phase_one_ran=ran,
                 objective=solver.value, reference="HiGHS (scipy linprog)",
                 err=err, tol=tol,
                 tol_reason="eps*(1+|f_ref|), duality-gap stop",
                 precision="float64",
                 ok=bool(ran and ref.success and err <= tol))]


def lp_batch(num, n, seed):
    """``num`` LP instances of the reference recipe, stacked, with the
    start x0 = 0 (infeasible for Cx ≤ d; the pd engine starts anywhere)."""
    from interiorpoint.parallel import stack_problems

    rng = np.random.RandomState(seed)
    raw = [generate_lp(n, rng=rng) for _ in range(num)]
    probs = [make_lp(p["c"], p["A"], p["b"], p["C"], p["d"], -3.0, 3.0,
                     dtype=jnp.float64) for p in raw]
    return raw, stack_problems(probs), jnp.zeros((num, n), jnp.float64)


def batch_config():
    return SolverConfig(dtype="float64", **LP_SETTINGS)


def solve_lp_batch(batch, x0):
    """``solve_batch`` with the pd engine (the route ``algorithm="auto"``
    takes for LP); returns the host-side result."""
    from interiorpoint.parallel import solve_batch

    return jax.device_get(solve_batch(batch, x0, batch_config(),
                                      algorithm="pd"))


def batch_objectives(raw, res):
    return np.einsum("bn,bn->b", np.stack([p["c"] for p in raw]),
                     np.asarray(res.z))


def phase_batch(num=256, n=100, seed=3):
    """solve_batch against HiGHS and against each instance solved alone
    through ``LPSolver(algorithm="pd")``."""
    from scipy.optimize import linprog

    raw, batch, x0 = lp_batch(num, n, seed)
    t0 = time.perf_counter()
    solve_lp_batch(batch, x0)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve_lp_batch(batch, x0)
    steady = time.perf_counter() - t0
    vals = batch_objectives(raw, res)
    single = np.array([LPSolver(**p, **LP_SETTINGS, **COMMON,
                                algorithm="pd").solve() for p in raw])
    highs = np.array([linprog(p["c"], A_ub=p["C"], b_ub=p["d"],
                              A_eq=p["A"], b_eq=p["b"], bounds=(-3.0, 3.0),
                              method="highs").fun for p in raw])
    tols = np.array([gap_tol(LP_SETTINGS["epsilon"], f) for f in highs])
    errs = np.maximum(np.abs(vals - highs), np.abs(single - highs))
    return [dict(phase=f"batch{num}_lp{n}_pd", first_s=first,
                 steady_s=steady, max_pd_iterations=int(np.max(res.iters)),
                 converged=int(np.sum(res.converged)),
                 objective_mean=float(np.mean(vals)),
                 reference="HiGHS, and LPSolver(pd) per instance",
                 err=float(errs.max()), tol=float(tols.min()),
                 tol_reason="eps*(1+|f_ref|) per instance",
                 precision="float64",
                 ok=bool(np.all(errs <= tols) and np.all(res.converged)))]


def phase_mixed_factor(n=4000, cond=1e12, seed=4):
    """The default factor path (ops/kkt.py mixed_posdef_solve: float32
    Cholesky + float64 refinement) against a float64 LAPACK solve."""
    from scipy.linalg import solve as host_solve
    from interiorpoint.ops.kkt import mixed_posdef_solve

    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    H = (Q * np.logspace(0, np.log10(cond), n)) @ Q.T
    H = 0.5 * (H + H.T)
    b = rng.standard_normal(n)
    fn = jax.jit(mixed_posdef_solve)
    Hd, bd = jnp.asarray(H), jnp.asarray(b)
    t0 = time.perf_counter()
    x = np.asarray(fn(Hd, bd))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = np.asarray(fn(Hd, bd))
    steady = time.perf_counter() - t0
    ref = host_solve(H, b, assume_a="pos")
    err = float(np.linalg.norm(H @ x - b) / np.linalg.norm(b))
    ref_err = float(np.linalg.norm(H @ ref - b) / np.linalg.norm(b))
    tol = max(100.0 * ref_err, 1e-12)
    return [dict(phase=f"mixed_factor{n}", first_s=first, steady_s=steady,
                 condition=cond, objective=None,
                 reference="LAPACK float64 posv residual", err=err,
                 tol=tol, tol_reason="100x the float64 LAPACK residual",
                 precision="float32 factor, float64 refinement",
                 ok=bool(err <= tol))]


ONE_CARD_PHASES = (phase_mixed_factor, phase_lp, phase_qp, phase_socp,
                   phase_lasso, phase_lp_phase_one, phase_batch)


# ---------------------------------------------------------------------------
# Four cards: the sharded solves against the same instance on one card.
# ---------------------------------------------------------------------------


def _spans(arr, ndev):
    """The array's shards sit on ``ndev`` distinct devices."""
    return len(arr.sharding.device_set) == ndev and len(
        {s.device for s in arr.addressable_shards}) == ndev


def _sharded_record(name, first, res, f_ref, eps, spans):
    """Record of one sharded solve against the one-card objective; its
    own iteration count (Newton steps or pd iterations) rides along."""
    f = float(res["objective"])
    tol = gap_tol(eps, f_ref)
    err = abs(f - f_ref)
    return dict(phase=name, first_s=first,
                iterations=int(res["newton_iters"]), objective=f,
                reference="same instance on one card", err=err, tol=tol,
                tol_reason="eps*(1+|f_ref|), duality-gap stop",
                precision="float64", sharded_on_all_cards=spans,
                ok=bool(err <= tol and spans))


def four_card_row_sharded(mesh, n=5000, seed=1):
    from interiorpoint.parallel import (shard_rows, solve_lp_row_sharded,
                                        solve_qp_row_sharded)

    ndev = mesh.devices.size
    out = []
    lp = generate_lp(n, rng=np.random.RandomState(seed))
    qp = generate_qp(n, rng=np.random.RandomState(seed))
    for kind, p, settings in (("lp", lp, LP_SETTINGS),
                              ("qp", qp, QP_SETTINGS)):
        eps = settings["epsilon"]
        rows = -(-p["C"].shape[0] // ndev) * ndev
        C_p = np.zeros((rows, n))
        C_p[:p["C"].shape[0]] = p["C"]
        spans = _spans(shard_rows(mesh, jnp.asarray(C_p)), ndev)
        cls = LPSolver if kind == "lp" else QPSolver
        for algorithm in ("barrier", "pd"):
            one = cls(**p, **settings, **COMMON, algorithm=algorithm)
            one.solve()
            kw = dict(lb=-3.0, ub=3.0, epsilon=eps, algorithm=algorithm)
            t0 = time.perf_counter()
            if kind == "lp":
                res = solve_lp_row_sharded(mesh, p["c"], p["A"], p["b"],
                                           p["C"], p["d"], **kw)
            else:
                res = solve_qp_row_sharded(mesh, p["P"], p["q"], p["A"],
                                           p["b"], p["C"], p["d"], **kw)
            out.append(_sharded_record(
                f"{kind}{n}_{algorithm}_row_sharded",
                time.perf_counter() - t0, res, one.value, eps, spans))
    return out


def four_card_cone_sharded(mesh, n=5000, seed=1):
    from interiorpoint.parallel import shard_cones, solve_socp_cone_sharded

    ndev = mesh.devices.size
    p = generate_socp(n, k=min(50, n // 4), rng=np.random.RandomState(seed))
    x0 = p.pop("x0")
    A = np.stack(p["A"])
    b = np.stack(p["b"])
    c = np.stack(p["c"])
    d = np.asarray(p["d"])
    K = A.shape[0]
    Kp = -(-K // ndev) * ndev
    spans = _spans(shard_cones(mesh, jnp.zeros((Kp,) + A.shape[1:])), ndev)
    eps = SOCP_SETTINGS["epsilon"]
    out = []
    for algorithm in ("barrier", "pd"):
        one = SOCPSolver(**p, **SOCP_SETTINGS, **COMMON, x0=x0,
                         algorithm=algorithm)
        one.solve()
        # the barrier starts from the one-card solve's t0="auto" value
        kw = dict(t0=one._t0_auto_value) if algorithm == "barrier" else {}
        t0 = time.perf_counter()
        res = solve_socp_cone_sharded(
            mesh, A, b, c, d, p["P"], p["q"], p["F"], p["g"], x0=x0,
            epsilon=eps, algorithm=algorithm, **kw)
        out.append(_sharded_record(
            f"socp{n}_{algorithm}_cone_sharded", time.perf_counter() - t0,
            res, one.value, eps, spans))
    return out


def four_card_batch(mesh, num=256, n=100, seed=3):
    from interiorpoint.parallel import solve_batch

    ndev = mesh.devices.size
    raw, batch, x0 = lp_batch(num, n, seed)
    one = batch_objectives(raw, solve_lp_batch(batch, x0))
    t0 = time.perf_counter()
    res = solve_batch(batch, x0, batch_config(), mesh=mesh, algorithm="pd")
    spans = _spans(res.z, ndev)
    vals = batch_objectives(raw, jax.device_get(res))
    first = time.perf_counter() - t0
    tols = np.array([gap_tol(LP_SETTINGS["epsilon"], f) for f in one])
    errs = np.abs(vals - one)
    return [dict(phase=f"batch{num}_lp{n}_pd_sharded", first_s=first,
                 objective_mean=float(np.mean(vals)),
                 reference="same batch on one card", err=float(errs.max()),
                 tol=float(tols.min()),
                 tol_reason="eps*(1+|f_ref|) per instance",
                 precision="float64", sharded_on_all_cards=spans,
                 ok=bool(np.all(errs <= tols) and spans))]


def four_card_lasso(mesh, n=5000, seed=1):
    from interiorpoint import solve_lasso
    from interiorpoint.parallel import solve_lasso_sharded

    ndev = mesh.devices.size
    # 32 instances instead of the recipe's 30, so that they divide evenly
    # over the cards
    p = generate_lasso(n, num_problems=32, rng=np.random.RandomState(seed))
    A = np.hstack([np.ones((p["A"].shape[0], 1)), p["A"]])
    # LassoSolver's over-relaxation and adaptive rho, as in phase_lasso
    cfg = AdmmConfig(dtype="float64", relax=1.8, adaptive_rho=True,
                     **LASSO_SETTINGS)
    one = jax.device_get(solve_lasso(A, p["b"], p["reg"], cfg=cfg))
    t0 = time.perf_counter()
    res = solve_lasso_sharded(A, p["b"], p["reg"], cfg, mesh)
    X = np.asarray(res.X)
    first = time.perf_counter() - t0
    spans = _spans(res.X, ndev)
    f, f_ref = np.asarray(res.solutions), np.asarray(one.solutions)
    err = float(np.max(np.abs(f - f_ref) / (1.0 + np.abs(f_ref))))
    tol = 1e-6
    return [dict(phase=f"lasso{n}_sharded", first_s=first,
                 admm_iterations=int(res.iterations),
                 objective=float(np.mean(f)),
                 reference="same batch on one card (relative objective)",
                 err=err, tol=tol,
                 tol_reason="ADMM stop eps_rel=1e-6 on both runs",
                 residual_err=lasso_residual(p["A"], p["b"], p["reg"], X,
                                             True),
                 precision="float64", sharded_on_all_cards=spans,
                 ok=bool(err <= tol and spans))]


FOUR_CARD_PHASES = (four_card_row_sharded, four_card_cone_sharded,
                    four_card_batch, four_card_lasso)


# ---------------------------------------------------------------------------


def run_phases(phases, *args, **kwargs):
    """Run every phase; print its records.  Returns True when all passed."""
    ok = True
    for phase in phases:
        try:
            records = phase(*args, **kwargs)
        except Exception:                         # report, keep going
            traceback.print_exc()
            print("phase " + json.dumps({"phase": phase.__name__,
                                         "ok": False}), flush=True)
            ok = False
            continue
        for rec in records:
            print("phase " + json.dumps(rec), flush=True)
            ok = ok and rec["ok"]
    return ok


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded solves, on four cards")
    args = parser.parse_args(argv)

    devices = jax.devices()
    dev = devices[0]
    print(f"jax devices: platform={dev.platform} kind={dev.device_kind} "
          f"count={len(devices)}", flush=True)
    if dev.platform != "gpu":
        print("no GPU found: this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    need = 4 if args.four_cards else 1
    if len(devices) < need:
        print(f"need {need} GPUs, found {len(devices)}", file=sys.stderr)
        return 2
    print(gpu_name_and_power_limit(), flush=True)   # name, power limit

    from interiorpoint.utils.compile_cache import enable_compile_cache
    jax.config.update("jax_enable_x64", True)
    print(f"compile cache: {enable_compile_cache()}", flush=True)

    if args.four_cards:
        from interiorpoint.parallel import make_mesh

        ok = True
        for axis, phases in (("rows", FOUR_CARD_PHASES[:1]),
                             ("cones", FOUR_CARD_PHASES[1:2]),
                             ("batch", FOUR_CARD_PHASES[2:])):
            ok = run_phases(phases, make_mesh(4, (axis,))) and ok
    else:
        ok = run_phases(ONE_CARD_PHASES)
    if not ok:
        print("smoke run failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
