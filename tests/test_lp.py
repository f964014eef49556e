"""LP end-to-end tests against scipy.optimize.linprog (HiGHS) ground truth.

Problem generation follows the reference benchmark's feasible-by-construction
recipe (reference: testSolver.py:75-87): A, C, c uniform in [-2, 2] and
b = A·x_feas, d = C·x_feas so the instance is guaranteed feasible.
"""

import numpy as np
import pytest
from scipy.optimize import linprog

from interiorpoint import LPSolver, solve_lp
from interiorpoint.utils.config import SolverConfig


def _gen_lp(n, m, k, seed=1):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    c = rng.uniform(-2, 2, n)
    return c, A, A @ x_feas, C, C @ x_feas


def _scipy_opt(c, A, b, C, d, lb=-3.0, ub=3.0):
    n = len(c)
    res = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=[(lb, ub)] * n, method="highs")
    assert res.status == 0
    return res.fun


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lp_random_vs_scipy(seed):
    c, A, b, C, d = _gen_lp(60, 48, 12, seed)
    ls = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                  mu=15, t0=1.0)
    val = ls.solve()
    ref = _scipy_opt(c, A, b, C, d)
    assert abs(val - ref) / abs(ref) < 1e-5
    assert np.linalg.norm(A @ np.asarray(ls.xstar) - b) < 1e-4 * 60


@pytest.mark.parametrize("method", ["cholesky", "np_solve", "np_lstsq",
                                    "kkt", "direct"])
def test_lp_linear_solve_methods(method):
    """All reference linear_solve_method spellings reach the same optimum
    (reference: LPSolver.py:371-448 class dispatch)."""
    c, A, b, C, d = _gen_lp(30, 24, 6, seed=7)
    ls = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                  linear_solve_method=method)
    val = ls.solve()
    ref = _scipy_opt(c, A, b, C, d)
    assert abs(val - ref) / abs(ref) < 1e-5


def test_lp_bounds_only_diagonal_path():
    """No dense inequality block → diagonal-Hessian fast path
    (reference: FunctionManager.py:283-292, NewtonSolverDiagonal*)."""
    rng = np.random.default_rng(5)
    n, m = 40, 30
    A = rng.uniform(-2, 2, (m, n))
    x_feas = rng.uniform(-2, 2, n)
    b = A @ x_feas
    c = rng.uniform(-2, 2, n)
    ls = LPSolver(c=c, A=A, b=b, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9)
    val = ls.solve()
    res = linprog(c, A_eq=A, b_eq=b, bounds=[(-3, 3)] * n, method="highs")
    # The outer loop accepts iterates with ‖Ax−b‖ up to 1e-4·n (reference
    # gate, LPSolver.py:600), so the objective can undershoot slightly.
    assert abs(val - res.fun) / abs(res.fun) < 1e-4
    assert np.linalg.norm(A @ np.asarray(ls.xstar) - b) < 1e-4 * n


def test_lp_no_equality_feasible_engine():
    """Inequalities + bounds only → feasible-start Newton engine
    (reference: NewtonSolver.py via LPSolver.py:436-446)."""
    rng = np.random.default_rng(6)
    n, k = 30, 12
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    d = C @ x_feas
    c = rng.uniform(-2, 2, n)
    ls = LPSolver(c=c, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9)
    val = ls.solve()
    res = linprog(c, A_ub=C, b_ub=d, bounds=[(-3, 3)] * n, method="highs")
    assert abs(val - res.fun) / abs(res.fun) < 1e-5


def test_lp_phase1_runs_from_infeasible_x0():
    """x0 violating Cx ≤ d must route through phase one
    (reference: LPSolver.py:546-560)."""
    rng = np.random.default_rng(8)
    n, k = 20, 30
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-0.5, 0.5, n)
    d = C @ x_feas  # tight: the default x0 = midpoint of bounds is infeasible
    c = rng.uniform(-2, 2, n)
    x_bad = x_feas + 2.0  # strictly infeasible start
    ls = LPSolver(c=c, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                  x0=None)
    val = ls.solve(x0=np.clip(x_bad, -2.9, 2.9))
    res = linprog(c, A_ub=C, b_ub=d, bounds=[(-3, 3)] * n, method="highs")
    assert abs(val - res.fun) / abs(res.fun) < 1e-5


def test_lp_dual_variables():
    """λ* ≥ 0 and approximate complementary slackness
    (reference: LPSolver.py:641-646)."""
    c, A, b, C, d = _gen_lp(30, 24, 6, seed=9)
    ls = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                  get_dual_variables=True)
    ls.solve()
    lam = ls.lam_star
    assert lam is not None and (lam > 0).all()
    x = np.asarray(ls.xstar)
    slacks = np.concatenate([d - C @ x, 3 - x, x + 3])
    assert (lam * slacks).max() < 1e-6


def test_lp_infeasible_detection():
    """check_cvxpy (scipy fallback) raises on infeasible instances
    (reference: LPSolver.py:150-154)."""
    c = np.array([1.0, 1.0])
    C = np.array([[1.0, 0.0], [-1.0, 0.0]])
    d = np.array([-1.0, -1.0])  # x0 <= -1 and -x0 <= -1: empty
    with pytest.raises(ValueError, match="infeasible"):
        LPSolver(c=c, C=C, d=d, lower_bound=None, upper_bound=None,
                 suppress_print=True, check_cvxpy=True)


def test_lp_input_validation():
    c = np.ones(3)
    with pytest.raises(ValueError, match="Both A and b"):
        LPSolver(c=c, A=np.eye(3), suppress_print=True, check_cvxpy=False)
    with pytest.raises(ValueError, match="agreeing dimensions"):
        LPSolver(c=c, A=np.eye(3), b=np.ones(2), suppress_print=True,
                 check_cvxpy=False)
    with pytest.raises(ValueError, match="Lower bound must be lower"):
        LPSolver(c=c, lower_bound=1.0, upper_bound=0.0,
                 suppress_print=True, check_cvxpy=False)


def test_lp_resolve_cached():
    """solve(resolve=False) returns the cached optimum
    (reference: LPSolver.py:525-526)."""
    c, A, b, C, d = _gen_lp(20, 16, 4, seed=11)
    ls = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False)
    v1 = ls.solve()
    assert ls.solve(resolve=False) == v1


def test_solve_lp_functional():
    c, A, b, C, d = _gen_lp(25, 20, 5, seed=12)
    cfg = SolverConfig(epsilon=1e-9, t0=1.0, dtype="float64")
    res = solve_lp(c, A, b, C, d, lb=-3.0, ub=3.0, cfg=cfg)
    ref = _scipy_opt(c, A, b, C, d)
    assert abs(float(res.value) - ref) / abs(ref) < 1e-5
    assert int(res.outer_iters) > 0


def test_lp_float32_coarse():
    """float32 is an experimental speed mode: barrier KKT systems exceed
    f32 conditioning once t is large, so only coarse accuracy is reachable.
    The production default is float64, matching the reference's NumPy/CuPy
    precision."""
    c, A, b, C, d = _gen_lp(40, 32, 8, seed=13)
    ls = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-4,
                  t0=1.0, dtype="float32")
    val = ls.solve()
    ref = _scipy_opt(c, A, b, C, d)
    assert abs(val - ref) / abs(ref) < 5e-2


def _parity_lp(seed=11, n=30, m=12, k=20):
    """Reference-recipe LP with a 0.5 margin on Cx ≤ d, so x_feas is a
    strictly interior start, and a start that violates Cx ≤ d inside the
    bounds, so the barrier runs phase one from it."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    c = rng.uniform(-2, 2, n)
    d = C @ x_feas + 0.5
    x_bad = 2.5 * np.sign(C[0])
    assert (C @ x_bad > d).any()
    return c, A, A @ x_feas, C, d, x_feas, x_bad


@pytest.mark.parametrize("start", ["feasible", "phase_one"])
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("algorithm", ["barrier", "pd"])
def test_lp_engine_parity_vs_highs(algorithm, reduced, start):
    """Every LP route — barrier or pd, null-space or full-space, from an
    interior or an infeasible start — reaches the float64 HiGHS optimum."""
    c, A, b, C, d, x_feas, x_bad = _parity_lp()
    ls = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                  algorithm=algorithm, reduced=reduced)
    val = ls.solve(x0=x_feas if start == "feasible" else x_bad)
    ref = _scipy_opt(c, A, b, C, d)
    assert abs(val - ref) <= 1e-6 * (1 + abs(ref))
    x = np.asarray(ls.xstar)
    assert np.abs(A @ x - b).max() < 1e-6
    assert (C @ x - d).max() < 1e-7
    if algorithm == "barrier":
        assert ls.last_metrics["phase1_ran"] == (start == "phase_one")
