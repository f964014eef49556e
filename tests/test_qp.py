"""QP end-to-end tests.  Ground truth: exact active-set polish (solve the
equality-constrained QP on the active set identified by the IPM) and
KKT-residual certificates — CVXPY-free analogues of the reference's oracle
comparison (reference: QPSolver.py:457-491)."""

import numpy as np
import pytest

from interiorpoint import QPSolver, solve_qp


def _gen_qp(n, m, k, seed=1):
    """(reference: testSolver.py:503-521) P = MᵀM + I."""
    rng = np.random.default_rng(seed)
    Pp = rng.uniform(-2, 2, (m, n))
    P = Pp.T @ Pp + np.eye(n)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    q = rng.uniform(-2, 2, n)
    return P, q, A, A @ x_feas, C, C @ x_feas


def _active_set_polish(P, q, A, b, C, d, x, lb=-3.0, ub=3.0, tol=1e-6):
    """Exact optimum assuming the IPM's active set; returns the polished
    objective value."""
    n = len(q)
    rows, rhs = [A], [b]
    act = (d - C @ x) < tol
    if act.any():
        rows.append(C[act])
        rhs.append(d[act])
    E = np.eye(n)
    act_u = (ub - x) < tol
    act_l = (x - lb) < tol
    if act_u.any():
        rows.append(E[act_u])
        rhs.append(np.full(act_u.sum(), ub))
    if act_l.any():
        rows.append(E[act_l])
        rhs.append(np.full(act_l.sum(), lb))
    G = np.vstack(rows)
    h = np.concatenate(rhs)
    KKT = np.block([[P, G.T], [G, np.zeros((G.shape[0], G.shape[0]))]])
    sol = np.linalg.lstsq(KKT, np.concatenate([-q, h]), rcond=None)[0]
    xs = sol[:n]
    return 0.5 * xs @ P @ xs + q @ xs, xs


@pytest.mark.parametrize("seed", [1, 2])
def test_qp_random_vs_active_set_polish(seed):
    P, q, A, b, C, d = _gen_qp(40, 30, 8, seed)
    qp = QPSolver(P=P, q=q, A=A, b=b, C=C, d=d, lower_bound=-3,
                  upper_bound=3, suppress_print=True, check_cvxpy=False,
                  epsilon=1e-8, mu=15, t0=0.01, max_inner_iters=100)
    val = qp.solve()
    x = np.asarray(qp.xstar)
    ref, xs = _active_set_polish(P, q, A, b, C, d, x)
    # polished point must itself be feasible for the comparison to be valid
    assert (C @ xs - d).max() < 1e-8 and np.abs(xs).max() <= 3 + 1e-8
    assert abs(val - ref) / max(abs(ref), 1.0) < 1e-6
    # primal feasibility of the IPM solution
    assert np.linalg.norm(A @ x - b) < 1e-3
    assert (C @ x - d).max() < 1e-8


def test_qp_equality_only_analytic():
    """min ½xᵀPx + qᵀx s.t. Ax = b has a closed-form KKT solution."""
    rng = np.random.default_rng(3)
    n, m = 20, 8
    Pp = rng.uniform(-1, 1, (n, n))
    P = Pp.T @ Pp + np.eye(n)
    q = rng.uniform(-1, 1, n)
    A = rng.uniform(-1, 1, (m, n))
    b = A @ rng.uniform(-1, 1, n)
    KKT = np.block([[P, A.T], [A, np.zeros((m, m))]])
    sol = np.linalg.solve(KKT, np.concatenate([-q, b]))
    x_exact = sol[:n]
    ref = 0.5 * x_exact @ P @ x_exact + q @ x_exact

    qp = QPSolver(P=P, q=q, A=A, b=b, lower_bound=None, upper_bound=None,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-8,
                  max_inner_iters=100)
    val = qp.solve()
    assert abs(val - ref) / max(abs(ref), 1.0) < 1e-6


def test_qp_rejects_missing_P():
    """(reference: QPSolver.py:104-107)"""
    with pytest.raises(ValueError, match="LPSolver instead"):
        QPSolver(q=np.ones(3), suppress_print=True, check_cvxpy=False)


def test_qp_bounds_only():
    """Box-constrained strictly convex QP; optimum = clipped unconstrained
    minimizer for diagonal P."""
    n = 10
    P = np.diag(np.linspace(1, 2, n))
    q = np.linspace(-5, 5, n)
    x_unc = -q / np.diag(P)
    x_star = np.clip(x_unc, -1, 1)
    ref = 0.5 * x_star @ P @ x_star + q @ x_star
    qp = QPSolver(P=P, q=q, lower_bound=-1, upper_bound=1,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                  max_inner_iters=100)
    val = qp.solve()
    assert abs(val - ref) / abs(ref) < 1e-6


def test_solve_qp_functional():
    P, q, A, b, C, d = _gen_qp(25, 18, 6, seed=5)
    res = solve_qp(P, q, A, b, C, d, lb=-3.0, ub=3.0,
                   epsilon=1e-8, t0=0.01, max_inner_iters=100,
                   dtype="float64")
    x = np.asarray(res.x)
    ref, _ = _active_set_polish(P, q, A, b, C, d, x)
    assert abs(float(res.value) - ref) / max(abs(ref), 1.0) < 1e-6


def _slsqp_qp(P, q, A, b, C, d, x_start, lb=-3.0, ub=3.0):
    """Plain float64 reference: SciPy's SLSQP on the same QP."""
    from scipy.optimize import minimize

    cons = [{"type": "eq", "fun": lambda x: A @ x - b, "jac": lambda x: A},
            {"type": "ineq", "fun": lambda x: d - C @ x,
             "jac": lambda x: -C}]
    res = minimize(lambda x: 0.5 * x @ P @ x + q @ x, x_start,
                   jac=lambda x: P @ x + q, method="SLSQP",
                   bounds=[(lb, ub)] * len(q), constraints=cons,
                   options={"maxiter": 1000, "ftol": 1e-12})
    assert res.success
    return res.fun


@pytest.mark.parametrize("start", ["feasible", "phase_one"])
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("algorithm", ["barrier", "pd"])
def test_qp_engine_parity_vs_slsqp(algorithm, reduced, start):
    """Every QP route — barrier or pd, null-space or full-space, from an
    interior or an infeasible start — reaches the SLSQP optimum."""
    rng = np.random.default_rng(12)
    n, m, k = 24, 10, 16
    Pp = rng.uniform(-2, 2, (m, n))
    P = Pp.T @ Pp + np.eye(n)
    q = rng.uniform(-2, 2, n)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    b, d = A @ x_feas, C @ x_feas + 0.5
    x_bad = 2.5 * np.sign(C[0])
    assert (C @ x_bad > d).any()
    qp = QPSolver(P=P, q=q, A=A, b=b, C=C, d=d, lower_bound=-3,
                  upper_bound=3, suppress_print=True, check_cvxpy=False,
                  epsilon=1e-9, t0=0.01, max_inner_iters=100,
                  algorithm=algorithm, reduced=reduced)
    val = qp.solve(x0=x_feas if start == "feasible" else x_bad)
    ref = _slsqp_qp(P, q, A, b, C, d, x_feas)
    assert abs(val - ref) <= 1e-6 * (1 + abs(ref))
    x = np.asarray(qp.xstar)
    assert np.abs(A @ x - b).max() < 1e-6
    assert (C @ x - d).max() < 1e-7
    if algorithm == "barrier":
        assert qp.last_metrics["phase1_ran"] == (start == "phase_one")
