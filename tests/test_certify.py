"""KKT certificates (utils/certify.py): the in-framework analogue of the
reference's CVXPY feasibility check (LPSolver.py:471-505)."""
import numpy as np
import pytest

from interiorpoint import LPSolver, QPSolver, SOCPSolver
from interiorpoint.utils.certify import certify


def _lp(seed=11, n=20, m=14, k=8, **kw):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    return LPSolver(c=c, A=A, b=A @ xf, C=C, d=C @ xf + 0.5,
                    lower_bound=-3, upper_bound=3, suppress_print=True,
                    check_cvxpy=False, epsilon=1e-9, t0=1, **kw)


def test_certify_lp():
    s = _lp()
    s.solve()
    cert = certify(s)
    assert cert.kind == "LPSolver" and cert.polished
    assert cert.ok(1e-6), cert
    assert cert.dual_gap <= 1e-8
    assert cert.complementarity <= 1e-8
    assert cert.objective == pytest.approx(s.value)
    # the raw barrier duals certify too, at their honest (looser)
    # ~sqrt(inner_epsilon) stationarity accuracy
    raw = certify(s, polish=False)
    assert not raw.polished
    assert raw.ok(5e-3), raw
    assert cert.stationarity < raw.stationarity


def test_certify_lp_with_duals():
    """v* from the solver (get_dual_variables) must certify as well as
    the least-squares fit."""
    s = _lp(get_dual_variables=True)
    s.solve()
    assert certify(s).ok(1e-5)
    # polish=False is the branch that actually consumes solver.v_star
    # (polish refits v itself): the solver-provided equality dual must
    # certify at the analytic duals' honest tolerance
    assert certify(s, polish=False).ok(5e-3)


def test_certify_qp():
    rng = np.random.default_rng(5)
    n, m = 16, 10
    M = rng.uniform(-1, 1, (n, n))
    P = M.T @ M + np.eye(n)
    q = rng.uniform(-1, 1, n)
    A = rng.uniform(-2, 2, (m, n))
    xf = rng.uniform(-1, 1, n)
    s = QPSolver(P=P, q=q, A=A, b=A @ xf, lower_bound=-3, upper_bound=3,
                 suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                 t0=1)
    s.solve()
    cert = certify(s)
    assert cert.ok(1e-5), cert


def test_certify_socp():
    rng = np.random.default_rng(7)
    n, K, M_rows = 12, 3, 5
    A = [rng.standard_normal((M_rows, n)) for _ in range(K)]
    b = [rng.standard_normal(M_rows) for _ in range(K)]
    c = [rng.standard_normal(n) for _ in range(K)]
    x0 = rng.standard_normal(n) * 0.1
    d = [np.linalg.norm(A[k] @ x0 + b[k]) - c[k] @ x0 + 1.0
         for k in range(K)]
    Pq = rng.uniform(-1, 1, (n, n))
    P = Pq.T @ Pq + np.eye(n)
    q = rng.uniform(-1, 1, n)
    s = SOCPSolver(P=P, q=q, A=A, b=b, c=c, d=d, lower_bound=-3,
                   upper_bound=3, suppress_print=True, check_cvxpy=False,
                   epsilon=1e-9, t0=1, x0=x0)
    s.solve()
    cert = certify(s)
    assert cert.kind == "SOCPSolver"
    assert cert.ok(1e-5), cert


def test_certify_rejects_non_optimum_and_unsolved():
    s = _lp()
    with pytest.raises(ValueError, match="solved"):
        certify(s)
    s.solve()
    good = certify(s)
    # a strictly feasible but non-optimal point fails stationarity by a
    # wide margin (the ok() check separates optima from interior points)
    rng = np.random.default_rng(11)
    n = 20
    A = np.asarray(s._eq[0])
    xf = np.asarray(s.xstar)
    # project a perturbation into the equality null space to stay
    # eq-feasible while leaving the optimum
    p = rng.standard_normal(n)
    p = p - A.T @ np.linalg.lstsq(A @ A.T, A @ p, rcond=None)[0]
    x_off = xf + 1e-2 * p
    bad = certify(s, x=x_off)
    assert bad.eq_residual < 1e-8
    assert bad.stationarity > 10 * good.stationarity
