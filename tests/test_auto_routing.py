"""algorithm="auto": per-class engine routing (LP -> Mehrotra pd;
QP -> pd; SOCP -> barrier).  The explicit "barrier"/"pd" selections stay
untouched — auto exists so the chosen engine is one keyword away."""

import numpy as np
import pytest

from interiorpoint import LPSolver, QPSolver, SOCPSolver


def _lp(algo, n=120):
    rng = np.random.default_rng(5)
    m, k = int(0.8 * n), int(0.2 * n)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-2, 2, n)
    c = rng.uniform(-2, 2, n)
    return LPSolver(c=c, A=A, b=A @ xf, C=C, d=C @ xf + 0.5,
                    lower_bound=-3, upper_bound=3, suppress_print=True,
                    check_cvxpy=False, epsilon=1e-6, t0=1,
                    algorithm=algo), c, A, C, xf


def test_lp_auto_routes_to_pd_and_matches_highs():
    from scipy.optimize import linprog
    s, c, A, C, xf = _lp("auto")
    assert s._auto_algorithm() == "pd"
    val = s.solve()
    ref = linprog(c, A_ub=C, b_ub=C @ xf + 0.5, A_eq=A, b_eq=A @ xf,
                  bounds=[(-3, 3)] * 120, method="highs")
    assert ref.success
    assert val == pytest.approx(ref.fun, rel=1e-6)


def test_qp_auto_routes_by_size():
    rng = np.random.default_rng(7)
    n, m = 60, 48
    Pp = rng.uniform(-2, 2, (m, n))
    P = Pp.T @ Pp + np.eye(n)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (12, n))
    xf = rng.uniform(-2, 2, n)
    q = QPSolver(P=P, q=rng.uniform(-2, 2, n), A=A, b=A @ xf, C=C,
                 d=C @ xf + 0.5, lower_bound=-3, upper_bound=3,
                 suppress_print=True, check_cvxpy=False, epsilon=1e-8,
                 t0=0.01, algorithm="auto")
    assert q._auto_algorithm() == "pd"
    q.solve()
    assert q.optimal


def test_socp_auto_routes_to_barrier():
    rng = np.random.default_rng(9)
    K, M, n = 3, 30, 40
    A = [rng.standard_normal((M, n)) for _ in range(K)]
    b = [rng.standard_normal(M) for _ in range(K)]
    c = [rng.standard_normal(n) for _ in range(K)]
    x0 = rng.standard_normal(n) * 0.1
    d = [float(np.linalg.norm(A[i] @ x0 + b[i]) - c[i] @ x0 + 1.0)
         for i in range(K)]
    s = SOCPSolver(A=A, b=b, c=c, d=d, q=rng.uniform(-1, 1, n), x0=x0,
                   suppress_print=True, check_cvxpy=False, epsilon=1e-6,
                   t0="auto", algorithm="auto")
    assert s._auto_algorithm() == "barrier"
    s.solve()
    assert s.optimal


def test_rejects_unknown_algorithm():
    with pytest.raises(ValueError, match="algorithm"):
        _lp("fastest")
