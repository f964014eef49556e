"""Property-based shape/bound-mode sweep across the IPM drivers.

Each instance is constructed bounded-by-duality (pick strictly positive
multipliers first, then back out a cost vector that satisfies dual
feasibility), so every combination of {equalities, inequalities, lower
bound only, upper bound only, both, tiny dims} is solvable; the
optimum is cross-checked with HiGHS (LP) / the KKT certificate
(utils/certify.py).  This hunts the class of bug hand-written tests
miss: static-shape edge cases (k=0 segments, n=1 vectors-vs-scalars,
one-sided bound representations) in the oracle/dispatch plumbing."""
import numpy as np
import pytest
from scipy.optimize import linprog

from interiorpoint import LPSolver, QPSolver, SOCPSolver, certify

# (n, m_eq, k_ineq, lb?, ub?) — every structural combination the LP/QP
# constructors accept, including scalar-ish dims
SHAPES = [
    (1, 0, 2, True, True),
    (2, 1, 0, True, True),
    (3, 0, 0, True, True),        # box-only (diagonal fast path)
    (4, 2, 3, False, True),       # upper bound only
    (4, 2, 3, True, False),       # lower bound only
    (5, 3, 1, True, True),
    (6, 0, 8, False, True),
    (7, 5, 4, True, True),
    (2, 1, 1, True, False),
    (8, 2, 0, True, False),
]


def _gen_lp(n, m, k, has_lb, has_ub, seed):
    """Bounded-by-duality LP: choose x*, strictly positive multipliers
    on a chosen active set, and back out c = −Cᵀλ + μ_lb − μ_ub − Aᵀv."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-2, 2, (m, n)) if m else None
    C = rng.uniform(-2, 2, (k, n)) if k else None
    xf = rng.uniform(-0.5, 0.5, n)
    b = A @ xf if m else None
    d = C @ xf + rng.uniform(0.2, 1.0, k) if k else None
    lb = -2.0 if has_lb else None
    ub = 2.0 if has_ub else None
    lam = rng.uniform(0.1, 1.0, k) if k else np.zeros(0)
    mu_lb = rng.uniform(0.1, 1.0, n) if has_lb else np.zeros(n)
    mu_ub = rng.uniform(0.1, 1.0, n) if has_ub else np.zeros(n)
    v = rng.uniform(-1, 1, m) if m else np.zeros(0)
    c = mu_lb - mu_ub
    if k:
        c -= C.T @ lam
    if m:
        c -= A.T @ v
    return dict(c=c, A=A, b=b, C=C, d=d, lb=lb, ub=ub), xf


@pytest.mark.parametrize("n,m,k,has_lb,has_ub", SHAPES)
def test_lp_shape_sweep(n, m, k, has_lb, has_ub):
    p, xf = _gen_lp(n, m, k, has_lb, has_ub, seed=1000 + n * 31 + m)
    ref = linprog(p["c"], A_ub=p["C"], b_ub=p["d"], A_eq=p["A"],
                  b_eq=p["b"], bounds=[(p["lb"], p["ub"])] * n,
                  method="highs")
    assert ref.status == 0, (ref.status, ref.message)
    s = LPSolver(c=p["c"], A=p["A"], b=p["b"], C=p["C"], d=p["d"],
                 lower_bound=p["lb"] if has_lb else -np.inf,
                 upper_bound=p["ub"] if has_ub else None,
                 suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                 t0=1, x0=xf)
    val = s.solve()
    assert val == pytest.approx(ref.fun, rel=2e-6, abs=2e-6)
    cert = certify(s)
    assert cert.ok(1e-5), cert


@pytest.mark.parametrize("n,m,k,has_lb,has_ub", SHAPES)
def test_qp_shape_sweep(n, m, k, has_lb, has_ub):
    rng = np.random.default_rng(77 + n)
    p, xf = _gen_lp(n, m, k, has_lb, has_ub, seed=2000 + n * 17 + k)
    M = rng.uniform(-1, 1, (n, n))
    P = M.T @ M + np.eye(n)   # strictly convex ⇒ bounded regardless of c
    s = QPSolver(P=P, q=p["c"], A=p["A"], b=p["b"], C=p["C"], d=p["d"],
                 lower_bound=p["lb"] if has_lb else -np.inf,
                 upper_bound=p["ub"] if has_ub else None,
                 suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                 t0=1, x0=xf)
    s.solve()
    cert = certify(s)
    assert cert.ok(1e-5), cert


@pytest.mark.parametrize("K,M,n,m_eq,bounds", [
    (1, 1, 2, 0, True),     # single 1-row cone
    (1, 3, 4, 2, False),
    (2, 1, 1, 0, True),     # n=1
    (4, 2, 5, 1, True),
    (3, 5, 6, 0, False),
])
def test_socp_shape_sweep(K, M, n, m_eq, bounds):
    rng = np.random.default_rng(300 + 7 * K + M)
    A = [rng.standard_normal((M, n)) for _ in range(K)]
    b = [rng.standard_normal(M) for _ in range(K)]
    c = [rng.standard_normal(n) for _ in range(K)]
    x0 = rng.standard_normal(n) * 0.1
    d = [np.linalg.norm(A[k] @ x0 + b[k]) - c[k] @ x0 + 1.0
         for k in range(K)]
    Mq = rng.uniform(-1, 1, (n, n))
    P = Mq.T @ Mq + np.eye(n)
    q = rng.uniform(-1, 1, n)
    F = rng.standard_normal((m_eq, n)) if m_eq else None
    g = F @ x0 if m_eq else None
    lb, ub = (-3.0, 3.0) if bounds else (None, None)
    s = SOCPSolver(P=P, q=q, A=A, b=b, c=c, d=d, F=F, g=g,
                   lower_bound=lb, upper_bound=ub, suppress_print=True,
                   check_cvxpy=False, epsilon=1e-9, t0=1, x0=x0)
    s.solve()
    cert = certify(s)
    assert cert.ok(1e-5), cert
    # independent SLSQP cross-check
    from scipy.optimize import minimize
    cons = [{"type": "ineq",
             "fun": lambda x, k=k: (c[k] @ x + d[k])
             - np.linalg.norm(A[k] @ x + b[k])} for k in range(K)]
    if m_eq:
        cons.append({"type": "eq", "fun": lambda x: F @ x - g})
    ref = minimize(lambda x: 0.5 * x @ P @ x + q @ x, x0,
                   method="SLSQP", constraints=cons,
                   bounds=([(lb, ub)] * n if bounds else None),
                   options={"maxiter": 500, "ftol": 1e-12})
    if ref.success:   # SLSQP itself can fail on tiny degenerate shapes
        assert s.value == pytest.approx(ref.fun, rel=1e-5, abs=1e-5)
