"""SOCP tests: oracle autodiff cross-checks, analytic projection problems,
SLSQP ground truth, phase-one routing, and LP-equivalence for degenerate
cones."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.optimize import minimize

from interiorpoint.models.problem import make_socp
from interiorpoint.models.socp import SOCPSolver, solve_socp
from interiorpoint.ops.socp import (
    make_phase1_socp_oracle,
    make_socp_oracle,
    socp_full_slacks,
)

RNG = np.random.default_rng(0)


def _random_socp(n=8, m=5, K=3, bounds=False, seed=0):
    """Feasible-by-construction random SOCP
    (reference recipe: testSolver.py:862-880)."""
    rng = np.random.default_rng(seed)
    Pp = rng.uniform(-1, 1, (m, n))
    P = Pp.T @ Pp + np.eye(n)
    q = rng.uniform(-1, 1, n)
    x0 = rng.normal(size=n) * 0.3
    A, b, c, d = [], [], [], []
    for _ in range(K):
        A.append(rng.normal(size=(m, n)))
        b.append(rng.normal(size=m))
        c.append(rng.normal(size=n))
        d.append(np.linalg.norm(A[-1] @ x0 + b[-1]) - c[-1] @ x0 + 1.0)
    lb, ub = (-3.0, 3.0) if bounds else (None, None)
    return P, q, A, b, c, d, lb, ub, x0


def _interior_point(prob, seed=1):
    """A strictly feasible x for oracle evaluation (scaled-down x0=0 works
    for the generator above since d was padded by +1)."""
    return np.zeros(prob.n)


def test_socp_oracle_grad_vs_autodiff():
    P, q, A, b, c, d, lb, ub, x0 = _random_socp(bounds=True)
    prob = make_socp(A, b, c, d, P, q, lb=lb, ub=ub)
    oracle = make_socp_oracle(prob)
    x = jnp.asarray(x0)
    t = jnp.asarray(2.1)
    # the barrier's log excludes the appended rhs slacks, so autodiff of
    # newton_obj is the exact gradient
    g_auto = jax.grad(lambda xx: oracle.newton_obj(xx, t))(x)
    np.testing.assert_allclose(oracle.grad(x, t), g_auto, rtol=1e-7,
                               atol=1e-9)


def test_socp_oracle_hess_gauss_newton_identity():
    """oracle.hess = autodiff hess + Σ_k 2·w_k·c_k c_kᵀ: the reference uses
    +ccᵀ where the analytic Hessian has −ccᵀ
    (reference: FunctionManager.py:1132-1136)."""
    P, q, A, b, c, d, lb, ub, x0 = _random_socp()
    prob = make_socp(A, b, c, d, P, q)
    oracle = make_socp_oracle(prob)
    x = jnp.asarray(x0)
    t = jnp.asarray(1.7)
    H_auto = jax.hessian(lambda xx: oracle.newton_obj(xx, t))(x)
    lhs = np.einsum("kmn,n->km", prob.A, x0) + np.asarray(prob.b)
    rhs = np.asarray(prob.c) @ x0 + np.asarray(prob.d)
    slack = rhs**2 - (lhs**2).sum(-1)
    w = 2.0 / (slack + 1e-12)
    correction = np.einsum("k,kn,kl->nl", 2 * w, np.asarray(prob.c),
                           np.asarray(prob.c))
    np.testing.assert_allclose(np.asarray(oracle.hess(x, t)),
                               np.asarray(H_auto) + correction,
                               rtol=1e-6, atol=1e-7)


def test_socp_phase1_oracle_vs_autodiff():
    P, q, A, b, c, d, lb, ub, x0 = _random_socp(bounds=True)
    prob = make_socp(A, b, c, d, P, q, lb=lb, ub=ub)
    oracle = make_phase1_socp_oracle(prob)
    z = jnp.concatenate([jnp.asarray(x0), jnp.asarray([4.0])])
    t = jnp.asarray(1.1)
    g_auto = jax.grad(lambda zz: oracle.newton_obj(zz, t))(z)
    np.testing.assert_allclose(oracle.grad(z, t), g_auto, rtol=1e-7,
                               atol=1e-9)
    # Hessian: xx-block carries the same +ccᵀ Gauss-Newton deviation;
    # border and ss entries are exact.
    H_auto = np.asarray(jax.hessian(lambda zz: oracle.newton_obj(zz, t))(z))
    H = np.asarray(oracle.hess(z, t))
    np.testing.assert_allclose(H[-1, :], H_auto[-1, :], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(H[:, -1], H_auto[:, -1], rtol=1e-6, atol=1e-9)


def test_socp_linesearch_candidates_match_pointwise():
    P, q, A, b, c, d, lb, ub, x0 = _random_socp(bounds=True)
    prob = make_socp(A, b, c, d, P, q, lb=lb, ub=ub)
    oracle = make_socp_oracle(prob)
    x = jnp.asarray(x0)
    dx = jnp.asarray(RNG.uniform(-0.5, 0.5, prob.n))
    t = jnp.asarray(3.0)
    sigmas = jnp.asarray(0.6) ** jnp.arange(10, dtype=x.dtype)
    ok, grads = oracle.ls_grads(x, dx, t, sigmas)
    ok2, nobjs = oracle.ls_objs(x, dx, t, sigmas)
    for j, s in enumerate(np.asarray(sigmas)):
        xs = x + s * dx
        feasible = float(oracle.min_slack(xs)) > 0
        assert bool(ok[j]) == feasible
        assert bool(ok2[j]) == feasible
        if feasible:
            np.testing.assert_allclose(grads[:, j], oracle.grad(xs, t),
                                       rtol=1e-7, atol=1e-9)
            np.testing.assert_allclose(nobjs[j], oracle.newton_obj(xs, t),
                                       rtol=1e-8)


def test_socp_projection_analytic():
    """min ½‖x−p‖² s.t. ‖x‖ ≤ r → x* = p·min(1, r/‖p‖)."""
    n = 10
    p = RNG.normal(size=n) * 2
    r = 1.5
    s = SOCPSolver(P=np.eye(n), q=-p, A=[np.eye(n)], b=[np.zeros(n)],
                   c=[np.zeros(n)], d=[r], lower_bound=None,
                   upper_bound=None, suppress_print=True, check_cvxpy=False,
                   epsilon=1e-9, max_inner_iters=100, x0=np.zeros(n))
    val = s.solve()
    x_star = p * min(1, r / np.linalg.norm(p))
    ref = 0.5 * x_star @ x_star - p @ x_star
    assert abs(val - ref) < 1e-7
    assert np.linalg.norm(np.asarray(s.xstar) - x_star, np.inf) < 1e-6


@pytest.mark.parametrize("seed", [3, 4])
def test_socp_random_vs_slsqp(seed):
    P, q, A, b, c, d, lb, ub, x0 = _random_socp(n=8, m=5, K=3, seed=seed)
    s = SOCPSolver(P=P, q=q, A=A, b=b, c=c, d=d, lower_bound=None,
                   upper_bound=None, suppress_print=True, check_cvxpy=False,
                   epsilon=1e-9, max_inner_iters=100, x0=x0)
    val = s.solve()

    cons = [{"type": "ineq",
             "fun": (lambda x, Ai=Ai, bi=bi, ci=ci, di=di:
                     ci @ x + di - np.linalg.norm(Ai @ x + bi))}
            for Ai, bi, ci, di in zip(A, b, c, d)]
    res = minimize(lambda x: 0.5 * x @ P @ x + q @ x, x0, method="SLSQP",
                   constraints=cons, options={"maxiter": 500, "ftol": 1e-12})
    assert res.success
    assert abs(val - res.fun) / max(abs(res.fun), 1.0) < 1e-5


def test_socp_with_equality_vs_slsqp():
    P, q, A, b, c, d, lb, ub, x0 = _random_socp(n=8, m=5, K=2, seed=6)
    F = RNG.normal(size=(2, 8))
    g = F @ x0
    s = SOCPSolver(P=P, q=q, A=A, b=b, c=c, d=d, F=F, g=g,
                   lower_bound=None, upper_bound=None, suppress_print=True,
                   check_cvxpy=False, epsilon=1e-9, max_inner_iters=100,
                   x0=x0)
    val = s.solve()
    cons = [{"type": "ineq",
             "fun": (lambda x, Ai=Ai, bi=bi, ci=ci, di=di:
                     ci @ x + di - np.linalg.norm(Ai @ x + bi))}
            for Ai, bi, ci, di in zip(A, b, c, d)]
    cons.append({"type": "eq", "fun": lambda x: F @ x - g})
    res = minimize(lambda x: 0.5 * x @ P @ x + q @ x, x0, method="SLSQP",
                   constraints=cons, options={"maxiter": 500, "ftol": 1e-12})
    assert res.success
    assert abs(val - res.fun) / max(abs(res.fun), 1.0) < 1e-4
    assert np.linalg.norm(F @ np.asarray(s.xstar) - g) < 1e-3


def test_socp_phase1_from_infeasible_x0():
    """Default x0 infeasible for the cones → phase one must run
    (reference: SOCPSolver.py:647-661)."""
    P, q, A, b, c, d, lb, ub, x0 = _random_socp(n=8, m=5, K=3, seed=8)
    # make cones tight around x0 so perturbed starts are infeasible
    d = [float(di) - 0.9 for di in d]
    s = SOCPSolver(P=P, q=q, A=A, b=b, c=c, d=d, lower_bound=None,
                   upper_bound=None, suppress_print=True, check_cvxpy=False,
                   epsilon=1e-9, max_inner_iters=100, x0=x0)
    # verify solver solves from its (feasible) x0 first
    v_ref = s.solve()
    # Find a start violating a cone slack while keeping every rhs positive:
    # phase one keeps the appended rhs slacks un-shifted, so it can only
    # recover starts with cᵢᵀx + dᵢ > 0 (reference parity,
    # FunctionManager.py:1258-1262).
    prob = make_socp(A, b, c, d, P, q)
    rng = np.random.default_rng(99)
    x_bad = None
    for scale in np.linspace(0.05, 1.0, 40):
        cand = x0 + scale * rng.standard_normal(8)
        sl = np.asarray(socp_full_slacks(prob, jnp.asarray(cand)))
        K = 3
        cone_sl, rhs = sl[:K], sl[-K:]
        if cone_sl.min() < 0 and rhs.min() > 0.05:
            x_bad = cand
            break
    assert x_bad is not None, "could not construct a recoverable bad start"
    v2 = s.solve(x0=x_bad)
    assert abs(v2 - v_ref) / max(abs(v_ref), 1.0) < 1e-4


def test_socp_diagonal_cone_input():
    """1-D cone matrices are interpreted as diagonal (reference compresses
    diagonal A to 1-D; SOCPSolver.py:285-292)."""
    n = 6
    diag = np.linspace(1, 2, n)
    p = RNG.normal(size=n)
    r = 2.0
    # ||diag(a) x|| <= r  vs dense equivalent
    s1 = SOCPSolver(P=np.eye(n), q=-p, A=[diag], b=[np.zeros(n)],
                    c=[np.zeros(n)], d=[r], lower_bound=None,
                    upper_bound=None, suppress_print=True,
                    check_cvxpy=False, epsilon=1e-9, max_inner_iters=100,
                    x0=np.zeros(n))
    s2 = SOCPSolver(P=np.eye(n), q=-p, A=[np.diag(diag)], b=[np.zeros(n)],
                    c=[np.zeros(n)], d=[r], lower_bound=None,
                    upper_bound=None, suppress_print=True,
                    check_cvxpy=False, epsilon=1e-9, max_inner_iters=100,
                    x0=np.zeros(n))
    assert abs(s1.solve() - s2.solve()) < 1e-9


def test_socp_requires_cones():
    with pytest.raises(ValueError, match="No cone contraints"):
        SOCPSolver(P=np.eye(3), q=np.ones(3), suppress_print=True,
                   check_cvxpy=False)


def test_solve_socp_functional():
    P, q, A, b, c, d, lb, ub, x0 = _random_socp(n=6, m=4, K=2, seed=10)
    res = solve_socp(A, b, c, d, P, q, epsilon=1e-9, max_inner_iters=100,
                     dtype="float64", x0=x0)
    assert np.isfinite(float(res.value))
    assert int(res.outer_iters) > 0


def test_socp_phase1_recovers_from_negative_rhs_start():
    """The reference's phase one cannot start from x0 with c_i.x + d_i < 0
    (unshifted rhs domain entries, FunctionManager.py:1258-1262); ours
    shifts them by s and must recover from far-out starts."""
    rng = np.random.default_rng(21)
    n, m, K = 40, 12, 3
    Pp = rng.uniform(-1, 1, (m, n))
    P = Pp.T @ Pp + np.eye(n)
    q = rng.uniform(-1, 1, n)
    xf = rng.normal(size=n) * 0.1
    A, b, c, d = [], [], [], []
    for _ in range(K):
        A.append(rng.normal(size=(m, n)))
        b.append(rng.normal(size=m))
        c.append(rng.normal(size=n))
        d.append(np.linalg.norm(A[-1] @ xf + b[-1]) - c[-1] @ xf + 1.0)
    x0_bad = xf + 8.0 * rng.normal(size=n)
    assert min(ci @ x0_bad + di for ci, di in zip(c, d)) < 0  # rhs < 0 start

    s = SOCPSolver(P=P, q=q, A=A, b=b, c=c, d=d,
                   lower_bound=None, upper_bound=None, suppress_print=True,
                   check_cvxpy=False, epsilon=1e-8, x0=x0_bad, t0="auto")
    val = s.solve()

    def f(x):
        return 0.5 * x @ (P @ x) + q @ x

    cons = [
        {"type": "ineq",
         "fun": (lambda x, Ai=Ai, bi=bi, ci=ci, di=di:
                 ci @ x + di - np.linalg.norm(Ai @ x + bi))}
        for Ai, bi, ci, di in zip(A, b, c, d)
    ]
    ref = minimize(f, xf, constraints=cons, method="SLSQP",
                   options={"maxiter": 800, "ftol": 1e-12})
    assert abs(val - ref.fun) <= 1e-5 * max(1.0, abs(ref.fun))


@pytest.mark.parametrize("start", ["feasible", "phase_one"])
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("algorithm", ["barrier", "pd"])
def test_socp_engine_parity_vs_slsqp(algorithm, reduced, start):
    """Every SOCP route — barrier or pd, null-space or full-space, from an
    interior or a cone-infeasible start — reaches the SLSQP optimum."""
    P, q, A, b, c, d, lb, ub, x0 = _random_socp(n=10, m=5, K=3, seed=8)
    rng = np.random.default_rng(9)
    F = rng.normal(size=(3, 10))
    g = F @ x0
    cons = [{"type": "ineq",
             "fun": (lambda x, Ai=Ai, bi=bi, ci=ci, di=di:
                     ci @ x + di - np.linalg.norm(Ai @ x + bi))}
            for Ai, bi, ci, di in zip(A, b, c, d)]
    cons.append({"type": "eq", "fun": lambda x: F @ x - g})
    ref = minimize(lambda x: 0.5 * x @ P @ x + q @ x, x0, method="SLSQP",
                   constraints=cons,
                   options={"maxiter": 1000, "ftol": 1e-12})
    assert ref.success
    # x0 is interior to every cone (margin 1); 40 units away along a
    # random direction some cone is violated
    start_x = x0 if start == "feasible" else x0 + 40.0 * rng.normal(size=10)
    feasible = all(f["fun"](start_x) > 0 for f in cons[:-1])
    assert feasible == (start == "feasible")
    s = SOCPSolver(P=P, q=q, A=A, b=b, c=c, d=d, F=F, g=g,
                   lower_bound=None, upper_bound=None, suppress_print=True,
                   check_cvxpy=False, epsilon=1e-9, max_inner_iters=100,
                   x0=start_x, algorithm=algorithm, reduced=reduced)
    val = s.solve()
    assert abs(val - ref.fun) <= 1e-6 * (1 + abs(ref.fun))
    assert np.abs(F @ np.asarray(s.xstar) - g).max() < 1e-6


@pytest.mark.parametrize("bytes_limit,cached", [(2**40, True), (2**10, False)])
def test_socp_curvature_cache_follows_device_memory(monkeypatch, bytes_limit,
                                                    cached):
    """The per-cone AᵀA + ccᵀ cache is kept only when it fits a share of
    the device's reported memory limit; both forms give one Hessian."""
    from interiorpoint.ops import socp as socp_ops
    from interiorpoint.utils import memory

    P, q, A, b, c, d, lb, ub, x0 = _random_socp(bounds=True)
    prob = make_socp(A, b, c, d, P, q, lb=lb, ub=ub)
    H_ref = np.asarray(make_socp_oracle(prob).hess(jnp.asarray(x0),
                                                   jnp.asarray(2.0)))
    monkeypatch.setattr(memory, "device_bytes_limit", lambda: bytes_limit)
    assert (socp_ops._make_ata_cct(prob) is not None) == cached
    H = np.asarray(make_socp_oracle(prob).hess(jnp.asarray(x0),
                                               jnp.asarray(2.0)))
    np.testing.assert_allclose(H, H_ref, rtol=1e-10, atol=1e-10)
