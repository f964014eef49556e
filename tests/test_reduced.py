"""Null-space (reduced-space) fast-path tests: the reduced engine must
reproduce the full-space (reference-parity) engine's optima, feasibility,
and duals."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy.optimize import linprog

from interiorpoint import LPSolver, QPSolver, SOCPSolver
from interiorpoint.ops.nullspace import affine_elimination


def _gen_lp(n, m, k, seed=1):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    c = rng.uniform(-2, 2, n)
    return c, A, A @ x_feas, C, C @ x_feas


def test_affine_elimination_basis_quality():
    rng = np.random.default_rng(0)
    m, n = 40, 50
    A = rng.uniform(-2, 2, (m, n))
    b = A @ rng.uniform(-1, 1, n)
    basis = affine_elimination(jnp.asarray(A), jnp.asarray(b))
    N = np.asarray(basis.N)
    assert N.shape == (n, n - m)
    # orthonormal columns
    np.testing.assert_allclose(N.T @ N, np.eye(n - m), atol=1e-10)
    # exact null space and particular solution
    assert np.abs(A @ N).max() < 1e-10
    assert np.linalg.norm(A @ np.asarray(basis.x_p) - b) < 1e-9


def test_lp_reduced_matches_full_and_scipy():
    c, A, b, C, d = _gen_lp(60, 48, 12)
    kw = dict(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
              suppress_print=True, check_cvxpy=False, epsilon=1e-9,
              t0=1.0)
    full = LPSolver(**kw, reduced=False)
    red = LPSolver(**kw, reduced=True)
    assert red._reduced is not None and full._reduced is None
    v_full, v_red = full.solve(), red.solve()
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b, bounds=[(-3, 3)] * 60,
                  method="highs").fun
    assert abs(v_red - ref) / abs(ref) < 1e-5
    assert abs(v_full - ref) / abs(ref) < 1e-5
    x = np.asarray(red.xstar)
    # equalities hold by construction in reduced mode
    assert np.linalg.norm(A @ x - b) < 1e-9
    assert (C @ x - d).max() < 1e-8


def test_lp_reduced_default_auto_enabled():
    c, A, b, C, d = _gen_lp(30, 24, 6, seed=2)
    ls = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False)
    assert ls._reduced is not None


def test_lp_reduced_duals():
    c, A, b, C, d = _gen_lp(30, 24, 6, seed=3)
    ls = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                  get_dual_variables=True, reduced=True)
    ls.solve()
    lam, v = ls.lam_star, ls.v_star
    assert lam is not None and v is not None and (lam > 0).all()
    x = np.asarray(ls.xstar)
    # KKT stationarity with recovered duals
    k, n = 6, 30
    grad_L = (c + C.T @ lam[:k] + lam[k:k + n] - lam[k + n:] + A.T @ v)
    # λ is recovered at best_x with the *final* t (reference quirk,
    # LPSolver.py:641-646), so stationarity holds only approximately;
    # the full-space engine shows the same ~3e-3 residual on this instance.
    assert np.linalg.norm(grad_L) / np.linalg.norm(c) < 1e-2
    slacks = np.concatenate([d - C @ x, 3 - x, x + 3])
    assert (lam * slacks).max() < 1e-6


def test_qp_reduced_matches_full():
    rng = np.random.default_rng(4)
    n, m, k = 40, 30, 8
    Pp = rng.uniform(-2, 2, (m, n))
    P = Pp.T @ Pp + np.eye(n)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    q = rng.uniform(-2, 2, n)
    kw = dict(P=P, q=q, A=A, b=A @ x_feas, C=C, d=C @ x_feas,
              lower_bound=-3, upper_bound=3, suppress_print=True,
              check_cvxpy=False, epsilon=1e-8, t0=0.01,
              max_inner_iters=100)
    v_full = QPSolver(**kw, reduced=False).solve()
    red = QPSolver(**kw, reduced=True)
    assert red._reduced is not None
    v_red = red.solve()
    assert abs(v_full - v_red) / max(abs(v_full), 1.0) < 1e-6
    x = np.asarray(red.xstar)
    assert np.linalg.norm(A @ x - A @ x_feas) < 1e-8


def test_socp_reduced_matches_full():
    rng = np.random.default_rng(5)
    n, m, K, meq = 12, 6, 2, 4
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
    F = rng.normal(size=(meq, n))
    g = F @ x0
    kw = dict(P=P, q=q, A=A, b=b, c=c, d=d, F=F, g=g, lower_bound=None,
              upper_bound=None, suppress_print=True, check_cvxpy=False,
              epsilon=1e-9, max_inner_iters=100, x0=x0)
    v_full = SOCPSolver(**kw, reduced=False).solve()
    red = SOCPSolver(**kw, reduced=True)
    assert red._reduced is not None
    v_red = red.solve()
    assert abs(v_full - v_red) / max(abs(v_full), 1.0) < 1e-5
    x = np.asarray(red.xstar)
    assert np.linalg.norm(F @ x - g) < 1e-9
    for Ai, bi, ci, di in zip(A, b, c, d):
        assert np.linalg.norm(Ai @ x + bi) <= ci @ x + di + 1e-8


def test_socp_reduced_disabled_with_bounds():
    rng = np.random.default_rng(6)
    n, m = 8, 4
    A = [rng.normal(size=(m, n))]
    b = [rng.normal(size=m)]
    c = [rng.normal(size=n)]
    x0 = np.zeros(n)
    d = [float(np.linalg.norm(A[0] @ x0 + b[0]) + 1.0)]
    F = rng.normal(size=(2, n))
    g = F @ x0
    s = SOCPSolver(P=np.eye(n), q=None, A=A, b=b, c=c, d=d, F=F, g=g,
                   lower_bound=-3, upper_bound=3, suppress_print=True,
                   check_cvxpy=False)
    assert s._reduced is None  # bounds force the full-space engine
