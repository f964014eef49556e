"""Phase-one tests: the reference's end-to-end scenarios
(reference: AutomatedTestsPhaseOne.py:235-345) ported as pytest cases
against both the legacy Gx ≤ h API and the current PhaseOneSolver."""

import numpy as np
import pytest

from interiorpoint.models.phase1 import PhaseOne, PhaseOneSolver


def test_legacy_initialized_inside_set():
    """(reference: AutomatedTestsPhaseOne.py:251-265)"""
    G = np.array([[1, 3], [1, 1], [-1, 0], [0, -1]], dtype=float)
    h = np.array([9, 5, 0, 0], dtype=float)
    p1 = PhaseOne(G, h, mu=15)
    x, s, warn = p1.solve()
    assert s < 0
    assert np.max(G @ x - h) <= 0


def test_legacy_initialized_outside_set():
    """(reference: AutomatedTestsPhaseOne.py:268-285)"""
    G = np.array([[-1, -3], [-1, 1], [-1, 2], [1, 4]], dtype=float)
    h = np.array([-6, 2, 2, 12], dtype=float)
    p1 = PhaseOne(G, h, mu=15)
    x, s, warn = p1.solve()
    assert s < 0
    assert np.max(G @ x - h) <= 0


def test_legacy_unbounded_set():
    """(reference: AutomatedTestsPhaseOne.py:287-303)"""
    G = np.array([[1, -2], [-3, 1]], dtype=float)
    h = np.array([-2, 0], dtype=float)
    p1 = PhaseOne(G, h, mu=15)
    x, s, warn = p1.solve()
    assert s < 0
    assert np.max(G @ x - h) <= 0


def test_legacy_empty_set():
    """Provably empty polyhedron: phase one must certify s > 0
    (reference: AutomatedTestsPhaseOne.py:305-321)."""
    G = np.array([[3, -1], [-1, 5], [-1, 0], [0, -1]], dtype=float)
    h = np.array([-2, 1.5, 0, 0], dtype=float)
    p1 = PhaseOne(G, h, mu=15)
    x, s, warn = p1.solve()
    assert s > 0


def test_legacy_high_dimension():
    """(reference: AutomatedTestsPhaseOne.py:323-343)"""
    rng = np.random.default_rng(0)
    m, n = 200, 1000
    G = rng.uniform(-10, 10, (m, n))
    x_true = rng.uniform(-5, 5, n)
    h = G @ x_true + 1
    p1 = PhaseOne(G, h, mu=15)
    x, s, warn = p1.solve()
    assert s < 0
    assert np.max(G @ x - h) < 0


def test_legacy_cg_solver():
    """Backend sweep analogue (reference runner crosses solve/cg:
    AutomatedTestsPhaseOne.py:392-422)."""
    G = np.array([[-1, -3], [-1, 1], [-1, 2], [1, 4]], dtype=float)
    h = np.array([-6, 2, 2, 12], dtype=float)
    p1 = PhaseOne(G, h, mu=15, linear_solver="cg")
    x, s, warn = p1.solve()
    assert s < 0
    assert np.max(G @ x - h) <= 0


def test_current_api_with_bounds():
    """Current PhaseOneSolver: inequality block + bounds
    (reference: PhaseOneSolver.py:62-110)."""
    rng = np.random.default_rng(4)
    n, k = 20, 30
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-0.5, 0.5, n)
    d = C @ x_feas + 0.2
    p1 = PhaseOneSolver(C=C, d=d, lower_bound=-3, upper_bound=3,
                        x0=np.full(n, 2.5), suppress_print=True, tol=0.0,
                        max_outer_iters=50, max_inner_iters=200, t0=0.01)
    x, s = p1.solve()
    assert s < 0
    assert (C @ x - d).max() < 0
    assert np.abs(x).max() < 3


def test_current_api_warm_start():
    """Warm start through solve(x0=...) (reference warm-start scenario:
    AutomatedTestsPhaseOne.py:348-389)."""
    rng = np.random.default_rng(5)
    n, k = 10, 14
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-0.5, 0.5, n)
    d = C @ x_feas + 0.2
    p1 = PhaseOneSolver(C=C, d=d, lower_bound=None, upper_bound=None,
                        x0=np.full(n, 5.0), suppress_print=True, tol=0.0,
                        max_outer_iters=50, max_inner_iters=200, t0=0.01)
    x1, s1 = p1.solve()
    assert s1 < 0
    # warm start from the feasible point: immediate success
    x2, s2 = p1.solve(x0=x_feas)
    assert s2 < 0


def test_current_api_socp():
    """SOCP phase one (reference: PhaseOneSolver.py:74-84 socp branch)."""
    rng = np.random.default_rng(6)
    n, m = 8, 5
    A = [rng.normal(size=(m, n)) for _ in range(2)]
    b = [rng.normal(size=m) for _ in range(2)]
    c = [rng.normal(size=n) for _ in range(2)]
    x_c = rng.normal(size=n) * 0.2
    d = [float(np.linalg.norm(Ai @ x_c + bi) - ci @ x_c + 1.0)
         for Ai, bi, ci in zip(A, b, c)]
    p1 = PhaseOneSolver(socp=True, socp_params=(A, b, c, d),
                        lower_bound=None, upper_bound=None,
                        x0=x_c + 0.05, suppress_print=True, tol=0.0,
                        max_outer_iters=50, max_inner_iters=200, t0=0.01)
    x, s = p1.solve()
    assert s < 0
    for Ai, bi, ci, di in zip(A, b, c, d):
        assert np.linalg.norm(Ai @ x + bi) <= ci @ x + di
