"""Staged (host-stepped) dispatch ≡ single-program equivalence.

``models/base.py:_barrier_staged`` (one device dispatch per barrier
stage; ``staged_dispatch=True`` and checkpointed solves) runs the SAME
stage bodies (ops/ipm.py:make_outer_body / make_phase1_body) as the
single-program ``_barrier_core`` while_loop, so the iterates must be
identical.  These tests force both paths on the CPU mesh and assert the
solves agree.
"""

import numpy as np
import pytest

from interiorpoint import LPSolver, QPSolver, SOCPSolver
from interiorpoint.utils.generators import (generate_lp, generate_qp,
                                                generate_socp)


def _solve_both(cls, kwargs, solve_kwargs=None):
    outs = []
    for staged in (False, True):
        s = cls(**kwargs, staged_dispatch=staged, suppress_print=True,
                check_cvxpy=False)
        s.solve(**(solve_kwargs or {}))
        outs.append(s)
    return outs


def _assert_equivalent(a, b, tol=1e-9):
    assert a.outer_iters == b.outer_iters
    assert a.inner_iters == b.inner_iters
    assert np.isclose(a.value, b.value, rtol=tol, atol=tol)
    assert np.allclose(np.asarray(a.xstar), np.asarray(b.xstar),
                       rtol=tol, atol=tol)
    assert np.isclose(a.optimality_gap, b.optimality_gap, rtol=tol, atol=tol)


def test_staged_equals_single_lp():
    rng = np.random.RandomState(3)
    p = generate_lp(80, rng=rng)
    a, b = _solve_both(LPSolver, dict(
        c=p["c"], A=p["A"], b=p["b"], C=p["C"], d=p["d"],
        lower_bound=p["lower_bound"], upper_bound=p["upper_bound"],
        epsilon=1e-6, t0=1.0))
    _assert_equivalent(a, b)


def test_staged_equals_single_lp_phase1():
    # No equalities (full-space engine) with the default x0 = bounds
    # midpoint infeasible for x >= 1: phase one runs in both dispatches
    # (gate float(z[-1]) >= 1 in _barrier_staged vs lax.cond in
    # barrier_solve must agree).
    n = 24
    C = -np.eye(n)
    d = -np.ones(n)
    c = np.ones(n)
    a, b = _solve_both(LPSolver, dict(
        c=c, C=C, d=d, lower_bound=-3, upper_bound=3,
        epsilon=1e-6, t0=1.0))
    _assert_equivalent(a, b)
    assert np.isclose(a.value, n, atol=1e-3)


def test_staged_equals_single_qp():
    rng = np.random.RandomState(4)
    p = generate_qp(60, rng=rng)
    a, b = _solve_both(QPSolver, dict(
        P=p["P"], q=p["q"], A=p["A"], b=p["b"], C=p["C"], d=p["d"],
        lower_bound=p["lower_bound"], upper_bound=p["upper_bound"],
        epsilon=1e-6, t0=1.0))
    _assert_equivalent(a, b)


def test_staged_equals_single_socp():
    rng = np.random.RandomState(5)
    p = generate_socp(24, m=16, k=6, num_con=2, rng=rng)
    a, b = _solve_both(SOCPSolver, dict(
        A=p["A"], b=p["b"], c=p["c"], d=p["d"], P=p["P"], q=p["q"],
        F=p["F"], g=p["g"], lower_bound=None, upper_bound=None,
        epsilon=1e-6, t0="auto", x0=p["x0"]))
    _assert_equivalent(a, b)
