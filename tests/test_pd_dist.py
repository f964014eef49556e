"""Distributed Mehrotra predictor-corrector (parallel/pd_dist.py) on the
virtual 8-device CPU mesh: the multi-chip form of ops/pd.py, with the
same collective layout as the row-sharded barrier program."""
import numpy as np
import pytest
from scipy.optimize import linprog, minimize

from interiorpoint.parallel.mesh import make_mesh
from interiorpoint.parallel import (solve_lp_row_sharded,
                                        solve_pd_row_sharded,
                                        solve_qp_row_sharded)


def _lp_instance(seed=7, n=40, m=13, k=21):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    return c, A, A @ xf, C, C @ xf + 0.4, xf


def test_pd_dist_lp_ragged_rows_matches_scipy():
    """Neither row count divides the mesh; bounds present; duals must be
    stationarity-consistent."""
    mesh = make_mesh(8, ("rows",))
    c, A, b, C, d, xf = _lp_instance()
    n, m, k = len(c), A.shape[0], C.shape[0]
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=[(-3, 3)] * n, method="highs")
    res = solve_pd_row_sharded(mesh, c, A, b, C, d, lb=-3.0, ub=3.0,
                               epsilon=1e-9)
    assert res["converged"]
    assert res["objective"] == pytest.approx(ref.fun, rel=1e-9)
    x = np.asarray(res["x"])
    assert np.abs(A @ x - b).max() < 1e-9
    assert (C @ x - d).max() < 1e-9
    lam = res["lam"]
    assert (lam >= 0).all()
    g = (c + C.T @ lam[:k] + lam[k:k + n] - lam[k + n:]
         + A.T @ np.asarray(res["v"]))
    assert np.abs(g).max() < 1e-7


def test_pd_dist_one_sided_bounds_and_infeasible_start():
    """lb-only bounds (masked ub segment) from an x0 violating Cx ≤ d —
    no phase one runs, the residual is absorbed."""
    mesh = make_mesh(8, ("rows",))
    c, A, b, C, d, xf = _lp_instance(seed=11)
    n = len(c)
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=[(-3, None)] * n, method="highs")
    assert ref.status == 0
    xbad = xf + 2.0   # violates several inequality rows
    assert (C @ xbad > d).any()
    res = solve_pd_row_sharded(mesh, c, A, b, C, d, lb=-3.0, x0=xbad,
                               epsilon=1e-9)
    assert res["converged"]
    assert res["objective"] == pytest.approx(ref.fun, rel=1e-8)


def test_pd_dist_qp_and_mixed_factor():
    mesh = make_mesh(8, ("rows",))
    c, A, b, C, d, xf = _lp_instance(seed=13)
    n, m = len(c), A.shape[0]
    rng = np.random.default_rng(5)
    Pm = rng.uniform(-1, 1, (m, n))
    P = Pm.T @ Pm + np.eye(n)
    cons = [{"type": "ineq", "fun": lambda x: d - C @ x},
            {"type": "eq", "fun": lambda x: A @ x - b}]
    ref = minimize(lambda x: 0.5 * x @ P @ x + c @ x, xf, method="SLSQP",
                   constraints=cons, bounds=[(-3, 3)] * n,
                   options={"maxiter": 800, "ftol": 1e-12})
    assert ref.success, ref.message
    for fdtype in ("float64", "float32"):
        res = solve_pd_row_sharded(mesh, c, A, b, C, d, lb=-3.0, ub=3.0,
                                   P_obj=P, epsilon=1e-10,
                                   factor_dtype=fdtype)
        assert res["converged"], fdtype
        assert res["objective"] == pytest.approx(ref.fun, rel=1e-7,
                                                 abs=1e-7), fdtype


def test_pd_dist_dispatch_and_barrier_agreement():
    """solve_lp_row_sharded(algorithm='pd') reaches the same optimum as
    the barrier program, in far fewer iterations."""
    mesh = make_mesh(8, ("rows",))
    c, A, b, C, d, xf = _lp_instance(seed=17)
    bar = solve_lp_row_sharded(mesh, c, A, b, C, d, lb=-3.0, ub=3.0,
                               x0=xf, epsilon=1e-8)
    pd = solve_lp_row_sharded(mesh, c, A, b, C, d, lb=-3.0, ub=3.0,
                              x0=xf, epsilon=1e-8, algorithm="pd")
    assert pd["objective"] == pytest.approx(bar["objective"], rel=1e-6)
    assert pd["newton_iters"] * 2 < bar["newton_iters"]
    with pytest.raises(ValueError, match="checkpoint"):
        solve_lp_row_sharded(mesh, c, A, b, C, d, lb=-3.0, ub=3.0,
                             algorithm="pd", checkpoint_path="/tmp/x.npz")


def test_pd_dist_qp_dispatch():
    mesh = make_mesh(8, ("rows",))
    c, A, b, C, d, xf = _lp_instance(seed=19, n=24, m=6, k=10)
    n, m = len(c), A.shape[0]
    rng = np.random.default_rng(3)
    Pm = rng.uniform(-1, 1, (m, n))
    P = Pm.T @ Pm + np.eye(n)
    bar = solve_qp_row_sharded(mesh, P, c, A, b, C, d, lb=-3.0, ub=3.0,
                               x0=xf, epsilon=1e-8)
    pd = solve_qp_row_sharded(mesh, P, c, A, b, C, d, lb=-3.0, ub=3.0,
                              x0=xf, epsilon=1e-8, algorithm="pd")
    assert pd["objective"] == pytest.approx(bar["objective"], rel=1e-6)


def test_pd_dist_qp_recipe_stays_finite_when_schur_goes_singular():
    """The QP benchmark recipe at n = 1000: late Mehrotra iterations
    leave the Schur complement A·H⁻¹·Aᵀ numerically singular.  The
    replicated factor's jitter ladder must keep the direction finite,
    and the answer must match the one-card reduced solve."""
    from interiorpoint import QPSolver
    from interiorpoint.utils.generators import RECIPE_SETTINGS, generate_qp

    p = generate_qp(1000, rng=np.random.RandomState(1))
    mesh = make_mesh(4, ("rows",))
    res = solve_qp_row_sharded(mesh, p["P"], p["q"], p["A"], p["b"],
                               p["C"], p["d"], lb=-3.0, ub=3.0,
                               epsilon=1e-8, algorithm="pd")
    ref = QPSolver(**p, **RECIPE_SETTINGS["qp"], suppress_print=True,
                   check_cvxpy=False, dtype="float64", algorithm="pd").solve()
    f = float(res["objective"])
    assert np.isfinite(f)
    assert abs(f - ref) <= 1e-8 * (1 + abs(ref))
