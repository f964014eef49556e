"""Cone-sharded distributed SOCP solve on the virtual 8-device CPU mesh:
cross-checked against scipy SLSQP ground truth and the single-chip solver
(the same validation strategy as tests/test_socp.py; the distribution
scheme itself is new capability, SURVEY.md §2.2)."""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy.optimize import minimize

from interiorpoint.parallel.mesh import make_mesh
from interiorpoint.parallel.socp_dist import solve_socp_cone_sharded


def _gen_socp(n=30, K=5, M=8, m_eq=4, seed=0, bounds=True):
    rng = np.random.RandomState(seed)
    Pp = rng.uniform(-1, 1, (n, n))
    P = Pp.T @ Pp + np.eye(n)
    q = rng.uniform(-1, 1, n)
    x0 = rng.randn(n) * 0.1
    A = rng.randn(K, M, n)
    b = rng.randn(K, M)
    c = rng.randn(K, n)
    d = np.array([np.linalg.norm(A[k] @ x0 + b[k]) - c[k] @ x0 + 1.0
                  for k in range(K)])
    F = rng.randn(m_eq, n) if m_eq else None
    g = F @ x0 if m_eq else None
    lb, ub = (-3.0, 3.0) if bounds else (None, None)
    return P, q, A, b, c, d, F, g, lb, ub, x0


def _slsqp(P, q, A, b, c, d, F, g, lb, ub, x0):
    n = x0.shape[0]
    cons = []
    for k in range(A.shape[0]):
        cons.append({"type": "ineq",
                     "fun": lambda x, k=k: (c[k] @ x + d[k])
                     - np.linalg.norm(A[k] @ x + b[k])})
    if F is not None:
        cons.append({"type": "eq", "fun": lambda x: F @ x - g})
    bnds = [(lb, ub)] * n if lb is not None else None
    res = minimize(lambda x: 0.5 * x @ P @ x + q @ x, x0,
                   method="SLSQP", constraints=cons, bounds=bnds,
                   options={"maxiter": 400, "ftol": 1e-12})
    assert res.success, res.message
    return res


def test_cone_sharded_matches_slsqp_full():
    """Full generality: P, q, K=5 cones (padded to the 8-device mesh),
    equalities and box bounds."""
    P, q, A, b, c, d, F, g, lb, ub, x0 = _gen_socp(seed=1)
    mesh = make_mesh(8, ("cones",))
    res = solve_socp_cone_sharded(mesh, A, b, c, d, P, q, F, g, lb, ub,
                                  x0=x0, epsilon=1e-9)
    ref = _slsqp(P, q, A, b, c, d, F, g, lb, ub, x0)
    assert res["objective"] == pytest.approx(ref.fun, rel=1e-6, abs=1e-6)
    np.testing.assert_allclose(np.asarray(res["x"]), ref.x, atol=1e-4)
    # equality feasibility and multiplier shape
    np.testing.assert_allclose(F @ np.asarray(res["x"]), g, atol=1e-7)
    assert res["v"].shape == (F.shape[0],)


def test_cone_sharded_no_eq_no_bounds():
    P, q, A, b, c, d, _, _, _, _, x0 = _gen_socp(m_eq=0, bounds=False,
                                                 seed=2)
    mesh = make_mesh(8, ("cones",))
    res = solve_socp_cone_sharded(mesh, A, b, c, d, P, q, x0=x0,
                                  epsilon=1e-9)
    ref = _slsqp(P, q, A, b, c, d, None, None, None, None, x0)
    assert res["objective"] == pytest.approx(ref.fun, rel=1e-6, abs=1e-6)
    assert res["v"].shape == (0,)


def test_cone_sharded_phase1_routes_infeasible_start():
    """A cone-infeasible x0 must route through the distributed phase one
    and still reach the SLSQP optimum."""
    P, q, A, b, c, d, F, g, lb, ub, x0 = _gen_socp(seed=3)
    rng = np.random.RandomState(33)

    def min_slack(x):
        lhs = np.einsum("kmn,n->km", A, x) + b
        rhs = c @ x + d
        return min((rhs**2 - np.sum(lhs**2, axis=-1)).min(), rhs.min())

    x_bad, step = x0.copy(), rng.randn(x0.shape[0])
    while min_slack(x_bad) > 0:  # walk out of the cone intersection
        x_bad = np.clip(x_bad + step, lb + 0.1, ub - 0.1)
        step = step * 2.0
    mesh = make_mesh(8, ("cones",))
    res = solve_socp_cone_sharded(mesh, A, b, c, d, P, q, F, g, lb, ub,
                                  x0=x_bad, epsilon=1e-9)
    ref = _slsqp(P, q, A, b, c, d, F, g, lb, ub, x0)
    assert res["objective"] == pytest.approx(ref.fun, rel=1e-5, abs=1e-5)


def test_cone_sharded_mixed_factor_matches_f64():
    """factor_dtype='float32' + cooperative factor reproduces the f64
    replicated-factor optimum (refinement + stall escalation)."""
    P, q, A, b, c, d, F, g, lb, ub, x0 = _gen_socp(seed=4)
    mesh = make_mesh(8, ("cones",))
    kw = dict(x0=x0, epsilon=1e-9)
    r64 = solve_socp_cone_sharded(mesh, A, b, c, d, P, q, F, g, lb, ub,
                                  **kw)
    r32 = solve_socp_cone_sharded(mesh, A, b, c, d, P, q, F, g, lb, ub,
                                  factor_dtype="float32",
                                  distributed_factor=True, chol_block=16,
                                  **kw)
    assert float(r32["objective"]) == pytest.approx(
        float(r64["objective"]), rel=1e-7, abs=1e-7)


def test_cone_sharded_infeasible_raises():
    """Contradictory cones: rhs forced negative everywhere ⇒ phase one
    certifies strict infeasibility."""
    n, K, M = 10, 3, 4
    rng = np.random.RandomState(5)
    A = np.zeros((K, M, n))
    b = np.ones((K, M))
    c = np.zeros((K, n))
    d = -np.ones(K)  # rhs = -1 < 0 for every x: no feasible point
    mesh = make_mesh(8, ("cones",))
    with pytest.raises(ValueError, match="infeasible"):
        solve_socp_cone_sharded(mesh, A, b, c, d,
                                q=rng.randn(n), epsilon=1e-6)


def test_cone_sharded_checkpoint_resume(tmp_path):
    """Mid-solve checkpoint/resume on the distributed SOCP solve: a run
    killed after 3 barrier stages and resumed fresh must reach the clean
    run's optimum with the same total stage count."""
    P, q, A, b, c, d, F, g, lb, ub, x0 = _gen_socp(seed=7)
    mesh = make_mesh(8, ("cones",))
    kw = dict(epsilon=1e-9)
    clean = solve_socp_cone_sharded(mesh, A, b, c, d, P, q, F, g, lb,
                                    ub, x0=x0, **kw)
    assert clean["outer_iters"] > 3

    path = str(tmp_path / "dist_socp.npz")
    part = solve_socp_cone_sharded(mesh, A, b, c, d, P, q, F, g, lb, ub,
                                   x0=x0, max_outer_iters=3,
                                   checkpoint_path=path, **kw)
    assert part["outer_iters"] == 3

    res = solve_socp_cone_sharded(mesh, A, b, c, d, P, q, F, g, lb, ub,
                                  x0=x0, checkpoint_path=path,
                                  resume=True, **kw)
    assert res["outer_iters"] == clean["outer_iters"]
    assert float(res["objective"]) == pytest.approx(
        float(clean["objective"]), rel=1e-9, abs=1e-9)
    np.testing.assert_allclose(np.asarray(res["x"]),
                               np.asarray(clean["x"]), atol=1e-7)
