"""Cone-sharded distributed conic Mehrotra solve
(parallel/socp_pd_dist.py) on the virtual 8-device CPU mesh."""
import numpy as np
import pytest
from scipy.optimize import minimize

from interiorpoint.parallel import (make_mesh, solve_socp_cone_sharded,
                                        solve_socp_pd_cone_sharded)


def _mk(seed, K, M, n, m_eq=0, quad=False):
    rng = np.random.default_rng(seed)
    As = rng.standard_normal((K, M, n))
    bs = rng.standard_normal((K, M))
    cs = rng.standard_normal((K, n))
    x0 = rng.standard_normal(n) * 0.1
    ds = np.array([np.linalg.norm(As[k] @ x0 + bs[k]) - cs[k] @ x0 + 1.0
                   for k in range(K)])
    q = rng.uniform(-1, 1, n)
    P = None
    if quad:
        Mq = rng.uniform(-1, 1, (n, n))
        P = Mq.T @ Mq + np.eye(n)
    F = rng.standard_normal((m_eq, n)) if m_eq else None
    g = F @ x0 if m_eq else None
    return As, bs, cs, ds, q, P, F, g, x0


def _ref(As, bs, cs, ds, q, P, F, g, x0, n):
    K = As.shape[0]
    cons = [{"type": "ineq",
             "fun": lambda x, k=k: (cs[k] @ x + ds[k])
             - np.linalg.norm(As[k] @ x + bs[k])} for k in range(K)]
    if F is not None:
        cons.append({"type": "eq", "fun": lambda x: F @ x - g})
    obj = ((lambda x: q @ x + 0.5 * x @ P @ x) if P is not None
           else (lambda x: q @ x))
    r = minimize(obj, x0, method="SLSQP", constraints=cons,
                 bounds=[(-3, 3)] * n,
                 options={"maxiter": 1000, "ftol": 1e-12})
    assert r.success or r.status == 9, r.message
    return r.fun


def test_socp_pd_dist_ragged_cones_matches_slsqp():
    """K=5 cones over 8 devices (inert trivial-cone padding), equalities,
    bounds; conic duals must be cone-feasible."""
    mesh = make_mesh(8, ("cones",))
    As, bs, cs, ds, q, P, F, g, x0 = _mk(23, 5, 3, 10, 3)
    res = solve_socp_pd_cone_sharded(mesh, As, bs, cs, ds, q=q, F=F, g=g,
                                     lb=-3.0, ub=3.0, x0=x0, epsilon=1e-9)
    assert res["converged"]
    ref = _ref(As, bs, cs, ds, q, P, F, g, x0, 10)
    assert res["objective"] == pytest.approx(ref, rel=1e-7, abs=1e-7)
    z = res["z"]
    assert z.shape == (5, 4)
    assert np.all(z[:, 0] >= np.linalg.norm(z[:, 1:], axis=1) - 1e-9)
    x = np.asarray(res["x"])
    assert np.abs(F @ x - g).max() < 1e-8


def test_socp_pd_dist_qp_and_mixed_factor():
    mesh = make_mesh(8, ("cones",))
    As, bs, cs, ds, q, P, F, g, x0 = _mk(31, 4, 2, 8, 2, quad=True)
    ref = _ref(As, bs, cs, ds, q, P, F, g, x0, 8)
    for fdtype in ("float64", "float32"):
        res = solve_socp_pd_cone_sharded(
            mesh, As, bs, cs, ds, P_obj=P, q=q, F=F, g=g, lb=-3.0,
            ub=3.0, x0=x0, epsilon=1e-10, factor_dtype=fdtype)
        assert res["converged"], fdtype
        assert res["objective"] == pytest.approx(ref, rel=1e-6,
                                                 abs=1e-6), fdtype


def test_socp_pd_dist_dispatch_and_barrier_agreement():
    """solve_socp_cone_sharded(algorithm='pd') agrees with the barrier
    program at far fewer iterations; checkpointing with pd raises."""
    mesh = make_mesh(8, ("cones",))
    As, bs, cs, ds, q, P, F, g, x0 = _mk(37, 3, 3, 9, 2)
    bar = solve_socp_cone_sharded(mesh, As, bs, cs, ds, q=q, F=F, g=g,
                                  lb=-3.0, ub=3.0, x0=x0, epsilon=1e-8)
    pd = solve_socp_cone_sharded(mesh, As, bs, cs, ds, q=q, F=F, g=g,
                                 lb=-3.0, ub=3.0, x0=x0, epsilon=1e-8,
                                 algorithm="pd")
    assert pd["objective"] == pytest.approx(bar["objective"], rel=1e-6,
                                            abs=1e-6)
    assert pd["iterations"] * 3 < bar["newton_iters"]
    with pytest.raises(ValueError, match="checkpoint"):
        solve_socp_cone_sharded(mesh, As, bs, cs, ds, q=q,
                                algorithm="pd",
                                checkpoint_path="/tmp/never.npz")


def test_socp_pd_dist_infeasible_start_no_phase1():
    """A cone-violating x0 enters via the shifted slack init — no
    phase-one solve (the barrier path would need one)."""
    mesh = make_mesh(8, ("cones",))
    As, bs, cs, ds, q, P, F, g, x0 = _mk(41, 3, 3, 8, 0)
    xbad = x0 + 5.0   # far outside the cones
    lhs = np.einsum("kmn,n->km", As, xbad) + bs
    rhs = cs @ xbad + ds
    assert (np.linalg.norm(lhs, axis=1) > rhs).any()
    ref = _ref(As, bs, cs, ds, q, None, None, None, x0, 8)
    res = solve_socp_pd_cone_sharded(mesh, As, bs, cs, ds, q=q,
                                     lb=-3.0, ub=3.0, x0=xbad,
                                     epsilon=1e-9)
    assert res["converged"]
    assert res["objective"] == pytest.approx(ref, rel=1e-6, abs=1e-6)
