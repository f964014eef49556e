"""Conic primal-dual Mehrotra engine (ops/socp_pd.py,
SOCPSolver(algorithm="pd")).

Validates the NT-scaling identities, the engine against SLSQP across
structural configurations, and the driver surface (certify, duals,
barrier agreement)."""
import numpy as np
import pytest
from scipy.optimize import minimize

from interiorpoint import SOCPSolver, certify


def _rand_cone_points(rng, K, M1):
    v = rng.standard_normal((K, M1))
    v[:, 0] = np.linalg.norm(v[:, 1:], axis=1) + rng.uniform(0.1, 2.0, K)
    return v


def test_nt_scaling_identities():
    """w on the unit hyperboloid; W z = W⁻¹ s = λ with λᵀλ = sᵀz;
    W⁻¹(W u) = u; arrow solve inverts the Jordan product; max_step_cone
    brackets the cone boundary."""
    import jax.numpy as jnp
    from interiorpoint.ops.socp_pd import (
        _arrow_solve, _jdet, _jmul, max_step_cone, nt_scaling, w_inv_mul,
        w_mul)

    rng = np.random.default_rng(0)
    K, M1 = 6, 5
    s = jnp.asarray(_rand_cone_points(rng, K, M1))
    z = jnp.asarray(_rand_cone_points(rng, K, M1))
    u, eta = nt_scaling(s, z)
    assert np.abs(np.asarray(_jdet(u)) - 1).max() < 1e-12
    lam1 = w_mul(u, eta, z)
    lam2 = w_inv_mul(u, eta, s)
    assert np.abs(np.asarray(lam1 - lam2)).max() < 1e-12
    assert np.abs(np.asarray(
        jnp.sum(lam1 * lam1, axis=-1) - jnp.sum(s * z, axis=-1))).max() \
        < 1e-11
    v = jnp.asarray(rng.standard_normal((K, M1)))
    assert np.abs(np.asarray(
        w_inv_mul(u, eta, w_mul(u, eta, v)) - v)).max() < 1e-12
    lam = jnp.asarray(_rand_cone_points(rng, K, M1))
    r = jnp.asarray(rng.standard_normal((K, M1)))
    assert np.abs(np.asarray(
        _jmul(lam, _arrow_solve(lam, r)) - r)).max() < 1e-12
    ds = jnp.asarray(rng.standard_normal((K, M1)))
    a = float(max_step_cone(s, ds))
    if a < 1.0:
        inside = np.asarray(s + 0.999 * a * ds)
        outside = np.asarray(s + 1.001 * a * ds)
        assert np.all(_pos(inside)) and not np.all(_pos(outside))


def _pos(v):
    return (v[:, 0] > 0) & (v[:, 0] ** 2 - (v[:, 1:] ** 2).sum(1) > 0)


def _make_socp(seed, K, M, n, m_eq=0, quad=False):
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


def _slsqp_ref(As, bs, cs, ds, q, P, F, g, x0, bounds):
    K = As.shape[0]
    cons = [{"type": "ineq",
             "fun": lambda x, k=k: (cs[k] @ x + ds[k])
             - np.linalg.norm(As[k] @ x + bs[k])} for k in range(K)]
    if F is not None:
        cons.append({"type": "eq", "fun": lambda x: F @ x - g})
    obj = (lambda x: q @ x + 0.5 * x @ P @ x) if P is not None \
        else (lambda x: q @ x)
    ref = minimize(obj, x0, method="SLSQP", constraints=cons,
                   bounds=bounds, options={"maxiter": 1000, "ftol": 1e-12})
    assert ref.success or ref.status == 9, ref.message
    return ref.fun


@pytest.mark.parametrize("seed,K,M,n,m_eq,quad", [
    (1, 3, 4, 8, 0, False),
    (2, 5, 3, 10, 3, False),
    (4, 4, 2, 12, 4, True),
    (5, 1, 1, 2, 0, False),
    (6, 6, 5, 15, 5, True),
])
def test_socp_pd_matches_slsqp(seed, K, M, n, m_eq, quad):
    As, bs, cs, ds, q, P, F, g, x0 = _make_socp(seed, K, M, n, m_eq, quad)
    s = SOCPSolver(P=P, q=q, A=list(As), b=list(bs), c=list(cs),
                   d=list(ds), F=F, g=g, lower_bound=-3, upper_bound=3,
                   suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                   x0=x0, algorithm="pd")
    val = s.solve()
    ref = _slsqp_ref(As, bs, cs, ds, q, P, F, g, x0, [(-3, 3)] * n)
    assert val == pytest.approx(ref, rel=1e-6, abs=1e-6)
    assert certify(s).ok(1e-4)
    assert s.outer_iters <= 40


def test_socp_pd_matches_barrier_and_is_cheaper():
    As, bs, cs, ds, q, P, F, g, x0 = _make_socp(23, 4, 3, 10, 3)
    kw = dict(q=q, A=list(As), b=list(bs), c=list(cs), d=list(ds), F=F,
              g=g, lower_bound=-3, upper_bound=3, suppress_print=True,
              check_cvxpy=False, epsilon=1e-9, x0=x0)
    pd = SOCPSolver(algorithm="pd", **kw)
    vpd = pd.solve()
    bar = SOCPSolver(t0="auto", **kw)
    vbar = bar.solve()
    assert vpd == pytest.approx(vbar, rel=1e-6, abs=1e-6)
    # the headline: an order of magnitude fewer factorizations
    assert pd.outer_iters * 5 < sum(bar.inner_iters)


def test_socp_pd_duals():
    """Mapped squared-form duals λ_k = z_k0/(2·rhs_k) satisfy the
    reference-parameterization stationarity to the boundary-alignment
    error (~√gap); equality duals ride along."""
    As, bs, cs, ds, q, P, F, g, x0 = _make_socp(29, 3, 4, 9, 2)
    s = SOCPSolver(q=q, A=list(As), b=list(bs), c=list(cs), d=list(ds),
                   F=F, g=g, lower_bound=-3, upper_bound=3,
                   suppress_print=True, check_cvxpy=False, epsilon=1e-10,
                   x0=x0, get_dual_variables=True, algorithm="pd")
    s.solve()
    n = len(q)
    K = As.shape[0]
    lam = s.lam_star
    assert lam.shape == (2 * K + 2 * n,)   # [cones, ub, lb, rhs-domain]
    assert (lam[:K] >= 0).all()
    x = np.asarray(s.xstar)
    gfull = q.copy()
    for k in range(K):
        lhs = As[k] @ x + bs[k]
        rhs = cs[k] @ x + ds[k]
        gfull += lam[k] * 2.0 * (As[k].T @ lhs - cs[k] * rhs)
    gfull += lam[K:K + n] - lam[K + n:K + 2 * n] + F.T @ s.v_star
    assert np.abs(gfull).max() < 1e-4


def test_socp_pd_batched_matches_slsqp():
    """solve_batch(algorithm='pd') on SOCP instances over the 8-device
    mesh: vmapped NT-scaled conic solves, per-instance SLSQP truth."""
    import jax.numpy as jnp
    from interiorpoint.models.problem import make_socp
    from interiorpoint.parallel.batch import solve_batch, stack_problems
    from interiorpoint.parallel.mesh import make_mesh
    from interiorpoint.utils.config import SolverConfig

    mesh = make_mesh(8, ("batch",))
    probs, x0s, refs = [], [], []
    for i in range(8):
        As, bs, cs, ds, q, P, F, g, x0 = _make_socp(700 + i, 3, 3, 8, 0)
        probs.append(make_socp(list(As), list(bs), list(cs), list(ds),
                               None, q, None, None, -3.0, 3.0))
        x0s.append(x0)
        refs.append(_slsqp_ref(As, bs, cs, ds, q, None, None, None, x0,
                               [(-3, 3)] * 8))
    batch = stack_problems(probs)
    cfg = SolverConfig(dtype="float64", epsilon=1e-9)
    res = solve_batch(batch, jnp.asarray(np.stack(x0s)), cfg, mesh=mesh,
                      algorithm="pd")
    assert bool(np.asarray(res.converged).all())
    for i in range(8):
        x = np.asarray(res.x[i])
        val = float(np.asarray(batch.q[i]) @ x)
        assert val == pytest.approx(refs[i], rel=1e-6, abs=1e-6), i


def test_socp_pd_unbounded_reports_failure():
    """A cone-only unbounded objective must come back converged=False
    (the reference's SOCP benchmark failure mode), not a wrong answer."""
    As, bs, cs, ds, q, P, F, g, x0 = _make_socp(3, 2, 6, 6, 0)
    s = SOCPSolver(q=q, A=list(As), b=list(bs), c=list(cs), d=list(ds),
                   lower_bound=None, upper_bound=None,
                   suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                   x0=x0, algorithm="pd")
    s.solve()
    assert s.last_metrics["converged"] is False


@pytest.mark.parametrize("m_eq,quad", [(3, False), (4, True)])
def test_socp_pd_without_exact_fallback(m_eq, quad):
    """The direction path with ``exact_fallback=False`` — NO f64 stall
    fallback inside the mixed-precision solves (ops/socp_pd.py
    ``exact_fb``) — must converge to the same optimum as the default
    configuration."""
    import jax.numpy as jnp
    from interiorpoint.models.problem import make_socp
    from interiorpoint.ops.socp_pd import cone_operator, socp_pd_solve
    from interiorpoint.utils.config import SolverConfig

    As, bs, cs, ds, q, P, F, g, x0 = _make_socp(11, 4, 3, 10, m_eq, quad)
    prob = make_socp(list(As), list(bs), list(cs), list(ds), P, q, F, g,
                     -3.0, 3.0, dtype=jnp.float64)
    G, h, qv = cone_operator(prob)
    cfg = SolverConfig(dtype="float64", epsilon=1e-9)
    kw = dict(P=prob.P, F=prob.F, g=prob.g, lb=prob.lb, ub=prob.ub)
    res_mf = socp_pd_solve(G, h, qv, jnp.asarray(x0), cfg,
                            exact_fallback=False, **kw)
    assert bool(res_mf.converged), (
        f"exact_fallback=False did not converge: gap={float(res_mf.gap)}"
        f" rp={float(res_mf.rp_norm)} rd={float(res_mf.rd_norm)}")
    ref = _slsqp_ref(As, bs, cs, ds, q, P, F, g, x0, [(-3, 3)] * 10)
    obj = (lambda x: q @ x + 0.5 * x @ P @ x) if P is not None \
        else (lambda x: q @ x)
    val = obj(np.asarray(res_mf.x))
    assert val == pytest.approx(ref, rel=1e-6, abs=1e-6)
    # and the default configuration lands on the same optimum
    res_default = socp_pd_solve(G, h, qv, jnp.asarray(x0), cfg, **kw)
    assert obj(np.asarray(res_default.x)) == pytest.approx(val, rel=1e-7,
                                                       abs=1e-7)

