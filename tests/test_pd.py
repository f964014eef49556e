"""Primal-dual Mehrotra engine (ops/pd.py, ``algorithm="pd"``).

New capability beyond the reference (barrier-only; reference:
LPSolver.py:514-653): validated here against HiGHS / the barrier path /
the KKT certificate, including the no-phase-one infeasible-start
property and the checkpoint/certify surface compatibility."""
import numpy as np
import pytest
from scipy.optimize import linprog

from interiorpoint import LPSolver, QPSolver, certify

# (n, m_eq, k_ineq, lb?, ub?) — structural edge cases as in test_fuzz.py
SHAPES = [
    (1, 0, 2, True, True),        # n=1: vectors vs scalars
    (2, 1, 0, True, True),
    (3, 0, 0, True, True),        # box-only
    (4, 2, 3, False, True),       # upper bound only
    (5, 3, 1, True, True),
    (6, 0, 8, False, True),
    (7, 5, 4, True, True),
    (2, 1, 1, True, False),       # lower bound only, tiny
    (8, 2, 0, True, False),
]


def _gen_lp(n, m, k, has_lb, has_ub, seed):
    """Bounded-by-duality LP (same recipe as test_fuzz.py)."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-2, 2, (m, n)) if m else None
    C = rng.uniform(-2, 2, (k, n)) if k else None
    xf = rng.uniform(-0.5, 0.5, n)
    b = A @ xf if m else None
    d = C @ xf + rng.uniform(0.2, 1.0, k) if k else None
    lam = rng.uniform(0.1, 1.0, k) if k else np.zeros(0)
    mu_lb = rng.uniform(0.1, 1.0, n) if has_lb else np.zeros(n)
    mu_ub = rng.uniform(0.1, 1.0, n) if has_ub else np.zeros(n)
    v = rng.uniform(-1, 1, m) if m else np.zeros(0)
    c = mu_lb - mu_ub
    if k:
        c -= C.T @ lam
    if m:
        c -= A.T @ v
    return dict(c=c, A=A, b=b, C=C, d=d,
                lb=(-2.0 if has_lb else None),
                ub=(2.0 if has_ub else None)), xf


@pytest.mark.parametrize("n,m,k,has_lb,has_ub", SHAPES)
def test_pd_lp_shape_sweep(n, m, k, has_lb, has_ub):
    p, xf = _gen_lp(n, m, k, has_lb, has_ub, seed=4000 + n * 13 + k)
    ref = linprog(p["c"], A_ub=p["C"], b_ub=p["d"], A_eq=p["A"],
                  b_eq=p["b"], bounds=[(p["lb"], p["ub"])] * n,
                  method="highs")
    assert ref.status == 0
    s = LPSolver(c=p["c"], A=p["A"], b=p["b"], C=p["C"], d=p["d"],
                 lower_bound=p["lb"] if has_lb else -np.inf,
                 upper_bound=p["ub"],
                 suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                 x0=xf, algorithm="pd")
    val = s.solve()
    assert val == pytest.approx(ref.fun, rel=2e-8, abs=2e-8)
    assert certify(s).ok(1e-6)


@pytest.mark.parametrize("n,m,k,has_lb,has_ub", SHAPES)
def test_pd_qp_shape_sweep(n, m, k, has_lb, has_ub):
    rng = np.random.default_rng(88 + n)
    p, xf = _gen_lp(n, m, k, has_lb, has_ub, seed=5000 + n * 11 + k)
    M = rng.uniform(-1, 1, (n, n))
    P = M.T @ M + np.eye(n)
    s = QPSolver(P=P, q=p["c"], A=p["A"], b=p["b"], C=p["C"], d=p["d"],
                 lower_bound=p["lb"] if has_lb else -np.inf,
                 upper_bound=p["ub"],
                 suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                 x0=xf, algorithm="pd")
    s.solve()
    assert certify(s).ok(1e-6)


def test_pd_lp_matches_barrier_and_is_cheaper():
    """Benchmark-recipe LP: pd agrees with the barrier optimum and takes
    far fewer factorizations (the selling point)."""
    rng = np.random.default_rng(1)
    n, m, k = 200, 160, 40
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-2, 2, n)
    c = rng.uniform(-2, 2, n)
    kw = dict(c=c, A=A, b=A @ xf, C=C, d=C @ xf, lower_bound=-3,
              upper_bound=3, suppress_print=True, check_cvxpy=False,
              epsilon=1e-8)
    pd = LPSolver(algorithm="pd", **kw)
    vpd = pd.solve()
    bar = LPSolver(**kw)
    vbar = bar.solve()
    assert vpd == pytest.approx(vbar, rel=1e-7)
    assert certify(pd).ok(1e-5)
    # pd iterations ≲ half the barrier's Newton steps
    assert pd.outer_iters * 2 < sum(bar.inner_iters)


def test_pd_qp_duals_and_certificate():
    rng = np.random.default_rng(5)
    n, m, k = 40, 15, 10
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    Pm = rng.uniform(-1, 1, (m, n))
    P = Pm.T @ Pm + np.eye(n)
    q = rng.uniform(-1, 1, n)
    s = QPSolver(P=P, q=q, A=A, b=A @ xf, C=C, d=C @ xf + 0.5,
                 lower_bound=-3, upper_bound=3, suppress_print=True,
                 check_cvxpy=False, epsilon=1e-10,
                 get_dual_variables=True, algorithm="pd")
    s.solve()
    assert certify(s).ok(1e-6)
    # the PD duals satisfy stationarity directly (no 1/(t·s) inexactness)
    lam = s.lam_star
    g = (P @ s.xstar + q + C.T @ lam[:k] + lam[k:k + n]
         - lam[k + n:] + A.T @ s.v_star)
    assert np.abs(g).max() < 1e-7
    assert (lam >= 0).all()


def test_pd_infeasible_start_needs_no_phase1():
    """An x0 violating Cx ≤ d routes the barrier through phase one; pd
    absorbs it as a primal residual and still converges."""
    rng = np.random.default_rng(9)
    n, m, k = 50, 20, 15
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b, d = A @ xf, C @ xf + 0.3
    xbad = np.clip(xf + rng.uniform(-2, 2, n), -2.9, 2.9)
    assert (C @ xbad > d).any()
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=[(-3, 3)] * n, method="highs")
    s = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                 suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                 algorithm="pd")
    val = s.solve(x0=xbad)
    assert val == pytest.approx(ref.fun, rel=1e-7)
    assert s.last_metrics["phase1_ran"] is False


def test_pd_checkpoint_and_warm_solve_surface():
    """save_state/warm_solve work from a pd solve: _result.t carries the
    equivalent barrier parameter m/gap.  The realistic resume flow is a
    LOOSE pd solve refined by a barrier warm start (a fully converged pd
    iterate sits on the boundary, outside the barrier's domain)."""
    from interiorpoint.utils import checkpoint

    rng = np.random.default_rng(11)
    n, k = 30, 12
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = -C.T @ rng.uniform(0.1, 1.0, k)
    d = C @ xf + 0.5
    s = LPSolver(c=c, C=C, d=d, lower_bound=-2, upper_bound=2,
                 suppress_print=True, check_cvxpy=False, epsilon=1e-3,
                 algorithm="pd")
    v1 = s.solve()
    tight = LPSolver(c=c, C=C, d=d, lower_bound=-2, upper_bound=2,
                     suppress_print=True, check_cvxpy=False, epsilon=1e-9,
                     algorithm="pd")
    vstar = tight.solve()
    assert v1 == pytest.approx(vstar, abs=2e-3)
    import tempfile, os
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "pd.npz")
        checkpoint.save_state(path, s)
        state = checkpoint.load_state(path)
        m_ineq = k + 2 * n
        assert state["t"] >= m_ineq / 1e-3 * 0.99   # t = m/gap
        bar = LPSolver(c=c, C=C, d=d, lower_bound=-2, upper_bound=2,
                       suppress_print=True, check_cvxpy=False,
                       epsilon=1e-9)
        v2 = checkpoint.warm_solve(bar, state)
    assert v2 == pytest.approx(vstar, rel=1e-6, abs=1e-6)


def test_pd_full_space_equality_path():
    """pd_solve's in-engine Schur elimination (A, b passed directly, no
    null-space reduction) must match the reduced-path driver solve."""
    import jax.numpy as jnp
    from interiorpoint.models.problem import LPProblem
    from interiorpoint.models.reduced import _reduced_ineq_block
    from interiorpoint.ops.pd import pd_solve
    from interiorpoint.utils.config import SolverConfig

    rng = np.random.default_rng(21)
    n, m, k = 30, 10, 12
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b, d = A @ xf, C @ xf + 0.4
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=[(-3, 3)] * n, method="highs")
    prob = LPProblem(c=jnp.asarray(c), A=jnp.asarray(A), b=jnp.asarray(b),
                     C=jnp.asarray(C), d=jnp.asarray(d),
                     lb=jnp.full(n, -3.0), ub=jnp.full(n, 3.0))
    eye = jnp.eye(n, dtype=jnp.float64)
    C_z, d_z = _reduced_ineq_block(prob, eye, jnp.zeros(n))
    iprob = LPProblem(c=prob.c, C=C_z, d=d_z)
    cfg = SolverConfig(dtype="float64", epsilon=1e-9)
    res = pd_solve(iprob, jnp.asarray(xf), cfg, A=prob.A, b=prob.b)
    assert bool(res.converged)
    val = float(c @ np.asarray(res.z))
    assert val == pytest.approx(ref.fun, rel=1e-8)
    assert float(np.abs(A @ np.asarray(res.z) - b).max()) < 1e-8
    # equality dual from the engine satisfies stationarity
    lam = np.asarray(res.lam)
    g = (c + C.T @ lam[:k] + lam[k:k + n] - lam[k + n:]
         + A.T @ np.asarray(res.v))
    assert np.abs(g).max() < 1e-6


def test_pd_batched_solves_match_scipy():
    """solve_batch(algorithm='pd') on the 8-device mesh: every instance
    matches its own HiGHS optimum (full-space pd under vmap + sharding)."""
    import jax.numpy as jnp
    from interiorpoint.models.problem import make_lp
    from interiorpoint.parallel.batch import solve_batch, stack_problems
    from interiorpoint.parallel.mesh import make_mesh
    from interiorpoint.utils.config import SolverConfig

    mesh = make_mesh(8, ("batch",))
    probs, x0s, refs = [], [], []
    for i in range(8):
        rng = np.random.default_rng(600 + i)
        n, m, k = 16, 5, 8
        A = rng.uniform(-2, 2, (m, n))
        C = rng.uniform(-2, 2, (k, n))
        xf = rng.uniform(-1, 1, n)
        c = rng.uniform(-2, 2, n)
        b, d = A @ xf, C @ xf + 0.3
        probs.append(make_lp(c, A, b, C, d, -3.0, 3.0))
        x0s.append(xf)
        refs.append(linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                            bounds=[(-3, 3)] * n, method="highs").fun)
    batch = stack_problems(probs)
    cfg = SolverConfig(dtype="float64", epsilon=1e-9)
    res = solve_batch(batch, jnp.asarray(np.stack(x0s)), cfg, mesh=mesh,
                      algorithm="pd")
    assert bool(np.asarray(res.converged).all())
    for i in range(8):
        val = float(np.asarray(batch.c[i]) @ np.asarray(res.z[i]))
        assert val == pytest.approx(refs[i], rel=1e-7, abs=1e-7), i


def test_pd_iteration_cap_and_checkpoint_guards():
    """max_outer_iters passed to solve() caps pd iterations;
    pd_max_iters is the constructor knob; checkpoint_path raises (no
    silent no-op); batched pd rejects ±inf bounds up front."""
    import jax.numpy as jnp
    from interiorpoint.models.problem import make_lp
    from interiorpoint.parallel.batch import solve_batch, stack_problems
    from interiorpoint.utils.config import SolverConfig

    rng = np.random.default_rng(31)
    n, k = 20, 10
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = -C.T @ rng.uniform(0.1, 1.0, k)
    d = C @ xf + 0.5
    s = LPSolver(c=c, C=C, d=d, lower_bound=-2, upper_bound=2,
                 suppress_print=True, check_cvxpy=False, epsilon=1e-12,
                 algorithm="pd")
    s.solve(max_outer_iters=2)
    assert s.outer_iters <= 2
    s2 = LPSolver(c=c, C=C, d=d, lower_bound=-2, upper_bound=2,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-12,
                  algorithm="pd", pd_max_iters=3)
    s2.solve()
    assert s2.outer_iters <= 3
    with pytest.raises(ValueError, match="checkpoint"):
        s.solve(checkpoint_path="/tmp/never_written.npz")

    probs = [make_lp(c, None, None, C, d, -np.inf, 2.0)
             for _ in range(8)]
    batch = stack_problems(probs)
    with pytest.raises(ValueError, match="finite bounds"):
        solve_batch(batch, jnp.zeros((8, n), dtype=jnp.float64),
                    SolverConfig(dtype="float64"), algorithm="pd")


def test_pd_functional_entries():
    """solve_lp/solve_qp/solve_socp accept algorithm='pd' and return the
    raw PD result pytrees."""
    from interiorpoint import solve_lp, solve_qp, solve_socp

    rng = np.random.default_rng(3)
    n, m, k = 20, 6, 8
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    ref = linprog(c, A_ub=C, b_ub=C @ xf + 0.4, A_eq=A, b_eq=A @ xf,
                  bounds=[(-3, 3)] * n, method="highs")
    r = solve_lp(c, A, A @ xf, C, C @ xf + 0.4, -3.0, 3.0,
                 algorithm="pd", epsilon=1e-9, x0=xf)
    assert bool(r.converged)
    assert float(c @ np.asarray(r.z)) == pytest.approx(ref.fun, rel=1e-8)
    Pm = rng.uniform(-1, 1, (m, n))
    P = Pm.T @ Pm + np.eye(n)
    rq = solve_qp(P, c, A, A @ xf, C, C @ xf + 0.4, -3.0, 3.0,
                  algorithm="pd", epsilon=1e-9, x0=xf)
    assert bool(rq.converged)
    K, M = 2, 3
    As = [rng.standard_normal((M, n)) for _ in range(K)]
    bs = [rng.standard_normal(M) for _ in range(K)]
    cs = [rng.standard_normal(n) for _ in range(K)]
    x0s = rng.standard_normal(n) * 0.1
    dss = [float(np.linalg.norm(As[j] @ x0s + bs[j]) - cs[j] @ x0s + 1.0)
           for j in range(K)]
    rs = solve_socp(As, bs, cs, dss, q=c, lb=-3.0, ub=3.0,
                    algorithm="pd", epsilon=1e-9, x0=x0s)
    assert bool(rs.converged)


def test_pd_rejects_bad_algorithm_and_unconstrained():
    with pytest.raises(ValueError, match="algorithm"):
        LPSolver(c=np.ones(3), C=np.eye(3), d=np.ones(3),
                 lower_bound=None, suppress_print=True, check_cvxpy=False,
                 algorithm="simplex")
    s = LPSolver(c=np.ones(3), A=np.ones((1, 3)), b=np.zeros(1),
                 lower_bound=None, suppress_print=True,
                 check_cvxpy=False, algorithm="pd")
    with pytest.raises(ValueError, match="pd"):
        s.solve()


def test_pd_batch_takes_the_exact_fallback_on_float32_overflow():
    """Late in some solves κ(H)·eps32 ≫ 1 and the mixed factor's float32
    solve overflows, leaving the refinement residual NaN; the exact
    float64 fallback must catch that.  Instance 130 of this seeded batch
    once stopped unconverged at iteration 12 (gap 1.1) for want of it."""
    import jax.numpy as jnp
    from interiorpoint.models.problem import make_lp
    from interiorpoint.parallel import solve_batch, stack_problems
    from interiorpoint.utils.config import SolverConfig
    from interiorpoint.utils.generators import RECIPE_SETTINGS, generate_lp

    rng = np.random.RandomState(3)
    raw = [generate_lp(100, rng=rng) for _ in range(132)][130:]
    batch = stack_problems([make_lp(p["c"], p["A"], p["b"], p["C"], p["d"],
                                    -3.0, 3.0, dtype=jnp.float64)
                            for p in raw])
    cfg = SolverConfig(dtype="float64", **RECIPE_SETTINGS["lp"])
    res = solve_batch(batch, jnp.zeros((2, 100)), cfg, algorithm="pd")
    assert bool(np.all(np.asarray(res.converged)))
    for p, z in zip(raw, np.asarray(res.z)):
        ref = linprog(p["c"], A_ub=p["C"], b_ub=p["d"], A_eq=p["A"],
                      b_eq=p["b"], bounds=(-3, 3), method="highs").fun
        assert abs(p["c"] @ z - ref) <= 1e-4 * (1 + abs(ref))
