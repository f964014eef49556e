"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4:
simulate multi-host with xla_force_host_platform_device_count)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.optimize import linprog

from interiorpoint.models.problem import make_lp
from interiorpoint.parallel.batch import (
    solve_batch, solve_lasso_sharded, stack_problems)
from interiorpoint.parallel.distributed import (
    row_sharded_lp_newton_step, shard_rows, solve_lp_row_sharded,
    solve_qp_row_sharded)
from interiorpoint.parallel.mesh import make_mesh
from interiorpoint.utils.config import AdmmConfig, SolverConfig


def _gen_lp(n, m, k, seed):
    rng = np.random.default_rng(seed)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    c = rng.uniform(-2, 2, n)
    return c, A, A @ x_feas, C, C @ x_feas


def test_devices_available():
    assert len(jax.devices()) >= 8


def test_batched_lp_sharded_matches_scipy():
    """8 LP instances solved in one vmapped program, dp-sharded over the
    mesh; every instance must match its own scipy optimum."""
    mesh = make_mesh(8, ("batch",))
    probs, refs = [], []
    for s in range(8):
        c, A, b, C, d = _gen_lp(24, 18, 6, seed=100 + s)
        probs.append(make_lp(c, A, b, C, d, -3.0, 3.0))
        refs.append(linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                            bounds=[(-3, 3)] * 24, method="highs").fun)
    batch = stack_problems(probs)
    x0 = jnp.zeros((8, 24), dtype=jnp.float64)
    cfg = SolverConfig(epsilon=1e-9, t0=1.0, dtype="float64")
    res = solve_batch(batch, x0, cfg, mesh=mesh)
    vals = np.asarray(res.value)
    refs = np.asarray(refs)
    np.testing.assert_allclose(vals, refs, rtol=2e-4)


def test_lasso_sample_sharded_matches_single_device():
    mesh = make_mesh(8, ("batch",))
    rng = np.random.default_rng(0)
    m, n, B = 60, 20, 16
    A = rng.random((m, n))
    x_true = np.zeros((n, B))
    x_true.flat[rng.integers(0, n * B, n * B // 4)] = rng.uniform(0, 50,
                                                                  n * B // 4)
    b = A @ x_true + rng.standard_normal((m, B))
    reg = np.abs(0.05 + 0.01 * rng.standard_normal(B))
    cfg = AdmmConfig(eps_abs=1e-7, eps_rel=1e-7, max_iters=4000,
                     dtype="float64")
    res_sharded = solve_lasso_sharded(A, b, reg, cfg, mesh)
    from interiorpoint.models.lasso import solve_lasso
    res_single = solve_lasso(A, b, reg, cfg=cfg)
    np.testing.assert_allclose(np.asarray(res_sharded.solutions),
                               np.asarray(res_single.solutions), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(res_sharded.X),
                               np.asarray(res_single.X), atol=1e-9)


def test_row_sharded_newton_step_matches_single_device():
    """The psum/all_gather row-sharded Newton step must agree with the
    single-device block elimination to fp accuracy."""
    mesh = make_mesh(8, ("rows",))
    rng = np.random.default_rng(3)
    n, m, k = 32, 16, 24   # m, k divisible by 8
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b = A @ x_feas
    d = C @ x_feas + 1.0
    lb = np.full(n, -3.0)
    ub = np.full(n, 3.0)
    x = jnp.asarray(x_feas)
    v = jnp.zeros(m)
    t = jnp.asarray(2.0)

    step = row_sharded_lp_newton_step(mesh)
    x1, v1, resid = step(
        jnp.asarray(c),
        shard_rows(mesh, jnp.asarray(A)), shard_rows(mesh, jnp.asarray(b)),
        shard_rows(mesh, jnp.asarray(C)), shard_rows(mesh, jnp.asarray(d)),
        jnp.asarray(lb), jnp.asarray(ub), x, v, t,
    )

    # single-device replica of the same math
    from interiorpoint.ops.barrier import make_qp_oracle
    from interiorpoint.ops.kkt import solve_kkt_eq
    prob = make_lp(c, A, b, C, d, lb, ub)
    oracle = make_qp_oracle(prob, try_diag=False)
    g = oracle.grad(x, t)
    H = oracle.hess(x, t)
    dx, w = solve_kkt_eq(H, jnp.asarray(A), g, jnp.asarray(A) @ x - b,
                         "cholesky")
    dv = w - v
    ds_C = np.asarray(C) @ np.asarray(dx)
    s_C = d - C @ np.asarray(x)
    lim = np.inf
    pos = ds_C > 0
    if pos.any():
        lim = min(lim, (s_C[pos] / ds_C[pos]).min())
    dxn = np.asarray(dx)
    up = dxn > 0
    dn = dxn < 0
    if up.any():
        lim = min(lim, ((ub - np.asarray(x))[up] / dxn[up]).min())
    if dn.any():
        lim = min(lim, ((lb - np.asarray(x))[dn] / dxn[dn]).min())
    sigma = min(1.0, 0.99 * lim)
    x_ref = np.asarray(x) + sigma * dxn
    np.testing.assert_allclose(np.asarray(x1), x_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v + sigma * dv),
                               rtol=1e-8, atol=1e-10)
    assert np.isfinite(float(resid))


def test_row_sharded_full_solve_matches_scipy():
    """Full distributed barrier solve: row counts NOT divisible by the
    mesh, bounds present, must match the HiGHS optimum."""
    mesh = make_mesh(8, ("rows",))
    rng = np.random.default_rng(17)
    n, m, k = 40, 29, 27   # neither m nor k divides 8
    rng2 = np.random.default_rng(17)
    A = rng2.uniform(-2, 2, (m, n))
    C = rng2.uniform(-2, 2, (k, n))
    x_feas = rng2.uniform(-1, 1, n)
    c = rng2.uniform(-2, 2, n)
    b = A @ x_feas
    d = C @ x_feas + 0.5   # interior margin: x_feas strictly feasible
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=[(-3, 3)] * n, method="highs")
    res = solve_lp_row_sharded(
        mesh, c, A, b, C, d, lb=-3.0, ub=3.0, x0=x_feas, epsilon=1e-9)
    assert res["outer_iters"] > 0 and res["newton_iters"] > 0
    np.testing.assert_allclose(float(res["objective"]), ref.fun, rtol=2e-6)
    # primal feasibility of the returned iterate
    x = np.asarray(res["x"])
    assert np.abs(A @ x - b).max() < 1e-6
    assert (C @ x - d).max() < 1e-9


def test_row_sharded_full_solve_unbounded_vars():
    """Bounds absent: the +/-inf bound representation must be a no-op
    (lifts the single-step demo's bounds-required constraint)."""
    mesh = make_mesh(8, ("rows",))
    rng = np.random.default_rng(23)
    n, m, k = 30, 10, 50
    A = rng.uniform(-2, 2, (m, n))
    C = np.vstack([rng.uniform(-2, 2, (k, n)), np.eye(n), -np.eye(n)])
    x_feas = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b = A @ x_feas
    # generous box rows inside C keep the LP bounded without lb/ub
    d = np.concatenate([C[:k] @ x_feas + 0.5, np.full(2 * n, 5.0)])
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=[(None, None)] * n, method="highs")
    res = solve_lp_row_sharded(mesh, c, A, b, C, d, x0=x_feas,
                               epsilon=1e-9)
    np.testing.assert_allclose(float(res["objective"]), ref.fun, rtol=2e-6)


def test_row_sharded_qp_matches_slsqp():
    """Distributed QP (P replicated, constraint rows sharded, row counts
    not divisible by the mesh) must match an independent SLSQP solve."""
    from scipy.optimize import minimize

    mesh = make_mesh(8, ("rows",))
    rng = np.random.default_rng(31)
    n, m, k = 24, 10, 13
    M = rng.uniform(-1, 1, (n, n))
    P = M @ M.T + np.eye(n)
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b = A @ x_feas
    d = C @ x_feas + 0.5
    f = lambda x: 0.5 * x @ P @ x + c @ x
    ref = minimize(
        f, x_feas, jac=lambda x: P @ x + c, method="SLSQP",
        constraints=[
            {"type": "eq", "fun": lambda x: A @ x - b,
             "jac": lambda x: A},
            {"type": "ineq", "fun": lambda x: d - C @ x,
             "jac": lambda x: -C}],
        bounds=[(-3, 3)] * n, options={"maxiter": 500, "ftol": 1e-12})
    assert ref.success
    res = solve_qp_row_sharded(mesh, P, c, A, b, C, d, lb=-3.0, ub=3.0,
                               x0=x_feas, epsilon=1e-9)
    np.testing.assert_allclose(float(res["objective"]), ref.fun,
                               rtol=1e-6, atol=1e-8)
    x = np.asarray(res["x"])
    assert np.abs(A @ x - b).max() < 1e-6
    assert (C @ x - d).max() < 1e-9


def test_dist_cholesky_matches_dense():
    """parallel/chol.py block-cyclic factor vs jnp.linalg.cholesky on
    the virtual mesh: odd sizes, several block widths, both dtypes."""
    from interiorpoint.parallel.chol import dist_cholesky
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(8, ("rows",))
    rng = np.random.default_rng(5)
    for n, bs in [(37, 8), (130, 32), (333, 64)]:
        M = rng.standard_normal((n, n))
        H = M @ M.T + n * np.eye(n)
        f = jax.jit(shard_map(
            lambda Hm: dist_cholesky(Hm, "rows", 8, bs), mesh=mesh,
            in_specs=(P(),), out_specs=P(), check_vma=False))
        L = np.asarray(f(jnp.asarray(H)))
        Lref = np.linalg.cholesky(H)
        err = np.abs(L - Lref).max() / np.abs(Lref).max()
        assert err < 1e-12, (n, bs, err)
        # f32 input stays f32 (the mixed-precision factor path)
        L32 = np.asarray(f(jnp.asarray(H, jnp.float32)))
        assert L32.dtype == np.float32
        err32 = np.abs(L32 - Lref).max() / np.abs(Lref).max()
        assert err32 < 1e-4, (n, bs, err32)


def test_row_sharded_distributed_factor_matches_scipy():
    """Full distributed solve with the cooperative (non-replicated)
    Cholesky and with the mixed f32 factor: same HiGHS optimum as the
    replicated-f64 default."""
    mesh = make_mesh(8, ("rows",))
    rng = np.random.default_rng(17)
    n, m, k = 40, 29, 27
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b = A @ x_feas
    d = C @ x_feas + 0.5
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=[(-3, 3)] * n, method="highs")
    res_d = solve_lp_row_sharded(
        mesh, c, A, b, C, d, lb=-3.0, ub=3.0, x0=x_feas, epsilon=1e-9,
        distributed_factor=True, chol_block=16)
    np.testing.assert_allclose(float(res_d["objective"]), ref.fun,
                               rtol=2e-6)
    res_m = solve_lp_row_sharded(
        mesh, c, A, b, C, d, lb=-3.0, ub=3.0, x0=x_feas, epsilon=1e-9,
        distributed_factor=True, factor_dtype="float32", chol_block=16)
    np.testing.assert_allclose(float(res_m["objective"]), ref.fun,
                               rtol=2e-6)
    x = np.asarray(res_m["x"])
    assert np.abs(A @ x - b).max() < 1e-6
    assert (C @ x - d).max() < 1e-9


def test_row_sharded_phase1_from_infeasible_start():
    """phase1='auto': an infeasible x0 (outside Cx<=d) routes through
    the distributed phase one and still reaches the HiGHS optimum."""
    mesh = make_mesh(8, ("rows",))
    rng = np.random.default_rng(41)
    n, m, k = 30, 11, 19
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b = A @ x_feas
    d = C @ x_feas + 0.3
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=[(-3, 3)] * n, method="highs")
    # bound midpoint (the default x0) violates several C rows here
    assert (C @ np.zeros(n) - d).max() > 0
    res = solve_lp_row_sharded(mesh, c, A, b, C, d, lb=-3.0, ub=3.0,
                               epsilon=1e-9)
    np.testing.assert_allclose(float(res["objective"]), ref.fun,
                               rtol=2e-6)


def test_row_sharded_phase1_detects_infeasible():
    """A contradictory inequality system raises from phase one."""
    import pytest

    mesh = make_mesh(8, ("rows",))
    n = 6
    A = np.zeros((1, n)); A[0, -1] = 1.0
    b = np.zeros(1)
    C = np.vstack([np.eye(n), -np.eye(n)])
    d = np.concatenate([-np.ones(n), -np.ones(n)])   # x<=-1 and x>=1
    c = np.ones(n)
    with pytest.raises(ValueError, match="infeasible"):
        solve_lp_row_sharded(mesh, c, A, b, C, d, epsilon=1e-9)


def test_row_sharded_no_equalities_and_phase1_true():
    """Equality-free LP (m=0: whole padded block inert) through the
    distributed solve, with phase1=True (the boolean must behave like
    "auto", not silently disable the feasibility gate) and an
    infeasible x0 routing through the distributed phase one."""
    rng = np.random.default_rng(11)
    n, k = 24, 40
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    d = C @ xf + 0.5
    mesh = make_mesh(8, ("rows",))
    A0 = np.zeros((0, n))
    b0 = np.zeros((0,))
    x_bad = xf + 10.0   # violates Cx <= d (outside the box too)
    res = solve_lp_row_sharded(mesh, c, A0, b0, C, d, lb=-3.0, ub=3.0,
                               x0=x_bad, epsilon=1e-6, phase1=True)
    ref = linprog(c, A_ub=C, b_ub=d, bounds=[(-3, 3)] * n,
                  method="highs")
    assert ref.status == 0
    assert abs(float(res["objective"]) - ref.fun) < 1e-4
    assert res["v"].shape == (0,)


def test_row_sharded_phase1_unbounded_region_terminates():
    """min s is unbounded below on an unbounded feasible region; the
    s >= -1 bound must terminate phase one with a certificate and the
    main solve must still run (bounded here by the box)."""
    n = 12
    C = -np.eye(n)
    d = -np.ones(n)            # x >= 1 (origin infeasible)
    c = np.ones(n)
    A0 = np.zeros((0, n))
    mesh = make_mesh(8, ("rows",))
    res = solve_lp_row_sharded(mesh, c, A0, np.zeros(0), C, d,
                               lb=-10.0, ub=10.0,
                               x0=np.zeros(n), epsilon=1e-6)
    # optimum: x = 1 (componentwise), objective n
    assert abs(float(res["objective"]) - n) < 1e-3


def test_row_sharded_checkpoint_resume(tmp_path):
    """Mid-solve checkpoint/resume on the distributed LP solve: a
    partial run (killed after 3 barrier stages) resumed in a FRESH call
    must reach the clean run's optimum with the SAME total stage count,
    without re-running phase one (the distributed analogue of
    tests/test_checkpoint.py::test_midsolve_checkpoint_resume)."""
    mesh = make_mesh(8, ("rows",))
    rng = np.random.default_rng(41)
    n, m, k = 30, 21, 19
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b = A @ x_feas
    d = C @ x_feas + 0.5
    kw = dict(lb=-3.0, ub=3.0, epsilon=1e-9)

    clean = solve_lp_row_sharded(mesh, c, A, b, C, d, x0=x_feas, **kw)
    assert clean["outer_iters"] > 3

    path = str(tmp_path / "dist_lp.npz")
    part = solve_lp_row_sharded(mesh, c, A, b, C, d, x0=x_feas,
                                max_outer_iters=3, checkpoint_path=path,
                                **kw)
    assert part["outer_iters"] == 3

    # resume from an infeasible x0: the checkpointed iterate (strictly
    # feasible) must be used instead, skipping phase one entirely
    res = solve_lp_row_sharded(mesh, c, A, b, C, d, x0=x_feas + 50.0,
                               checkpoint_path=path, resume=True, **kw)
    assert res["outer_iters"] == clean["outer_iters"]
    assert float(res["objective"]) == pytest.approx(
        float(clean["objective"]), rel=1e-9, abs=1e-9)
    np.testing.assert_allclose(np.asarray(res["x"]),
                               np.asarray(clean["x"]), atol=1e-7)

    # resuming a COMPLETED checkpoint is a no-op (no device work)
    again = solve_lp_row_sharded(mesh, c, A, b, C, d,
                                 checkpoint_path=path, resume=True, **kw)
    assert again["outer_iters"] == clean["outer_iters"]
    assert float(again["objective"]) == pytest.approx(
        float(clean["objective"]), abs=1e-12)


def test_row_sharded_checkpoint_budget_and_validation(tmp_path):
    """checkpoint_every > 1 must never overshoot max_outer_iters (the
    tail chunk runs exactly the remaining budget via the traced
    max_outer operand), checkpoint_every < 1 raises, and a
    max_outer_iters=0 checkpointed run still returns a device-computed
    objective instead of None."""
    mesh = make_mesh(8, ("rows",))
    rng = np.random.default_rng(47)
    n, m, k = 24, 16, 12
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    b, d = A @ xf, C @ xf + 0.5
    kw = dict(lb=-3.0, ub=3.0, x0=xf, epsilon=1e-9)
    path = str(tmp_path / "b.npz")

    res = solve_lp_row_sharded(mesh, c, A, b, C, d, max_outer_iters=5,
                               checkpoint_path=path, checkpoint_every=3,
                               **kw)
    assert res["outer_iters"] == 5  # 3 + 2, not 3 + 3

    with pytest.raises(ValueError, match="checkpoint_every"):
        solve_lp_row_sharded(mesh, c, A, b, C, d, checkpoint_path=path,
                             checkpoint_every=0, **kw)

    res0 = solve_lp_row_sharded(mesh, c, A, b, C, d, max_outer_iters=0,
                                checkpoint_path=str(tmp_path / "z.npz"),
                                **kw)
    assert res0["outer_iters"] == 0
    assert float(res0["objective"]) == pytest.approx(float(c @ xf))


def test_row_sharded_phase1_checkpoint_sidecar(tmp_path):
    """A job with checkpointing enabled persists the phase-1 barrier in
    the .p1 sidecar, and a fresh resume reuses the completed phase-1
    state instead of re-running it (review finding: phase 1 was never
    checkpointed)."""
    import os

    mesh = make_mesh(8, ("rows",))
    rng = np.random.default_rng(53)
    n, k = 20, 14
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    d = C @ xf + 0.5
    A0, b0 = np.zeros((0, n)), np.zeros((0,))
    path = str(tmp_path / "p.npz")
    kw = dict(lb=-3.0, ub=3.0, epsilon=1e-8)
    x_bad = xf + 10.0   # infeasible: routes through phase one

    part = solve_lp_row_sharded(mesh, c, A0, b0, C, d, x0=x_bad,
                                max_outer_iters=2, checkpoint_path=path,
                                **kw)
    assert os.path.exists(path + ".p1")   # phase-1 barrier checkpointed
    p1 = np.load(path + ".p1")
    assert bool(p1["done"]) or p1["outer_iters"] > 0

    res = solve_lp_row_sharded(mesh, c, A0, b0, C, d, x0=x_bad,
                               checkpoint_path=path, resume=True, **kw)
    clean = solve_lp_row_sharded(mesh, c, A0, b0, C, d, x0=x_bad, **kw)
    assert float(res["objective"]) == pytest.approx(
        float(clean["objective"]), rel=1e-7, abs=1e-7)


def test_batched_socp_sharded_matches_slsqp():
    """8 SOCP instances solved in one vmapped program (dp over problems,
    completing the batching story across the IPM classes); every
    instance must match its own SLSQP optimum."""
    from scipy.optimize import minimize

    from interiorpoint.models.problem import make_socp

    mesh = make_mesh(8, ("batch",))
    n, K, M = 10, 3, 4
    probs, x0s, refs = [], [], []
    for s in range(8):
        rng = np.random.default_rng(200 + s)
        A = [rng.standard_normal((M, n)) for _ in range(K)]
        b = [rng.standard_normal(M) for _ in range(K)]
        cc = [rng.standard_normal(n) for _ in range(K)]
        x0 = rng.standard_normal(n) * 0.1
        d = [np.linalg.norm(A[k] @ x0 + b[k]) - cc[k] @ x0 + 1.0
             for k in range(K)]
        Mq = rng.uniform(-1, 1, (n, n))
        P = Mq.T @ Mq + np.eye(n)
        q = rng.uniform(-1, 1, n)
        probs.append(make_socp(A, b, cc, d, P=P, q=q, lb=-3.0, ub=3.0))
        x0s.append(x0)
        cons = [{"type": "ineq",
                 "fun": lambda x, k=k, A=A, b=b, cc=cc, d=d:
                 (cc[k] @ x + d[k]) - np.linalg.norm(A[k] @ x + b[k])}
                for k in range(K)]
        ref = minimize(lambda x, P=P, q=q: 0.5 * x @ P @ x + q @ x, x0,
                       method="SLSQP", constraints=cons,
                       bounds=[(-3, 3)] * n,
                       options={"maxiter": 400, "ftol": 1e-12})
        assert ref.success, ref.message
        refs.append(ref.fun)

    # one cone-infeasible start: the per-instance phase one inside the
    # vmapped program must restore it without disturbing the others
    x0s[3] = x0s[3] + 5.0
    batch = stack_problems(probs)
    x0_batch = jnp.asarray(np.stack(x0s), dtype=jnp.float64)
    cfg = SolverConfig(epsilon=1e-9, t0=1.0, dtype="float64",
                       eq_gate=1e-3)
    res = solve_batch(batch, x0_batch, cfg, mesh=mesh)
    np.testing.assert_allclose(np.asarray(res.value), np.asarray(refs),
                               rtol=1e-5, atol=1e-5)
