"""Barrier-oracle unit tests: analytic gradients/Hessians cross-checked
against jax.grad / jax.hessian of the Newton objective.

Mirrors the reference's hand-computed derivative tests
(reference: AutomatedTestsPhaseOne.py:15-193) with autodiff as the oracle,
per SURVEY.md §4.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from interiorpoint.models.problem import make_lp, make_qp
from interiorpoint.ops.barrier import (
    full_linear_slacks,
    make_phase1_linear_oracle,
    make_qp_oracle,
)

RNG = np.random.default_rng(0)


def _random_lp(n=7, m=4, k=5, bounds=True, eq=True, ineq=True):
    A = RNG.uniform(-2, 2, (m, n)) if eq else None
    C = RNG.uniform(-2, 2, (k, n)) if ineq else None
    x_feas = RNG.uniform(-1, 1, n)
    c = RNG.uniform(-2, 2, n)
    b = A @ x_feas if eq else None
    # strict interior for the barrier
    d = C @ x_feas + RNG.uniform(0.5, 1.5, k) if ineq else None
    lb, ub = (-3.0, 3.0) if bounds else (None, None)
    return make_lp(c, A, b, C, d, lb, ub), x_feas


def _random_qp(n=6, m=3, k=4):
    Pp = RNG.uniform(-1, 1, (m, n))
    P = Pp.T @ Pp + np.eye(n)
    q = RNG.uniform(-2, 2, n)
    A = RNG.uniform(-2, 2, (m, n))
    C = RNG.uniform(-2, 2, (k, n))
    x_feas = RNG.uniform(-1, 1, n)
    return make_qp(P, q, A, A @ x_feas, C, C @ x_feas + 1.0, -3.0, 3.0), x_feas


@pytest.mark.parametrize("bounds,ineq", [(True, True), (True, False),
                                         (False, True)])
def test_lp_oracle_grad_hess_vs_autodiff(bounds, ineq):
    prob, x = _random_lp(bounds=bounds, ineq=ineq)
    oracle = make_qp_oracle(prob, try_diag=False)
    t = jnp.asarray(3.7)
    x = jnp.asarray(x)

    g_auto = jax.grad(lambda xx: oracle.newton_obj(xx, t))(x)
    np.testing.assert_allclose(oracle.grad(x, t), g_auto, rtol=1e-9)

    H_auto = jax.hessian(lambda xx: oracle.newton_obj(xx, t))(x)
    np.testing.assert_allclose(oracle.hess(x, t), H_auto, rtol=1e-8,
                               atol=1e-10)


def test_lp_oracle_diag_path_matches_dense():
    prob, x = _random_lp(ineq=False, bounds=True)
    x = jnp.asarray(x)
    t = jnp.asarray(2.0)
    dense = make_qp_oracle(prob, try_diag=False)
    diag = make_qp_oracle(prob, try_diag=True)
    assert diag.diag_hessian and not dense.diag_hessian
    np.testing.assert_allclose(jnp.diag(dense.hess(x, t)), diag.hess(x, t),
                               rtol=1e-12)


def test_qp_oracle_grad_hess_vs_autodiff():
    prob, x = _random_qp()
    oracle = make_qp_oracle(prob)
    t = jnp.asarray(0.9)
    x = jnp.asarray(x)
    g_auto = jax.grad(lambda xx: oracle.newton_obj(xx, t))(x)
    np.testing.assert_allclose(oracle.grad(x, t), g_auto, rtol=1e-9)
    H_auto = jax.hessian(lambda xx: oracle.newton_obj(xx, t))(x)
    np.testing.assert_allclose(oracle.hess(x, t), H_auto, rtol=1e-8,
                               atol=1e-10)


def test_qp_objective_value():
    prob, x = _random_qp()
    oracle = make_qp_oracle(prob)
    x = jnp.asarray(x)
    expect = 0.5 * x @ (np.asarray(prob.P) @ x) + np.asarray(prob.q) @ x
    np.testing.assert_allclose(oracle.obj(x), expect, rtol=1e-12)


def test_phase1_oracle_grad_hess_vs_autodiff():
    prob, x = _random_lp()
    oracle = make_phase1_linear_oracle(prob)
    # z = [x, s] with s large enough for strictly positive phase-1 slacks
    z = jnp.concatenate([jnp.asarray(x), jnp.asarray([5.0])])
    t = jnp.asarray(1.3)
    g_auto = jax.grad(lambda zz: oracle.newton_obj(zz, t))(z)
    np.testing.assert_allclose(oracle.grad(z, t), g_auto, rtol=1e-9)
    H_auto = jax.hessian(lambda zz: oracle.newton_obj(zz, t))(z)
    np.testing.assert_allclose(oracle.hess(z, t), H_auto, rtol=1e-8,
                               atol=1e-10)


def test_phase1_objective_is_slack_var():
    prob, x = _random_lp()
    oracle = make_phase1_linear_oracle(prob)
    z = jnp.concatenate([jnp.asarray(x), jnp.asarray([2.5])])
    assert float(oracle.obj(z)) == 2.5


def test_linesearch_candidates_match_pointwise_eval():
    """ls_grads/ls_objs closed forms must equal direct evaluation at
    x + σ·dx for every candidate σ."""
    prob, x = _random_lp()
    oracle = make_qp_oracle(prob, try_diag=False)
    x = jnp.asarray(x)
    dx = jnp.asarray(RNG.uniform(-0.2, 0.2, x.shape[0]))
    t = jnp.asarray(4.2)
    sigmas = jnp.asarray(0.6) ** jnp.arange(8, dtype=x.dtype)

    ok, grads = oracle.ls_grads(x, dx, t, sigmas)
    ok2, nobjs = oracle.ls_objs(x, dx, t, sigmas)
    for j, s in enumerate(np.asarray(sigmas)):
        xs = x + s * dx
        slack_min = float(oracle.min_slack(xs))
        assert bool(ok[j]) == (slack_min > 0.0)
        assert bool(ok2[j]) == (slack_min > 0.0)
        if slack_min > 0:
            np.testing.assert_allclose(grads[:, j], oracle.grad(xs, t),
                                       rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(nobjs[j], oracle.newton_obj(xs, t),
                                       rtol=1e-9)


def test_full_linear_slacks_order():
    """Slack ordering must be [Cx≤d, ub, lb]
    (reference: FunctionManager.py:50-62)."""
    prob, x = _random_lp()
    x = jnp.asarray(x)
    s = np.asarray(full_linear_slacks(prob, x))
    k = prob.C.shape[0]
    n = prob.n
    np.testing.assert_allclose(s[:k], np.asarray(prob.d - prob.C @ x))
    np.testing.assert_allclose(s[k:k + n], np.asarray(prob.ub - x))
    np.testing.assert_allclose(s[k + n:], np.asarray(x - prob.lb))


# ---------------------------------------------------------------------------
# Matmul precision of the solve paths: on a GPU a float32 dot left at the
# default precision may run in TF32.  Every float32 dot_general in the
# jitted solve programs must carry Precision.HIGHEST (utils/precision.py).
# ---------------------------------------------------------------------------


def _dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.params["precision"],
                        tuple(v.aval.dtype for v in eqn.invars)))
        for value in eqn.params.values():
            for sub in (value if isinstance(value, (list, tuple))
                        else [value]):
                if hasattr(sub, "eqns"):
                    _dot_precisions(sub, out)
                elif hasattr(getattr(sub, "jaxpr", None), "eqns"):
                    _dot_precisions(sub.jaxpr, out)
    return out


def _spy(monkeypatch, module, name, static, seen):
    """Replace ``module.name`` (a jitted entry) by a wrapper that records
    the dots of the program it traces, with positions ``static`` held
    static, then runs the entry as before."""
    core = getattr(module, name)

    def wrapped(*args, **kwargs):
        dyn = [i for i in range(len(args)) if i not in static]

        def program(*values):
            full = list(args)
            for i, v in zip(dyn, values):
                full[i] = v
            return core(*full, **kwargs)

        traced = jax.make_jaxpr(program)(*[args[i] for i in dyn])
        _dot_precisions(traced.jaxpr, seen)
        return core(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)


def _solve_float32(kind, algorithm):
    from interiorpoint import LassoSolver, LPSolver, QPSolver, SOCPSolver
    from interiorpoint.utils import generators as g

    rng = np.random.RandomState(5)
    common = dict(check_cvxpy=False, dtype="float32")
    if kind == "lasso":
        p = g.generate_lasso(20, num_problems=3, rng=rng)
        LassoSolver(p["A"], p["b"], reg=p["reg"], max_iters=50,
                    **common).solve()
        return
    p = {"lp": g.generate_lp, "qp": g.generate_qp,
         "socp": g.generate_socp}[kind](20, rng=rng)
    if kind == "socp":
        p["F"], p["g"] = p["F"][:4], p["g"][:4]
    else:
        p["d"] = p["d"] + 0.5       # an interior: float32 phase one
    cls = {"lp": LPSolver, "qp": QPSolver, "socp": SOCPSolver}[kind]
    cls(**p, **common, suppress_print=True, algorithm=algorithm,
        epsilon=1e-3).solve()


@pytest.mark.parametrize("kind,algorithm", [
    ("lp", "barrier"), ("lp", "pd"), ("qp", "barrier"), ("qp", "pd"),
    ("socp", "barrier"), ("socp", "pd"), ("lasso", "admm")])
def test_float32_dots_ask_for_highest_precision(monkeypatch, kind,
                                                algorithm):
    from interiorpoint.models import base, lasso, socp
    from interiorpoint.ops import admm

    seen = []
    _spy(monkeypatch, base, "_barrier_core", {5, 6, 7, 8, 9}, seen)
    _spy(monkeypatch, base, "_pd_core", {2}, seen)
    _spy(monkeypatch, socp, "_socp_pd_core", {4}, seen)
    _spy(monkeypatch, admm, "admm_prepare", {1}, seen)
    _spy(monkeypatch, lasso, "admm_core", {3, 4}, seen)
    _solve_float32(kind, algorithm)
    f32 = [prec for prec, dtypes in seen
           if any(dt == jnp.float32 for dt in dtypes)]
    assert f32, "no float32 dot traced: the spy missed the solve program"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(prec == highest for prec in f32), set(f32)
