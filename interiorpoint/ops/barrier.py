"""Barrier oracles: pure-function objective / gradient / Hessian / slack
evaluation for each problem family, plus closed-form line-search candidate
sweeps.

This replaces the reference's stateful ``FunctionManager`` hierarchy
(reference: FunctionManager.py) with pure functions of (problem, x, t).
The dirty-flag caching of the reference (FunctionManager.py:94-116) is
unnecessary: everything lives in one jitted program, so XLA CSE reuses
shared subexpressions.

The key departure is the **candidate line search**: the
reference's backtracking loop evaluates one trial step at a time with a
host-synced `(slacks < 0).any()` check per trial
(reference: NewtonSolver.py:174-206, NewtonSolverInfeasibleStart.py:184-269).
Because every slack is affine in the step size σ (and quadratic for SOCP
cones), the slack/gradient/objective at *all* J = ``max_linesearch_steps``
candidate steps β^k can be computed in closed form as a few batched
matmuls — one fused device-side sweep with zero host round trips, selecting
exactly the step the reference's sequential search would select (see
ops/newton.py for the selection rule).

Deviation from the reference, by design: during its Armijo phase the
reference re-evaluates gradients against *stale* slack vectors
(``update_x(next_x, update_slacks=False)``; NewtonSolver.py:196-202,
FunctionManager.py:243-247), an approximation knob (``update_slacks_every``)
used to keep the Python loop cheap.  Our sweep uses exact slacks for every
candidate at no extra cost, so the knob is unnecessary and is ignored.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..models.problem import LPProblem, QPProblem, SOCPProblem

# Numerical-stability epsilons, matching the reference's constants:
# 1e-15 added to slacks inside logs/reciprocals (FunctionManager.py:224-227,
# 244-246); 1e-12 for SOCP cone slacks (FunctionManager.py:1084-1137).
SLACK_EPS = 1e-15
SOCP_SLACK_EPS = 1e-12


class Oracle(NamedTuple):
    """Bundle of pure functions consumed by the Newton engines.

    All closures capture the problem pytree; ``diag_hessian`` is a
    trace-time static flag selecting the diagonal-Hessian fast path
    (reference: FunctionManager.py:283-292, LPSolver.py:377-448).
    """

    n: int                       # number of optimization variables
    diag_hessian: bool
    obj: callable                # (x,) -> scalar objective
    grad: callable               # (x, t) -> (n,) gradient of t*f - sum log s
    hess: callable               # (x, t) -> (n, n), or (n,) if diag_hessian
    newton_obj: callable         # (x, t) -> scalar  t*f(x) - sum log s
    min_slack: callable          # (x,) -> scalar min slack (phase-1 gating)
    ls_grads: callable           # (x, dx, t, sigmas) -> (domain_ok, grads)
    ls_objs: callable            # (x, dx, t, sigmas) -> (domain_ok, nobjs)


# ---------------------------------------------------------------------------
# LP / QP oracle (LP is QP with P=None; reference: FunctionManagerLP at
# FunctionManager.py:197-356, FunctionManagerQP at :619-831).
# ---------------------------------------------------------------------------


def _linear_slack_parts(prob, x):
    """Slack segments in reference order [Cx<=d, ub, lb]
    (reference: FunctionManager.py:118-149)."""
    parts = []
    if prob.C is not None:
        parts.append(prob.d - prob.C @ x)
    if prob.ub is not None:
        parts.append(prob.ub - x)
    if prob.lb is not None:
        parts.append(x - prob.lb)
    return parts


def _linear_dslack_parts(prob, dx):
    """d(slack)/dσ for step x + σ·dx, with slack(σ) = s0 - σ·ds."""
    parts = []
    if prob.C is not None:
        parts.append(prob.C @ dx)
    if prob.ub is not None:
        parts.append(dx)
    if prob.lb is not None:
        parts.append(-dx)
    return parts


def full_linear_slacks(prob, x):
    """Concatenated slack vector in reference order [Cx≤d, ub, lb]
    (reference: FunctionManager.py:118-149); used for dual recovery
    λ* = 1/(t·slacks) (reference: LPSolver.py:641-646)."""
    parts = _linear_slack_parts(prob, x)
    if not parts:
        return jnp.zeros((0,), dtype=x.dtype)
    return jnp.concatenate([p.reshape(-1) for p in parts])


def make_qp_oracle(prob, try_diag: bool = True) -> Oracle:
    """Oracle for LP/QP barrier subproblems.

    ``prob`` is an LPProblem or QPProblem.  For LPProblem the quadratic term
    is absent and the linear cost is ``c``; for QPProblem it is (P, q).
    """
    is_qp = isinstance(prob, QPProblem)
    P = prob.P if is_qp else None
    lin = (prob.q if prob.q is not None else None) if is_qp else prob.c
    n = prob.n
    bounded = prob.lb is not None or prob.ub is not None
    # Diagonal fast path: LP only, no dense inequality block, bounded
    # (reference: FunctionManager.py:283-292; QP always dense because of P).
    diag = (not is_qp) and try_diag and prob.C is None and bounded

    def obj(x):
        if is_qp:
            val = 0.5 * x @ (P @ x)
            if lin is not None:
                val = val + lin @ x
            return val
        return lin @ x

    def _lin_grad(x):
        if is_qp:
            g = P @ x
            if lin is not None:
                g = g + lin
            return g
        return lin

    def _inv_slacks(x):
        return [1.0 / (s + SLACK_EPS) for s in _linear_slack_parts(prob, x)]

    def grad(x, t):
        g = t * _lin_grad(x)
        invs = iter(_inv_slacks(x))
        if prob.C is not None:
            g = g + (prob.C.T @ next(invs))
        if prob.ub is not None:
            g = g + next(invs)
        if prob.lb is not None:
            g = g - next(invs)
        return g

    def hess(x, t):
        invs = iter(_inv_slacks(x))
        if diag:
            h = jnp.zeros((n,), dtype=x.dtype)
            if prob.ub is not None:
                h = h + next(invs) ** 2
            if prob.lb is not None:
                h = h + next(invs) ** 2
            return h
        if is_qp:
            H = t * P
        else:
            H = jnp.zeros((n, n), dtype=x.dtype)
        if prob.C is not None:
            ic = next(invs)
            # Fused barrier-Hessian assembly CᵀD²C
            # (reference: FunctionManager.py:301-312).
            H = H + prob.C.T @ (ic[:, None] ** 2 * prob.C)
        db = jnp.zeros((n,), dtype=x.dtype)
        if prob.ub is not None:
            db = db + next(invs) ** 2
        if prob.lb is not None:
            db = db + next(invs) ** 2
        if bounded:
            H = H + jnp.diag(db)
        return H

    def newton_obj(x, t):
        val = t * obj(x)
        for s in _linear_slack_parts(prob, x):
            val = val - jnp.sum(jnp.log(s + SLACK_EPS))
        return val

    def min_slack(x):
        parts = _linear_slack_parts(prob, x)
        if not parts:
            return jnp.asarray(jnp.inf, dtype=x.dtype)
        return jnp.min(jnp.concatenate([p.reshape(-1) for p in parts]))

    def _cand_slacks(x, dx, sigmas):
        """Per-segment candidate slacks, shape (seg_len, J)."""
        s0 = _linear_slack_parts(prob, x)
        ds = _linear_dslack_parts(prob, dx)
        return [a[:, None] - sigmas[None, :] * b[:, None] for a, b in zip(s0, ds)]

    def _domain_ok(cands):
        if not cands:
            return None
        ok = jnp.ones(cands[0].shape[1], dtype=bool)
        for cs in cands:
            ok = ok & jnp.all(cs > 0.0, axis=0)
        return ok

    def ls_grads(x, dx, t, sigmas):
        """Candidate gradients for the infeasible-start residual search.

        grad(x+σdx) = t·(Px+q) + σ·t·(Pdx) + Cᵀ(1/s_C(σ)) + 1/s_ub(σ)
                      − 1/s_lb(σ); one (n,k)×(k,J) matmul total.
        """
        J = sigmas.shape[0]
        cands = _cand_slacks(x, dx, sigmas)
        ok = _domain_ok(cands)
        if ok is None:
            ok = jnp.ones(J, dtype=bool)
        g0 = t * _lin_grad(x)
        grads = jnp.broadcast_to(g0[:, None], (n, J))
        if is_qp:
            grads = grads + sigmas[None, :] * (t * (P @ dx))[:, None]
        it = iter(cands)
        if prob.C is not None:
            grads = grads + prob.C.T @ (1.0 / (next(it) + SLACK_EPS))
        if prob.ub is not None:
            grads = grads + 1.0 / (next(it) + SLACK_EPS)
        if prob.lb is not None:
            grads = grads - 1.0 / (next(it) + SLACK_EPS)
        return ok, grads

    def ls_objs(x, dx, t, sigmas):
        """Candidate Newton objectives for the feasible-start Armijo search.

        t·f(x+σdx) is quadratic in σ; the log-barrier term sums logs of the
        affine candidate slacks.
        """
        J = sigmas.shape[0]
        cands = _cand_slacks(x, dx, sigmas)
        ok = _domain_ok(cands)
        if ok is None:
            ok = jnp.ones(J, dtype=bool)
        f0 = obj(x)
        lin_term = _lin_grad(x) @ dx
        vals = t * (f0 + sigmas * lin_term)
        if is_qp:
            vals = vals + t * (0.5 * (dx @ (P @ dx))) * sigmas**2
        for cs in cands:
            vals = vals - jnp.sum(jnp.log(cs + SLACK_EPS), axis=0)
        return ok, vals

    return Oracle(n=n, diag_hessian=diag, obj=obj, grad=grad, hess=hess,
                  newton_obj=newton_obj, min_slack=min_slack,
                  ls_grads=ls_grads, ls_objs=ls_objs)


# ---------------------------------------------------------------------------
# Phase-one oracle for LP/QP: min s  s.t. slack_i(x) + s >= 0 over the
# augmented variable z = [x, s] (reference: FunctionManagerPhase1 at
# FunctionManager.py:359-616).
# ---------------------------------------------------------------------------


def make_phase1_linear_oracle(prob) -> Oracle:
    """Phase-one oracle over z = [x, s] for a problem with linear
    inequalities/bounds.  Objective is s; barrier slacks are s + slack_i(x).
    """
    n = prob.n
    nz = n + 1

    def _slack_parts(z):
        x, s = z[:-1], z[-1]
        return [p + s for p in _linear_slack_parts(prob, x)]

    def obj(z):
        return z[-1]

    def _inv(z):
        return [1.0 / (p + SLACK_EPS) for p in _slack_parts(z)]

    def grad(z, t):
        invs = _inv(z)
        it = iter(invs)
        gx = jnp.zeros((n,), dtype=z.dtype)
        if prob.C is not None:
            gx = gx + prob.C.T @ next(it)
        if prob.ub is not None:
            gx = gx + next(it)
        if prob.lb is not None:
            gx = gx - next(it)
        gs = t - sum(jnp.sum(v) for v in invs)
        return jnp.concatenate([gx, gs[None]])

    def hess(z, t):
        """Bordered Hessian [[H_xx, h_xs], [h_xsᵀ, h_ss]]
        (reference: FunctionManager.py:547-611)."""
        invs = _inv(z)
        it = iter(invs)
        dtype = z.dtype
        Hxx = jnp.zeros((n, n), dtype=dtype)
        hxs = jnp.zeros((n,), dtype=dtype)
        if prob.C is not None:
            ic2 = next(it) ** 2
            Hxx = Hxx + prob.C.T @ (ic2[:, None] * prob.C)
            hxs = hxs - prob.C.T @ ic2
        db = jnp.zeros((n,), dtype=dtype)
        if prob.ub is not None:
            iu2 = next(it) ** 2
            db = db + iu2
            hxs = hxs - iu2
        if prob.lb is not None:
            il2 = next(it) ** 2
            db = db + il2
            hxs = hxs + il2
        Hxx = Hxx + jnp.diag(db)
        hss = sum(jnp.sum(v**2) for v in invs)
        top = jnp.concatenate([Hxx, hxs[:, None]], axis=1)
        bot = jnp.concatenate([hxs, hss[None]])[None, :]
        return jnp.concatenate([top, bot], axis=0)

    def newton_obj(z, t):
        val = t * z[-1]
        for p in _slack_parts(z):
            val = val - jnp.sum(jnp.log(p + SLACK_EPS))
        return val

    def min_slack(z):
        parts = _slack_parts(z)
        return jnp.min(jnp.concatenate([p.reshape(-1) for p in parts]))

    def _cand_slacks(z, dz, sigmas):
        x, dx, dsg = z[:-1], dz[:-1], dz[-1]
        s0 = _slack_parts(z)
        ds = _linear_dslack_parts(prob, dx)  # slack(σ) = s0 - σ·ds + σ·dsg
        return [
            a[:, None] + sigmas[None, :] * (dsg - b)[:, None]
            for a, b in zip(s0, ds)
        ]

    def ls_objs(z, dz, t, sigmas):
        cands = _cand_slacks(z, dz, sigmas)
        ok = jnp.ones(sigmas.shape[0], dtype=bool)
        for cs in cands:
            ok = ok & (cs > 0.0).all(axis=0)
        vals = t * (z[-1] + sigmas * dz[-1])
        for cs in cands:
            vals = vals - jnp.sum(jnp.log(cs + SLACK_EPS), axis=0)
        return ok, vals

    def ls_grads(z, dz, t, sigmas):
        raise NotImplementedError(
            "phase-1 uses the feasible-start engine (reference: "
            "PhaseOneSolver.py:91-110 always dispatches NewtonSolverCholesky)"
        )

    return Oracle(n=nz, diag_hessian=False, obj=obj, grad=grad, hess=hess,
                  newton_obj=newton_obj, min_slack=min_slack,
                  ls_grads=ls_grads, ls_objs=ls_objs)
