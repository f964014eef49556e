"""Newton engines: jitted inner loops for the barrier method.

Two engines, mirroring the reference's split:

* ``newton_infeasible``: primal-dual Newton on the KKT system with residual
  backtracking (reference: NewtonSolverInfeasibleStart.py:72-273) — used
  when equality constraints are present.
* ``newton_feasible``: plain Newton with Armijo backtracking on the barrier
  objective and Newton-decrement stopping
  (reference: NewtonSolver.py:80-206) — used for phase-one and problems
  without equality constraints.

Both are single ``lax.while_loop``s over a state pytree: the reference's
per-iteration host syncs (every ``(slacks < 0).any()`` / scalar compare on
GPU, see SURVEY.md §3.2) do not exist here — control flow stays on device.

Line-search selection rule: candidates σ = β^k, k = 0..J−1.  We accept the
*largest* σ whose candidate passes both the domain check (all slacks > 0)
and the descent check.  Because slacks are affine (or cone-quadratic with a
convex feasible set) in σ, the feasible σ form an interval containing 0, so
this is exactly the step the reference's two-phase sequential search
(shrink-until-feasible, then shrink-until-descent) would return.
If no candidate passes, the step is "stuck" — the engine returns with
``success=False``, matching the reference's 1e-13 cutoff behaviour
(reference: NewtonSolver.py:130-131, NewtonSolverInfeasibleStart.py:135-136).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .barrier import Oracle
from .kkt import solve_kkt_eq, solve_newton_step


class NewtonResult(NamedTuple):
    x: jax.Array
    v: Optional[jax.Array]   # dual iterate (None for feasible-start engine)
    iters: jax.Array         # number of Newton iterations executed
    resid: jax.Array         # final residual norm / Newton decrement
    success: jax.Array       # bool
    # (J,) histogram of accepted candidate indices (sigma = beta^j): the
    # backtrack-count distribution the reference instrumented ad hoc
    # (SURVEY.md §5: testing/plots/backtrack_distribution.png)
    bt_hist: Optional[jax.Array] = None


def _sigmas(cfg, dtype):
    k = jnp.arange(cfg.max_linesearch_steps, dtype=dtype)
    return jnp.asarray(cfg.beta, dtype=dtype) ** k


def _pick_step(accept, sigmas):
    """First (largest) accepted candidate; 0.0 if none (stuck)."""
    any_acc = jnp.any(accept)
    j = jnp.argmax(accept)  # first True
    sigma = jnp.where(any_acc, sigmas[j], jnp.zeros((), dtype=sigmas.dtype))
    return any_acc, j, sigma


def newton_infeasible(oracle: Oracle, A, b, x0, v0, t, cfg) -> NewtonResult:
    """Infeasible-start Newton for min t·f(x) s.t. Ax = b.

    Residual backtracking: accept σ with ‖r(x+σdx, v+σdv)‖ ≤ (1−ασ)‖r‖
    (reference: NewtonSolverInfeasibleStart.py:239).
    """
    dtype = x0.dtype
    sigmas = _sigmas(cfg, dtype)

    class S(NamedTuple):
        x: jax.Array
        v: jax.Array
        it: jax.Array
        resid: jax.Array
        done: jax.Array
        success: jax.Array
        hist: jax.Array

    def cond(s: S):
        return (~s.done) & (s.it < cfg.max_inner_iters)

    def body(s: S):
        g = oracle.grad(s.x, t)
        H = oracle.hess(s.x, t)
        rpri = A @ s.x - b
        dx, w = solve_kkt_eq(
            H, A, g, rpri, cfg.kkt_strategy,
            use_psd_condition=cfg.use_psd_condition,
            refine_steps=cfg.refine_steps,
            diag=oracle.diag_hessian,
            mixed=cfg.mixed_precision,
        )
        dv = w - s.v

        # Cached products reused across all candidates
        # (reference: NewtonSolverInfeasibleStart.py:195-205).
        ATv = A.T @ s.v
        ATdv = A.T @ dv
        Adx = A @ dx

        r0 = jnp.sqrt(jnp.sum((g + ATv) ** 2) + jnp.sum(rpri**2))

        ok, grads = oracle.ls_grads(s.x, dx, t, sigmas)
        r_dual = grads + ATv[:, None] + sigmas[None, :] * ATdv[:, None]
        r_pri = rpri[:, None] + sigmas[None, :] * Adx[:, None]
        rn = jnp.sqrt(jnp.sum(r_dual**2, axis=0) + jnp.sum(r_pri**2, axis=0))

        accept = ok & (rn <= (1.0 - cfg.alpha * sigmas) * r0)
        any_acc, j, sigma = _pick_step(accept, sigmas)

        x_new = s.x + sigma * dx
        v_new = s.v + sigma * dv
        res_new = jnp.where(any_acc, rn[j], r0)

        hist = s.hist.at[j].add(any_acc.astype(jnp.int32))
        converged = res_new < cfg.inner_epsilon
        done = (~any_acc) | converged
        return S(x=x_new, v=v_new, it=s.it + 1, resid=res_new,
                 done=done, success=converged, hist=hist)

    init = S(
        x=x0, v=v0, it=jnp.zeros((), jnp.int32),
        resid=jnp.asarray(jnp.inf, dtype),
        done=jnp.zeros((), bool), success=jnp.zeros((), bool),
        hist=jnp.zeros((sigmas.shape[0],), jnp.int32),
    )
    out = lax.while_loop(cond, body, init)
    return NewtonResult(x=out.x, v=out.v, iters=out.it, resid=out.resid,
                        success=out.success, bt_hist=out.hist)


def newton_feasible(oracle: Oracle, x0, t, cfg, *, phase1_flag: bool = False,
                    phase1_tol: float = 0.1) -> NewtonResult:
    """Feasible-start Newton with Armijo backtracking on the barrier
    objective; stops on Newton decrement −∇fᵀΔx/2 < ε
    (reference: NewtonSolver.py:129-133).

    ``phase1_flag`` enables the early exit when the slack variable (last
    coordinate) drops below −phase1_tol (reference: NewtonSolver.py:105-107).

    Deviation from the reference, by design: the Armijo test uses the
    correct directional derivative ∇fᵀΔx; the reference computes ∇fᵀx
    (reference: NewtonSolver.py:168,186) — an apparent typo catalogued in
    SURVEY.md §7.
    """
    dtype = x0.dtype
    sigmas = _sigmas(cfg, dtype)

    class S(NamedTuple):
        x: jax.Array
        it: jax.Array
        nd: jax.Array
        done: jax.Array
        success: jax.Array
        hist: jax.Array

    def cond(s: S):
        return (~s.done) & (s.it < cfg.max_inner_iters)

    def body(s: S):
        g = oracle.grad(s.x, t)
        H = oracle.hess(s.x, t)
        dx = solve_newton_step(
            H, g, s.x, cfg.kkt_strategy,
            use_psd_condition=cfg.use_psd_condition,
            refine_steps=cfg.refine_steps,
            diag=oracle.diag_hessian,
            max_cg_iters=cfg.max_cg_iters,
            mixed=cfg.mixed_precision,
        )

        f0 = oracle.newton_obj(s.x, t)
        grad_check = g @ dx
        ok, nobjs = oracle.ls_objs(s.x, dx, t, sigmas)
        accept = ok & (nobjs <= f0 + cfg.alpha * sigmas * grad_check)
        any_acc, j, sigma = _pick_step(accept, sigmas)

        x_new = s.x + sigma * dx
        nd = -(g @ dx) / 2.0

        hist = s.hist.at[j].add(any_acc.astype(jnp.int32))
        converged = nd < cfg.inner_epsilon
        if phase1_flag:
            early = x_new[-1] < -phase1_tol
            done = (~any_acc) | converged | early
            success = converged | early
        else:
            done = (~any_acc) | converged
            success = converged
        return S(x=x_new, it=s.it + 1, nd=nd, done=done, success=success,
                 hist=hist)

    init = S(
        x=x0, it=jnp.zeros((), jnp.int32),
        nd=jnp.asarray(jnp.inf, dtype),
        done=jnp.zeros((), bool), success=jnp.zeros((), bool),
        hist=jnp.zeros((sigmas.shape[0],), jnp.int32),
    )
    out = lax.while_loop(cond, body, init)
    return NewtonResult(x=out.x, v=None, iters=out.it, resid=out.nd,
                        success=out.success, bt_hist=out.hist)
