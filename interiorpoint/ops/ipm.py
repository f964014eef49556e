"""Barrier (outer) interior-point loop and phase-one wrapper.

The reference's outer loop lives in each driver's ``solve``
(reference: LPSolver.py:514-653, QPSolver.py:500-638, SOCPSolver.py:616-753 —
identical skeletons).  Here it is one generic, fully jitted function over a
state pytree: outer t-loop, Newton inner loop, and line search all compile
into a single XLA program with no host round trips.

Preserved reference semantics (SURVEY.md §7 "hard parts (f)"):
  * best-iterate tracking gated on equality feasibility
    (reference: LPSolver.py:596-616);
  * break when a *converged* Newton step fails to improve the objective;
  * duality-gap stop num_constraints/t < ε (reference: LPSolver.py:629-634);
  * phase-one skipped when the stored feasibility slack < 1
    (reference: LPSolver.py:546);
  * phase-one t-capping t ← min(t·mu, (n+1)/ε)
    (reference: PhaseOneSolver.py:151).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from .barrier import Oracle
from .newton import newton_feasible, newton_infeasible


class Phase1Result(NamedTuple):
    x: jax.Array           # feasible point (slack variable stripped)
    s: jax.Array           # final phase-one objective (feasibility slack)
    outer_iters: jax.Array
    newton_iters: jax.Array


class IPMResult(NamedTuple):
    x: jax.Array                 # best iterate
    v: Optional[jax.Array]       # final equality dual (None if no equalities)
    value: jax.Array             # best objective
    dual_gap: jax.Array
    t: jax.Array                 # final barrier parameter (for dual recovery)
    outer_iters: jax.Array
    inner_iters: jax.Array       # (max_outer_iters,) Newton counts, 0-padded
    obj_vals: jax.Array          # (max_outer_iters,) objective trace (NaN-padded)
    phase1: Optional[Phase1Result]
    # (J,) accepted-candidate-index histogram accumulated over every
    # Newton step (sigma = beta^j, so bin j = number of backtracks) —
    # the reference's ad-hoc backtrack-distribution instrumentation
    # (SURVEY.md §5) as a first-class counter in the state pytree.
    bt_hist: Optional[jax.Array] = None


def phase1_solve(p1_oracle: Oracle, x0, cfg) -> Phase1Result:
    """Barrier loop over the augmented phase-one problem min s s.t.
    slackᵢ(x) + s ≥ 0 (reference: PhaseOneSolver.py:112-154).

    ``x0`` excludes the slack variable; the initial s is
    −min slack(x0) + 1 (reference: FunctionManager.py:390-393).
    """
    def cond(s: Phase1State):
        return (~s.done) & (s.it < cfg.max_outer_iters)

    body = make_phase1_body(p1_oracle, cfg)
    out = lax.while_loop(cond, body, phase1_init(p1_oracle, x0, cfg))
    return Phase1Result(x=out.z[:-1], s=out.z[-1], outer_iters=out.it,
                        newton_iters=out.newton_iters)


class Phase1State(NamedTuple):
    z: jax.Array
    t: jax.Array
    it: jax.Array
    newton_iters: jax.Array
    done: jax.Array


def phase1_init(p1_oracle: Oracle, x0, cfg) -> Phase1State:
    dtype = x0.dtype
    s0 = -p1_oracle.min_slack(
        jnp.concatenate([x0, jnp.zeros((1,), dtype)])) + 1.0
    z0 = jnp.concatenate([x0, s0[None]])
    return Phase1State(
        z=z0, t=jnp.asarray(cfg.phase1_t0, dtype),
        it=jnp.zeros((), jnp.int32),
        newton_iters=jnp.zeros((), jnp.int32),
        done=jnp.zeros((), bool))


def make_phase1_body(p1_oracle: Oracle, cfg):
    """One phase-one stage as a pure state->state function (shared by the
    jitted while_loop and the host-stepped dispatch)."""
    n = p1_oracle.n - 1

    p1cfg = cfg.__class__(**{
        **{f.name: getattr(cfg, f.name)
           for f in cfg.__dataclass_fields__.values()},
        "max_inner_iters": cfg.phase1_max_inner_iters,
        "kkt_strategy": "cholesky",
    })

    def body(s: Phase1State) -> Phase1State:
        res = newton_feasible(
            p1_oracle, s.z, s.t, p1cfg,
            phase1_flag=True, phase1_tol=cfg.phase1_tol,
        )
        obj_val = res.x[-1]
        done = obj_val < -cfg.phase1_tol
        t_new = jnp.minimum(s.t * cfg.mu, (n + 1.0) / cfg.epsilon)
        return Phase1State(z=res.x, t=t_new, it=s.it + 1,
                           newton_iters=s.newton_iters + res.iters, done=done)

    return body


def barrier_solve(oracle: Oracle, A, b, x0, cfg, *, num_constraints: int,
                  eq_gate: float, t0, v0=None,
                  p1_oracle: Optional[Oracle] = None) -> IPMResult:
    """Generic barrier outer loop shared by LP/QP/SOCP drivers.

    Args:
      oracle: barrier oracle for the problem class.
      A, b: equality pair, or None (reference passes SOCP's (F, g) through
        the same slots; SOCPSolver.py:535-553).
      num_constraints: inequality count for the duality gap m/t.
      eq_gate: threshold on ‖Ax−b‖ for accepting an outer iterate
        (reference: LPSolver.py:596-603 / QPSolver.py:585-587).
      p1_oracle: optional phase-one oracle.  When given, phase one runs iff
        the initial feasibility slack ≥ 1 (reference: LPSolver.py:546).
    """
    dtype = x0.dtype
    has_eq = A is not None

    # ---- phase one (conditional, traced with lax.cond) -------------------
    if p1_oracle is not None:
        s_init = -p1_oracle.min_slack(
            jnp.concatenate([x0, jnp.zeros((1,), dtype)])
        ) + 1.0

        def run_p1(x):
            r = phase1_solve(p1_oracle, x, cfg)
            return r

        def skip_p1(x):
            return Phase1Result(
                x=x, s=jnp.asarray(-jnp.inf, dtype),
                outer_iters=jnp.zeros((), jnp.int32),
                newton_iters=jnp.zeros((), jnp.int32),
            )

        p1 = lax.cond(s_init >= 1.0, run_p1, skip_p1, x0)
        x_start = p1.x
    else:
        p1 = None
        x_start = x0

    # ---- outer barrier loop ---------------------------------------------
    def cond(s: OuterState):
        return (~s.done) & (s.it < cfg.max_outer_iters)

    body = make_outer_body(oracle, A, b, cfg,
                           num_constraints=num_constraints, eq_gate=eq_gate)
    init = outer_init(x_start, v0, t0, A, cfg, num_constraints)
    out = lax.while_loop(cond, body, init)
    return IPMResult(
        x=out.best_x, v=out.v if has_eq else None, value=out.best_obj,
        dual_gap=out.dual_gap, t=out.t, outer_iters=out.it,
        inner_iters=out.inner_iters, obj_vals=out.obj_vals, phase1=p1,
        bt_hist=out.bt_hist,
    )


class OuterState(NamedTuple):
    x: jax.Array
    v: jax.Array            # zeros(0) when no equalities
    t: jax.Array
    it: jax.Array
    best_x: jax.Array
    best_obj: jax.Array
    last_obj: jax.Array
    dual_gap: jax.Array
    inner_iters: jax.Array
    obj_vals: jax.Array
    bt_hist: jax.Array
    done: jax.Array


def outer_init(x_start, v0, t0, A, cfg, num_constraints=0) -> OuterState:
    dtype = x_start.dtype
    m_eq = A.shape[0] if A is not None else 0
    if v0 is None:
        v0 = jnp.zeros((m_eq,), dtype)
    return OuterState(
        x=x_start,
        v=v0,
        t=jnp.asarray(t0, dtype),
        it=jnp.zeros((), jnp.int32),
        best_x=x_start,
        best_obj=jnp.asarray(jnp.inf, dtype),
        last_obj=jnp.asarray(jnp.nan, dtype),
        dual_gap=jnp.asarray(float(num_constraints), dtype),
        inner_iters=jnp.zeros((cfg.max_outer_iters,), jnp.int32),
        obj_vals=jnp.full((cfg.max_outer_iters,), jnp.nan, dtype),
        bt_hist=jnp.zeros((cfg.max_linesearch_steps,), jnp.int32),
        done=jnp.zeros((), bool),
    )


def make_outer_body(oracle: Oracle, A, b, cfg, *, num_constraints: int,
                    eq_gate: float):
    """One outer (centering) stage as a pure state->state function — used
    both inside barrier_solve's while_loop and, jitted standalone, by the
    host-stepped dispatch (models/base.py) that bounds single-dispatch
    device time.
    """
    has_eq = A is not None

    def body(s: OuterState) -> OuterState:
        if has_eq:
            res = newton_infeasible(oracle, A, b, s.x, s.v, s.t, cfg)
            v_new = res.v
            eq_ok = jnp.linalg.norm(A @ res.x - b) < eq_gate
        else:
            res = newton_feasible(oracle, s.x, s.t, cfg)
            v_new = s.v
            eq_ok = jnp.ones((), bool)

        x_new = res.x
        obj_val = oracle.obj(x_new)

        improved = obj_val < s.best_obj
        take = eq_ok & improved
        best_x = jnp.where(take, x_new, s.best_x)
        best_obj = jnp.where(take, obj_val, s.best_obj)
        # Converged Newton step that failed to improve → stop
        # (reference: LPSolver.py:610-616).
        break_improve = eq_ok & (~improved) & res.success

        # Objective trace: record obj when feasible, else carry last
        # (reference: LPSolver.py:605-622).
        traced_obj = jnp.where(eq_ok, obj_val, s.last_obj)
        obj_vals = s.obj_vals.at[s.it].set(traced_obj)
        inner_iters = s.inner_iters.at[s.it].set(res.iters)
        bt_hist = s.bt_hist + res.bt_hist

        gap_new = num_constraints / s.t
        dual_gap = jnp.where(break_improve, s.dual_gap, gap_new)
        done = break_improve | (gap_new < cfg.epsilon)

        # t is only advanced when the loop continues, so the exit-time t
        # matches the reference's dual recovery λ* = 1/(t·slacks)
        # (reference: LPSolver.py:629-646).
        t_new = jnp.where(done, s.t, s.t * cfg.mu)
        return OuterState(
            x=x_new, v=v_new, t=t_new, it=s.it + 1,
            best_x=best_x, best_obj=best_obj, last_obj=traced_obj,
            dual_gap=dual_gap, inner_iters=inner_iters,
            obj_vals=obj_vals, bt_hist=bt_hist, done=done)

    return body
