"""Shared driver machinery for the barrier-method problem classes.

The reference's LP/QP/SOCP drivers are near-identical 700-line classes
(reference: LPSolver.py, QPSolver.py, SOCPSolver.py — see SURVEY.md §3.1);
this base class factors the common intake / x0 synthesis / solve / dual
recovery / plotting, while subclasses supply the problem pytree, oracles,
and class-specific validation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.barrier import full_linear_slacks
from ..ops.ipm import IPMResult, barrier_solve
from ..utils import metrics
from ..utils.config import SolverConfig
from ..utils.precision import highest_precision


def default_dtype() -> str:
    """Solver default precision: float64, matching the reference (which is
    NumPy/CuPy f64 throughout).  Enabling x64 lazily here means a bare
    ``from interiorpoint import LPSolver; LPSolver(...).solve()``
    gets reference-grade accuracy instead of silent f32 (measured: f32
    leaves ~1e-1 inequality violations on the n=200 LP recipe — a real
    footgun for users switching from the reference).  Pass
    ``dtype="float32"`` explicitly to opt into single precision."""
    return "float64"


def ensure_x64(dtype_name: str) -> None:
    """Turn on JAX x64 when a driver is configured for float64.

    Flipping the flag mid-process is supported by JAX; arrays created
    afterwards honor it.  No-op for float32 configs (the flag is left
    alone — turning it OFF could break other x64 users in-process)."""
    if dtype_name == "float64" and not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)


def synthesize_x0(lb, ub, n, rng=None):
    """Initial point from bounds (reference: LPSolver.py:131-143)."""
    if lb is not None and ub is not None:
        return (np.maximum(lb, -1e2) + np.minimum(ub, 1e2)) / 2 * np.ones(n)
    if lb is not None:
        return (np.maximum(lb, -1e2) + 1e-1) * np.ones(n)
    if ub is not None:
        return (np.minimum(ub, 1e2) - 1e-1) * np.ones(n)
    rng = rng or np.random
    return rng.rand(n)


@jax.jit
@highest_precision
def _ls_interior_init(prob):
    """Least-squares interior warm start for a reduced (inequality-only)
    problem: z aiming at uniform slack margin 1, z = argmin‖Cz − (d−1)‖².
    When the result is strictly feasible, phase one is skipped entirely
    (the phase-one gate s ≥ 1 ⇔ min slack ≤ 0 then never trips;
    reference gating: LPSolver.py:546).  New capability — the reference
    always synthesizes x0 from the bounds (LPSolver.py:131-143)."""
    from ..ops.kkt import mixed_posdef_solve

    C, d = prob.C, prob.d
    r = C.shape[1]
    G = C.T @ C
    G = G + (1e-8 * jnp.trace(G) / r) * jnp.eye(r, dtype=G.dtype)
    z = mixed_posdef_solve(G, C.T @ (d - 1.0))
    return z, jnp.min(d - C @ z)


@partial(jax.jit, static_argnames=("oracle_fn",))
@highest_precision
def _obj_only(prob, x, oracle_fn):
    """Objective value alone, jitted so the oracle's curvature caches and
    operand splits are traced-then-DCE'd instead of materialized."""
    return oracle_fn(prob).obj(x)


@partial(jax.jit, static_argnames=("cfg", "oracle_fn", "p1_oracle_fn",
                                   "num_constraints", "eq_gate"))
@highest_precision
def _barrier_core(prob, A, b, x0, t0, cfg, oracle_fn, p1_oracle_fn,
                  num_constraints, eq_gate) -> IPMResult:
    """Single jitted entry for a full LP/QP/SOCP solve (phase one + outer
    barrier loop + Newton + line search).  ``oracle_fn``/``p1_oracle_fn``
    are static callables building oracles from the problem pytree."""
    oracle = oracle_fn(prob)
    p1 = p1_oracle_fn(prob) if p1_oracle_fn is not None else None
    return barrier_solve(
        oracle, A, b, x0, cfg,
        num_constraints=num_constraints, eq_gate=eq_gate, t0=t0,
        p1_oracle=p1,
    )


@partial(jax.jit, static_argnames=("cfg",))
@highest_precision
def _pd_core(prob, z0, cfg, A=None, b=None):
    """Single jitted entry for a primal-dual Mehrotra solve (ops/pd.py) on
    an inequality-form problem pytree, optionally with an equality pair
    (the full-space fallback when the null-space reduction is absent)."""
    from ..ops.pd import pd_solve
    return pd_solve(prob, z0, cfg, A=A, b=b)


# ---------------------------------------------------------------------------
# Host-stepped (staged) dispatch: one device call per barrier stage.
#
# The single-program path above runs the entire solve as one XLA execution.
# The staged path runs the SAME stage body (ops/ipm.py:make_outer_body /
# make_phase1_body) one outer stage per dispatch, reading the scalar `done`
# flag between stages — identical math, bounded per-call device time, at
# the cost of one host sync per stage.  It is selected explicitly
# (``staged_dispatch=True``) and by mid-solve checkpointing, which needs
# the host boundaries.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cfg", "p1_fn"))
@highest_precision
def _p1_init_core(prob, x0, cfg, p1_fn):
    from ..ops.ipm import phase1_init
    return phase1_init(p1_fn(prob), x0, cfg)


@partial(jax.jit, static_argnames=("cfg", "p1_fn"))
@highest_precision
def _p1_stage_core(prob, state, cfg, p1_fn):
    from ..ops.ipm import make_phase1_body
    return make_phase1_body(p1_fn(prob), cfg)(state)


@partial(jax.jit, static_argnames=("cfg", "oracle_fn", "num_constraints",
                                   "eq_gate"))
@highest_precision
def _outer_stage_core(prob, A, b, state, cfg, oracle_fn, num_constraints,
                      eq_gate):
    from ..ops.ipm import make_outer_body
    body = make_outer_body(oracle_fn(prob), A, b, cfg,
                           num_constraints=num_constraints, eq_gate=eq_gate)
    return body(state)


def _barrier_staged(prob, A, b, x0, t0, cfg, oracle_fn, p1_oracle_fn,
                    num_constraints, eq_gate, checkpoint_path=None,
                    resume=False) -> IPMResult:
    """Host-stepped equivalent of _barrier_core.

    ``checkpoint_path`` persists the full OuterState after every barrier
    stage (atomic .npz); ``resume=True`` continues from the last
    completed stage in that file instead of starting fresh — true
    mid-solve resume (utils/checkpoint.py)."""
    from ..ops.ipm import Phase1Result, outer_init
    from ..utils import checkpoint as _ckpt

    dtype = x0.dtype
    p1 = None
    x_start = x0
    ck = (_ckpt.load_outer_state(checkpoint_path)
          if (checkpoint_path is not None and resume) else None)
    resume_outer = ck is not None and any(k.startswith("state_") for k in ck)
    resume_p1 = ck is not None and not resume_outer
    p1_failed = False
    if resume_outer:
        template = outer_init(x_start, None, jnp.asarray(t0, dtype), A,
                              cfg, num_constraints)
        state = _ckpt.restore_outer_state(template, ck)
        p1 = _ckpt.restore_phase1(ck, dtype)
    else:
        if p1_oracle_fn is not None:
            st = _p1_init_core(prob, x0, cfg, p1_oracle_fn)
            if resume_p1:
                st = _ckpt.restore_p1_state(st, ck)
            if resume_p1 or float(st.z[-1]) >= 1.0:   # gate (LPSolver.py:546)
                while (not bool(st.done)) and int(st.it) < cfg.max_outer_iters:
                    st = _p1_stage_core(prob, st, cfg, p1_oracle_fn)
                    if checkpoint_path is not None:
                        _ckpt.save_p1_state(checkpoint_path,
                                            jax.device_get(st))
                p1 = Phase1Result(x=st.z[:-1], s=st.z[-1], outer_iters=st.it,
                                  newton_iters=st.newton_iters)
                x_start = p1.x
                # cap hit without feasibility: skip the main loop (driver
                # raises on phase1.s) and keep the phase-1 checkpoint so
                # a resume continues phase one, not an infeasible barrier
                p1_failed = not bool(st.done)
            else:
                p1 = Phase1Result(
                    x=x0, s=jnp.asarray(-jnp.inf, dtype),
                    outer_iters=jnp.zeros((), jnp.int32),
                    newton_iters=jnp.zeros((), jnp.int32))

        state = outer_init(x_start, None, jnp.asarray(t0, dtype), A, cfg,
                           num_constraints)
    while (not p1_failed and not bool(state.done)
           and int(state.it) < cfg.max_outer_iters):
        state = _outer_stage_core(prob, A, b, state, cfg, oracle_fn,
                                  num_constraints, eq_gate)
        if checkpoint_path is not None:
            _ckpt.save_outer_state(checkpoint_path, jax.device_get(state),
                                   p1)
    return IPMResult(
        x=state.best_x, v=state.v if A is not None else None,
        value=state.best_obj, dual_gap=state.dual_gap, t=state.t,
        outer_iters=state.it, inner_iters=state.inner_iters,
        obj_vals=state.obj_vals, phase1=p1, bt_hist=state.bt_hist,
    )


class BarrierDriver:
    """Common API surface mirroring the reference drivers.

    After ``solve()``:
      value, xstar, optimal, optimality_gap, outer_iters, inner_iters,
      objective_vals — as in the reference (LPSolver.py:204-217,640-653);
      lam_star / v_star when ``get_dual_variables=True``
      (reference: LPSolver.py:641-646).
    """

    # Subclasses set these in __init__:
    #   self._prob            problem pytree
    #   self._eq              (A, b) equality pair or (None, None)
    #   self._oracle_fn       static oracle builder
    #   self._p1_oracle_fn    static phase-1 oracle builder or None
    #   self._eq_gate_default per-class default gate
    #   self.x (np.ndarray)   initial point
    #   self.n, self.num_constraints

    def _init_common(self, *, t0, max_outer_iters, max_inner_iters,
                     phase1_max_inner_iters, epsilon, inner_epsilon,
                     linear_solve_method, max_cg_iters, alpha, beta, mu,
                     suppress_print, try_diag, track_loss,
                     get_dual_variables, phase1_tol, phase1_t0,
                     update_slacks_every, use_psd_condition=False,
                     dtype=None, refine_steps=0, eq_gate=None,
                     staged_dispatch=False, algorithm="barrier",
                     pd_max_iters=60):
        del update_slacks_every  # unnecessary: exact slacks are free here
        if algorithm not in ("barrier", "pd", "auto"):
            raise ValueError("algorithm must be 'barrier', 'pd' or "
                             f"'auto', got {algorithm!r}")
        self.algorithm = algorithm
        self._dtype_name = dtype or default_dtype()
        ensure_x64(self._dtype_name)
        # t0="auto" scales the initial barrier parameter to the problem:
        # t0 = m / max(|f(x0)|, 1), the standard gap-matching heuristic
        # (Boyd & Vandenberghe 11.3.1).  A fixed t0 on a badly-scaled
        # objective puts the first centering problem deep in the damped
        # Newton phase (hundreds of slack-crawling steps); the reference
        # hard-codes t0 and fails outright on its own large SOCP recipe.
        self._t0_auto = (isinstance(t0, str) and t0 == "auto")
        self._t0_auto_value = None
        self.cfg = SolverConfig(
            t0=0.1 if self._t0_auto else float(t0), mu=float(mu), epsilon=float(epsilon),
            max_outer_iters=int(max_outer_iters),
            inner_epsilon=float(inner_epsilon),
            max_inner_iters=int(max_inner_iters),
            alpha=float(alpha), beta=float(beta),
            phase1_t0=float(phase1_t0),
            phase1_max_inner_iters=int(phase1_max_inner_iters),
            phase1_tol=float(phase1_tol),
            kkt_strategy=linear_solve_method,
            max_cg_iters=int(max_cg_iters),
            use_psd_condition=bool(use_psd_condition),
            try_diag=bool(try_diag),
            eq_gate=eq_gate,
            dtype=self._dtype_name,
            refine_steps=int(refine_steps),
            staged_dispatch=bool(staged_dispatch),
            pd_max_iters=int(pd_max_iters),
        )
        self.suppress_print = suppress_print
        self.track_loss = track_loss
        self.get_dual_variables = get_dual_variables

        self.optimal = False
        self.value = None
        self.optimality_gap = None
        self.xstar = None
        self.lam_star = None
        self.v_star = None
        self.vstar = None
        self.outer_iters = 0
        self.inner_iters = []
        self.objective_vals = []
        self.backtrack_hist = None
        self.feasible = None
        self.cvxpy_val = None
        self.cvxpy_sol = None

        # Reduced-space (null-space) fast path; populated by subclasses via
        # _setup_reduced (see models/reduced.py, ops/nullspace.py).
        self._reduced = None
        self._oracle_fn_z = None
        self._p1_oracle_fn_z = None

    def _setup_reduced(self, reduce_fn, oracle_fn_z, p1_oracle_fn_z):
        """Attempt the null-space elimination; silently fall back to the
        full-space engine if the factorization is unusable (rank-deficient
        A surfaces as non-finite basis entries)."""
        import numpy as _np

        try:
            rf = reduce_fn(self._prob)
        except ValueError:
            return
        if not bool(_np.isfinite(_np.asarray(rf.basis.N)).all()):
            return
        self._reduced = rf
        self._oracle_fn_z = oracle_fn_z
        self._p1_oracle_fn_z = p1_oracle_fn_z
        self._reduced_offset = float(rf.obj_offset)
        # Default initial z is computed lazily on the first solve() without
        # an x0 kwarg (see _default_z0): computing it here would run a
        # device least-squares solve + host sync even for callers that
        # always pass x0, and would freeze a stale self.x.
        self._z0_default = None
        self._z0_from = None

    def _default_z0(self):
        """Least-squares interior warm start when it lands strictly
        feasible, else the projection of self.x.  Cached per self.x value
        (recomputed if the caller mutates self.x between solves); the
        warm start + its host sync happen at most once per distinct x."""
        rf = self._reduced
        x_now = np.asarray(self.x, dtype=np.float64)
        if (self._z0_default is not None
                and self._z0_from is not None
                and np.array_equal(self._z0_from, x_now)):
            return self._z0_default
        dtype = self.cfg.jnp_dtype
        z_proj = rf.basis.N.T @ (jnp.asarray(x_now, dtype=dtype)
                                 - rf.basis.x_p)
        if getattr(rf.prob, "C", None) is not None:
            z_try, min_slack = _ls_interior_init(rf.prob)
            z0 = z_try if float(min_slack) > 1e-6 else z_proj
        else:
            z0 = z_proj
        self._z0_default = z0
        self._z0_from = x_now.copy()
        return z0

    # -- hooks -------------------------------------------------------------

    def _check_x0(self, x):
        raise NotImplementedError

    def _auto_algorithm(self) -> str:
        """Resolve ``algorithm="auto"`` to an engine for this problem
        class (subclasses override).  The routing is not yet measured on
        the H100; the barrier default stays untouched for anyone who asks
        for an explicit engine."""
        return "barrier"

    def _pd_applicable(self) -> bool:
        """Whether the Mehrotra engine can run this instance (it needs
        at least one inequality row or finite bound)."""
        prob = self._reduced.prob if self._reduced is not None \
            else self._prob
        C = getattr(prob, "C", None)
        if C is not None and np.isfinite(np.asarray(prob.d)).any():
            return True
        lb = getattr(self._prob, "lb", None)
        ub = getattr(self._prob, "ub", None)
        return ((lb is not None and np.isfinite(np.asarray(lb)).any())
                or (ub is not None and np.isfinite(np.asarray(ub)).any()))

    def _slacks_at(self, x):
        """Full slack vector for dual recovery."""
        return full_linear_slacks(self._prob, x)

    # -- solve ---------------------------------------------------------------

    @highest_precision
    def solve(self, resolve=True, **kwargs):
        """Run the interior-point solve (reference: LPSolver.py:514-653).

        Parameters: ``resolve`` returns the cached optimum when False;
        kwargs may override ``t0``, ``x0``, ``max_outer_iters``,
        ``track_loss``; ``checkpoint_path`` persists the barrier state
        after every stage (forcing host-stepped dispatch) and
        ``resume=True`` continues from that file's last completed stage
        (utils/checkpoint.py mid-solve resume).
        """
        if not resolve and self.optimal:
            return self.value
        import time as _time
        _wall0 = _time.time()

        t0 = kwargs.get("t0", None)
        if t0 is None:
            if self._t0_auto:
                if self._t0_auto_value is None:
                    # Evaluate f(x0) through jit: building the oracle
                    # EAGERLY materializes its curvature caches on
                    # device just to read one scalar; under jit
                    # everything the objective doesn't touch is dead
                    # code and never allocated.
                    obj0 = float(_obj_only(self._prob,
                                           jnp.asarray(self.x,
                                                       self.cfg.jnp_dtype),
                                           self._oracle_fn))
                    self._t0_auto_value = (
                        max(self.num_constraints, 1) / max(abs(obj0), 1.0))
                t0 = self._t0_auto_value
            else:
                t0 = self.cfg.t0
        self.track_loss = kwargs.get("track_loss", self.track_loss)
        cfg = self.cfg
        if "max_outer_iters" in kwargs:
            import dataclasses
            cfg = dataclasses.replace(
                cfg, max_outer_iters=int(kwargs["max_outer_iters"]))

        if "x0" in kwargs:
            x0 = np.asarray(kwargs["x0"], dtype=np.float64)
            self._check_x0(x0)
        else:
            x0 = self.x

        algorithm = self.algorithm
        if algorithm == "auto":
            algorithm = self._auto_algorithm()

        if algorithm == "pd":
            if kwargs.get("checkpoint_path") is not None:
                raise ValueError(
                    "algorithm='pd' does not support mid-solve "
                    "checkpointing (solves are 10-40 iterations); use "
                    "the barrier algorithm or utils.checkpoint.save_state "
                    "for terminal snapshots")
            if "max_outer_iters" in kwargs:
                # explicit per-solve cap applies to pd iterations too
                import dataclasses
                cfg = dataclasses.replace(
                    cfg, pd_max_iters=int(kwargs["max_outer_iters"]))
            return self._solve_pd(cfg, x0, "x0" in kwargs, _wall0)

        dtype = cfg.jnp_dtype
        A, b = self._eq
        eq_gate = cfg.eq_gate if cfg.eq_gate is not None else self._eq_gate_default

        checkpoint_path = kwargs.get("checkpoint_path")
        staged = cfg.staged_dispatch
        if checkpoint_path is not None:
            # checkpointing requires host boundaries between stages
            staged = True
            core = partial(_barrier_staged, checkpoint_path=checkpoint_path,
                           resume=bool(kwargs.get("resume", False)))
        else:
            core = _barrier_staged if staged else _barrier_core

        if self._reduced is not None:
            rf = self._reduced
            # Warm start precomputed at construction (see _setup_reduced);
            # a user-supplied x0 overrides it.
            if "x0" in kwargs:
                z0 = rf.basis.N.T @ (jnp.asarray(x0, dtype=dtype)
                                     - rf.basis.x_p)
            else:
                z0 = self._default_z0()
            res = core(
                rf.prob, None, None, z0, jnp.asarray(t0, dtype=dtype),
                cfg, self._oracle_fn_z, self._p1_oracle_fn_z,
                self.num_constraints, float(eq_gate),
            )
            x_best = rf.expand(res.x)
            obj_offset = self._reduced_offset
        else:
            res = core(
                self._prob, A, b,
                jnp.asarray(x0, dtype=dtype),
                jnp.asarray(t0, dtype=dtype),
                cfg, self._oracle_fn, self._p1_oracle_fn,
                self.num_constraints, float(eq_gate),
            )
            x_best = res.x
            obj_offset = 0.0
        res = res._replace(x=x_best)
        res = jax.device_get(res)  # one transfer for the whole result tree

        if res.phase1 is not None and np.isfinite(res.phase1.s):
            # phase one actually ran
            if res.phase1.s > -self.cfg.phase1_tol:
                raise ValueError(
                    "Phase 1 Solver did not successfully find a feasible "
                    f"point (final slack {float(res.phase1.s):.6g} after "
                    f"{int(res.phase1.outer_iters)} barrier stages) — the "
                    "problem may be infeasible, or needs more "
                    "max_outer_iters / a closer x0."
                )
            if not self.suppress_print:
                print(f"found a feasible point with slack {res.phase1.s}")

        self._result = res
        self.outer_iters = int(res.outer_iters)
        self.inner_iters = [int(k) for k in res.inner_iters[: self.outer_iters]]
        # accepted-candidate histogram: bin j = steps that took sigma=beta^j
        # (the reference's backtrack-distribution instrumentation)
        self.backtrack_hist = (np.asarray(res.bt_hist)
                               if res.bt_hist is not None else None)
        self.objective_vals = [
            float(o) + obj_offset for o in res.obj_vals[: self.outer_iters]
            if np.isfinite(o)
        ]
        self.xstar = res.x
        self.optimal = True
        self.value = float(res.value) + obj_offset
        self.optimality_gap = float(res.dual_gap)

        if self.get_dual_variables:
            if self.num_constraints > 0:
                slacks = np.asarray(self._slacks_at(jnp.asarray(res.x)))
                self.lam_star = 1.0 / (float(res.t) * slacks)
            if res.v is not None:
                self.v_star = res.v / float(res.t)
                self.vstar = self.v_star
            elif self._reduced is not None and self._eq[0] is not None:
                # Closed-form equality dual from stationarity at the final
                # iterate (ops/nullspace.py:recover_equality_dual).
                from ..ops.nullspace import recover_equality_dual

                g_full = self._full_gradient(jnp.asarray(res.x),
                                             jnp.asarray(float(res.t)))
                v = recover_equality_dual(self._reduced.basis, self._eq[0],
                                          g_full)
                self.v_star = np.asarray(v) / float(res.t)
                self.vstar = self.v_star

        # structured observability (utils/metrics.py): one record per
        # solve, emitted to the JSON-lines sink when metrics.enable()d
        self.last_metrics = metrics.solve_record(
            type(self).__name__,
            n=self.n, num_constraints=self.num_constraints,
            num_eq=(A.shape[0] if A is not None else 0),
            value=self.value, dual_gap=self.optimality_gap,
            outer_iters=self.outer_iters,
            newton_iters=int(sum(self.inner_iters)),
            backtrack_hist=self.backtrack_hist,
            wall_s=_time.time() - _wall0,
            phase1_ran=(res.phase1 is not None
                        and np.isfinite(res.phase1.s)),
            extra={"staged": bool(staged), "t_final": float(res.t)})
        metrics.emit(self.last_metrics)

        return self.value

    def _solve_pd(self, cfg, x0, explicit_x0, wall0):
        """Primal-dual Mehrotra predictor-corrector path (ops/pd.py).

        New capability beyond the reference (barrier-only); selected via
        ``algorithm="pd"``.  Runs on the reduced (null-space) problem when
        equalities exist, or on the bound-stacked inequality form
        otherwise.  No phase one: the method is infeasible-start.  The
        result surface (value/xstar/duals/certify/checkpoint) matches the
        barrier path; ``_result.t`` carries the equivalent barrier
        parameter m/gap so ``utils.certify`` and ``warm_solve`` work
        unchanged."""
        import time as _time
        from types import SimpleNamespace

        dtype = cfg.jnp_dtype
        A, b_eq = self._eq
        eq_pair = (None, None)

        if self._reduced is not None:
            rf = self._reduced
            pprob = rf.prob
            if getattr(pprob, "C", None) is None:
                raise ValueError(
                    "algorithm='pd' requires inequality constraints or "
                    "bounds")
            if explicit_x0:
                z0 = rf.basis.N.T @ (jnp.asarray(x0, dtype=dtype)
                                     - rf.basis.x_p)
            else:
                z0 = self._default_z0()
            expand = rf.expand
        else:
            # Full-space path: bounds stacked into C; equalities (when the
            # reduction is unavailable) handled by pd_solve's Schur block
            # elimination directly.
            from .reduced import full_space_pd_problem

            pprob = full_space_pd_problem(self._prob, dtype)
            z0 = jnp.asarray(x0, dtype=dtype)
            expand = lambda z: z  # noqa: E731
            if A is not None:
                eq_pair = (A, b_eq)

        # Drop vacuous rows (±inf bounds kept as vectors reach here as
        # d = +inf): they carry no constraint force but would poison the
        # PD slack/multiplier initialization.  Host-side filtering — d is
        # concrete at this point — with λ re-expanded to the full slack
        # order afterwards.
        d_np = np.asarray(pprob.d)
        finite_rows = np.isfinite(d_np)
        if not finite_rows.all():
            if not finite_rows.any():
                raise ValueError(
                    "algorithm='pd' requires at least one finite "
                    "inequality constraint or bound")
            idx = jnp.asarray(np.where(finite_rows)[0])
            pprob = dataclasses.replace(
                pprob, C=pprob.C[idx, :], d=pprob.d[idx])

        res = _pd_core(pprob, z0, cfg, A=eq_pair[0], b=eq_pair[1])
        x_full = expand(res.z)
        # evaluate the objective in the SAME fetch: a separate
        # float(obj(...)) afterwards is one more blocking round trip
        val_dev = _obj_only(self._prob, jnp.asarray(x_full, dtype=dtype),
                            self._oracle_fn)
        res, x_full, val = jax.device_get((res, x_full, val_dev))
        if not finite_rows.all():
            # re-expand BOTH lam and s so the stored result stays
            # internally consistent: dropped (vacuous) rows carry λ = 0
            # and infinite slack
            lam_full_order = np.zeros(d_np.shape[0])
            lam_full_order[finite_rows] = np.asarray(res.lam)
            s_full_order = np.full(d_np.shape[0], np.inf)
            s_full_order[finite_rows] = np.asarray(res.s)
            res = res._replace(lam=lam_full_order, s=s_full_order)

        self.xstar = np.asarray(x_full)
        self.value = float(val)
        self.optimal = True
        gap = float(res.gap)
        self.optimality_gap = gap
        iters = int(res.iters)
        # PD has no outer/inner split: report one "stage" per iteration
        # (each is one factorization, like a Newton step).
        self.outer_iters = iters
        self.inner_iters = [1] * iters
        self.objective_vals = []
        self.backtrack_hist = None
        if not bool(res.converged) and not self.suppress_print:
            print(f"pd: not converged after {iters} iterations "
                  f"(gap {gap:.3g}, rp {float(res.rp_norm):.3g}, "
                  f"rd {float(res.rd_norm):.3g})")

        m_ineq = max(self.num_constraints, 1)
        t_equiv = m_ineq / max(gap, 1e-300)
        self._result = SimpleNamespace(
            x=self.xstar, v=None, t=t_equiv, value=self.value,
            dual_gap=gap, phase1=None)

        if self.get_dual_variables:
            lam = np.asarray(res.lam, dtype=np.float64)
            self.lam_star = lam  # order [Cx≤d, ub, lb] = slack order
            if eq_pair[0] is not None:
                # full-space path: pd carries the equality dual directly
                self.v_star = np.asarray(res.v, dtype=np.float64)
                self.vstar = self.v_star
            elif A is not None:
                # stationarity-consistent equality dual:
                # ∇f + Cᵀλ_C + λ_ub − λ_lb + Aᵀv = 0
                from ..ops.nullspace import recover_equality_dual

                prob = self._prob
                if getattr(prob, "P", None) is not None:
                    g = np.asarray(prob.P) @ self.xstar
                    if prob.q is not None:
                        g = g + np.asarray(prob.q)
                else:
                    g = np.asarray(prob.c, dtype=np.float64).copy()
                ofs = 0
                if prob.C is not None:
                    kC = prob.C.shape[0]
                    g = g + np.asarray(prob.C).T @ lam[:kC]
                    ofs = kC
                if prob.ub is not None:
                    g = g + lam[ofs:ofs + self.n]
                    ofs += self.n
                if prob.lb is not None:
                    g = g - lam[ofs:ofs + self.n]
                v = recover_equality_dual(self._reduced.basis, A,
                                          jnp.asarray(g, dtype=dtype))
                self.v_star = np.asarray(v)
                self.vstar = self.v_star

        self.last_metrics = metrics.solve_record(
            type(self).__name__,
            n=self.n, num_constraints=self.num_constraints,
            num_eq=(A.shape[0] if A is not None else 0),
            value=self.value, dual_gap=gap,
            outer_iters=iters, newton_iters=iters,
            backtrack_hist=None, wall_s=_time.time() - wall0,
            phase1_ran=False,
            extra={"algorithm": "pd", "converged": bool(res.converged),
                   "rp_norm": float(res.rp_norm),
                   "rd_norm": float(res.rd_norm)})
        metrics.emit(self.last_metrics)
        return self.value

    def _full_gradient(self, x, t):
        """Full-space barrier gradient at (x, t) for dual recovery."""
        return self._oracle_fn(self._prob).grad(x, t)

    def plot(self, subtract_cvxpy=True):
        """Optimality gap vs cumulative Newton iterations
        (reference: LPSolver.py:684-705)."""
        if not (self.optimal and self.track_loss):
            raise ValueError(
                "Need to solve problem with track_loss set to True to be "
                "able to plot convergence!"
            )
        import matplotlib.pyplot as plt

        obj_vals = np.asarray(self.objective_vals, dtype=np.float64)
        baseline = self.cvxpy_val if (subtract_cvxpy and self.cvxpy_val
                                      is not None) else 0.0
        ax = plt.subplot()
        ax.step(
            np.cumsum(self.inner_iters[-len(obj_vals):]),
            obj_vals - baseline,
            where="post",
        )
        ax.set_xlabel("Cumulative Newton iterations")
        ax.set_ylabel("Optimality gap")
        ax.set_title(f"Convergence of {type(self).__name__}")
        ax.set_yscale("log")
        return ax

    def __str__(self):
        opt_val = "Not yet solved" if self.optimal is False else self.value
        return f"{type(self).__name__}(Optimal Value: {opt_val})"

    def __repr__(self):
        return str(self)
