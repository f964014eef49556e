"""SOCP driver: min ½xᵀPx + qᵀx s.t. ‖Aᵢx+bᵢ‖ ≤ cᵢᵀx+dᵢ, Fx = g, bounds.

API-parity port target: reference SOCPSolver.py.  Cone lists are packed
into stacked padded tensors (models/problem.py:make_socp); the equality
pair (F, g) rides the engine's (A, b) slots exactly as the reference does
(reference: SOCPSolver.py:535-553).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..utils import metrics
from ..ops.socp import make_phase1_socp_oracle, make_socp_oracle, \
    socp_full_slacks
from ..utils import oracle as oracle_check
from .base import BarrierDriver, default_dtype, synthesize_x0
from .problem import make_socp
from ..utils.precision import highest_precision


def _socp_oracle(prob):
    return make_socp_oracle(prob)


def _normalize_socp_inputs(P, q, A, b, c, d, F, g, lb, ub):
    """List normalization and broadcasting
    (reference: SOCPSolver.py:255-427).  Unlike the reference — which
    mutates the caller's A during diagonal detection
    (SOCPSolver.py:285-292, catalogued in SURVEY.md §7) — inputs are never
    modified; 1-D cone matrices are interpreted as diagonals."""
    if P is not None:
        P = np.asarray(P)
        if P.ndim != 2 or P.shape[0] != P.shape[1]:
            raise ValueError("P must be a symmetric, square PSD matrix!")
    if q is not None:
        q = np.asarray(q)
        if q.ndim != 1:
            raise ValueError("q must be 1-dimensional!")
        if P is not None and P.shape[1] != len(q):
            raise ValueError("P and q must have the same dimension")
    if A is None:
        raise ValueError(
            "No cone contraints detected. Run with LPSolver or QPSolver for "
            "better performance.")
    if not isinstance(A, (list, tuple)):
        A = [A]
    A = [np.asarray(Ai) for Ai in A]
    for Ai in A:
        if Ai.ndim > 2:
            raise ValueError("A must be 1- or 2-dimensional!")
    n = A[0].shape[-1]
    if b is not None:
        if not isinstance(b, (list, tuple)):
            b = [b]
        b = [np.asarray(bi) for bi in b]
        if len(b) == 1:
            b = b * len(A)
        if len(A) != len(b):
            raise ValueError("Must provide an equal number of A and b")
    if c is not None:
        if not isinstance(c, (list, tuple)):
            c = [c]
        c = [np.asarray(ci) for ci in c]
        if len(A) != len(c):
            raise ValueError("Must provide equal number of c and A")
    if d is not None:
        if not isinstance(d, (list, tuple)):
            d = [d]
        d = [float(di) for di in d]
        if len(d) == 1:
            d = d * len(A)
        if len(d) != len(A):
            raise ValueError("Must provide equal number of A and d")
    if F is not None:
        F = np.asarray(F)
        if F.ndim != 2:
            raise ValueError("F must be 2-dimensional!")
        if F.shape[1] != n:
            raise ValueError("A and F must have the same number of columns!")
    if g is not None:
        g = np.asarray(g)
        if g.ndim != 1:
            raise ValueError("g must be 1-dimensional!")
        if F is not None and len(g) != F.shape[0]:
            raise ValueError("F and g must have agreeing dimensions!")
    if lb is not None and ub is not None:
        if np.any(np.asarray(ub) - np.asarray(lb) < 0):
            raise ValueError("Lower bound must be lower than upper bound")
    return P, q, A, b, c, d, F, g, n


@partial(jax.jit, static_argnames=("cfg",))
@highest_precision
def _socp_pd_core(G, h, q, x0, cfg, P=None, F=None, g=None, lb=None,
                  ub=None):
    """Single jitted entry for the conic Mehrotra solve (ops/socp_pd.py).

    Also returns the objective value so the driver fetches EVERYTHING
    in one device_get instead of paying one more round trip."""
    from ..ops.socp_pd import socp_pd_solve
    res = socp_pd_solve(G, h, q, x0, cfg, P=P, F=F, g=g, lb=lb, ub=ub)
    val = q @ res.x
    if P is not None:
        val = val + 0.5 * res.x @ (P @ res.x)
    return res, val


class SOCPSolver(BarrierDriver):
    """Drop-in analogue of the reference SOCPSolver
    (reference: SOCPSolver.py:18)."""

    def __init__(self, P=None, q=None, A=None, b=None, c=None, d=None,
                 F=None, g=None, lower_bound=0, upper_bound=None, t0=0.1,
                 phase1_t0=0.01, max_outer_iters=20, max_inner_iters=50,
                 phase1_max_inner_iters=500, epsilon=1e-10,
                 inner_epsilon=1e-5, check_cvxpy=True,
                 linear_solve_method="cholesky", max_cg_iters=50,
                 alpha=0.2, beta=0.6, mu=15, suppress_print=False,
                 use_gpu=False, try_diag=True, track_loss=False,
                 get_dual_variables=False, phase1_tol=0,
                 use_psd_condition=False, x0=None, update_slacks_every=0,
                 dtype=None, refine_steps=0, eq_gate=None, reduced=None,
                 staged_dispatch=False, algorithm="barrier",
                 pd_max_iters=60):
        del use_gpu
        P, q, A, b, c, d, F, g, self.n = _normalize_socp_inputs(
            P, q, A, b, c, d, F, g, lower_bound, upper_bound)
        self.equality_constrained = F is not None
        self.inequality_constrained = True

        self._init_common(
            t0=t0, max_outer_iters=max_outer_iters,
            max_inner_iters=max_inner_iters,
            phase1_max_inner_iters=phase1_max_inner_iters,
            epsilon=epsilon, inner_epsilon=inner_epsilon,
            linear_solve_method=linear_solve_method,
            max_cg_iters=max_cg_iters, alpha=alpha, beta=beta, mu=mu,
            suppress_print=suppress_print, try_diag=try_diag,
            track_loss=track_loss, get_dual_variables=get_dual_variables,
            phase1_tol=phase1_tol, phase1_t0=phase1_t0,
            update_slacks_every=update_slacks_every,
            use_psd_condition=use_psd_condition, dtype=dtype,
            refine_steps=refine_steps, eq_gate=eq_gate,
            staged_dispatch=staged_dispatch, algorithm=algorithm,
            pd_max_iters=pd_max_iters,
        )

        lb, ub = lower_bound, upper_bound
        lb_vec = None if lb is None else np.broadcast_to(
            np.asarray(lb, dtype=np.float64), (self.n,))
        ub_vec = None if ub is None else np.broadcast_to(
            np.asarray(ub, dtype=np.float64), (self.n,))
        self.x = (np.asarray(x0, dtype=np.float64) if x0 is not None
                  else synthesize_x0(lb_vec, ub_vec, self.n))

        if check_cvxpy:
            if not suppress_print:
                print("Testing CVXPY")
            self.feasible, self.cvxpy_val, self.cvxpy_sol = (
                oracle_check.check_socp(
                    A, b if b is not None else [np.zeros(Ai.shape[0] if
                    Ai.ndim == 2 else Ai.shape[0]) for Ai in A],
                    c if c is not None else [np.zeros(self.n)] * len(A),
                    d if d is not None else [0.0] * len(A),
                    P, q, F, g, lb_vec, ub_vec))
            if self.feasible == "infeasible":
                raise ValueError("Provided problem instance is infeasible!")
            if self.feasible == "unbounded":
                raise ValueError("Provided problem instance is unbounded!")

        dt = self.cfg.jnp_dtype
        self._prob = make_socp(A, b, c, d, P, q, F, g, lb, ub, dtype=dt)
        self._eq = (self._prob.F, self._prob.g)
        self._oracle_fn = _socp_oracle
        self._p1_oracle_fn = make_phase1_socp_oracle
        # Equality gate 1e-3 on ‖Fx−g‖ (reference: SOCPSolver.py:700-704).
        self._eq_gate_default = 1e-3
        self.num_constraints = self._prob.num_ineq_constraints
        self.bounded = lb is not None or ub is not None

        # Reduced SOCP requires unbounded variables (models/reduced.py).
        want_reduced = reduced if reduced is not None else (
            self._prob.F is not None
            and self._prob.F.shape[0] < self.n
            and not self.bounded)
        if want_reduced and self._prob.F is not None:
            from .reduced import reduce_socp
            self._setup_reduced(reduce_socp, _socp_oracle,
                                make_phase1_socp_oracle)

    def _slacks_at(self, x):
        return socp_full_slacks(self._prob, x)

    def _solve_pd(self, cfg, x0, explicit_x0, wall0):
        """Conic primal-dual Mehrotra path (ops/socp_pd.py): NT-scaled
        predictor-corrector on the natural cone form — 10–30 iterations
        vs the squared-cone barrier's 100+ Newton steps, no phase one.
        Result surface matches the barrier path; conic duals z are
        mapped to the squared-slack multipliers the reference reports
        (λ_k = z_k0 / (2·rhs_k), equivalent stationarity — the appended
        rhs-domain slack entries carry λ = 0).

        When the null-space reduction is available (equalities, no
        bounds — the same gate as the barrier path), the engine runs in
        z-space with NO equality block: eliminating F once per solve
        makes each Mehrotra direction ONE posdef solve, the same
        architecture the barrier engine already uses; the equality dual
        y is recovered in closed form from stationarity afterwards."""
        import time as _time
        from types import SimpleNamespace

        prob = self._prob
        dtype = cfg.jnp_dtype
        rf = self._reduced
        if rf is not None:
            pprob = rf.prob
            G = jnp.concatenate([pprob.c[:, None, :], pprob.A], axis=1)
            h = jnp.concatenate([pprob.d[:, None], pprob.b], axis=1)
            qv = (pprob.q if pprob.q is not None
                  else jnp.zeros((G.shape[-1],), dtype))
            z0 = rf.basis.N.T @ (jnp.asarray(x0, dtype) - rf.basis.x_p)
            res, val = _socp_pd_core(G, h, qv, z0, cfg, P=pprob.P)
            res = res._replace(x=rf.expand(res.x))
            val = val + rf.obj_offset
        else:
            G = jnp.concatenate([prob.c[:, None, :], prob.A], axis=1)
            h = jnp.concatenate([prob.d[:, None], prob.b], axis=1)
            qv = (prob.q if prob.q is not None
                  else jnp.zeros((self.n,), dtype))
            res, val = _socp_pd_core(G, h, qv, jnp.asarray(x0, dtype),
                                     cfg, P=prob.P, F=prob.F, g=prob.g,
                                     lb=prob.lb, ub=prob.ub)
        res, val = jax.device_get((res, val))

        self.xstar = np.asarray(res.x)
        self.value = float(val)
        self.optimal = True
        gap = float(res.gap)
        self.optimality_gap = gap
        iters = int(res.iters)
        self.outer_iters = iters
        self.inner_iters = [1] * iters
        self.objective_vals = []
        self.backtrack_hist = None
        if not bool(res.converged) and not self.suppress_print:
            print(f"pd: not converged after {iters} iterations "
                  f"(gap {gap:.3g}, rp {float(res.rp_norm):.3g}, "
                  f"rd {float(res.rd_norm):.3g})")

        m_ineq = max(self.num_constraints, 1)
        self._result = SimpleNamespace(
            x=self.xstar, v=None, t=m_ineq / max(gap, 1e-300),
            value=self.value, dual_gap=gap, phase1=None)

        if self.get_dual_variables:
            rhs = (np.asarray(prob.c) @ self.xstar
                   + np.asarray(prob.d))
            # a cone degenerate at the origin (rhs → 0 at the optimum)
            # has no finite squared-form multiplier; report λ = 0 there
            # rather than an astronomically clamped ratio (the conic dual
            # z itself remains available via certify's refit)
            scale = 1.0 + float(np.abs(np.asarray(prob.d)).max())
            lam_cone = np.where(
                rhs > 1e-12 * scale,
                np.asarray(res.z)[:, 0] / (2.0 * np.maximum(rhs, 1e-300)),
                0.0)
            parts = [lam_cone]
            if prob.ub is not None:
                parts.append(np.asarray(res.lam_ub))
            if prob.lb is not None:
                parts.append(np.asarray(res.lam_lb))
            parts.append(np.zeros(lam_cone.shape[0]))  # rhs-domain block
            self.lam_star = np.concatenate(parts)
            if prob.F is not None:
                if rf is not None:
                    # z-space engine carries no equality multiplier;
                    # recover y from stationarity at the final iterate:
                    # q + Px − Σ G_kᵀ z_k + Fᵀy = 0
                    from ..ops.nullspace import recover_equality_dual

                    Gf = jnp.concatenate([prob.c[:, None, :], prob.A],
                                         axis=1)
                    gf = -jnp.einsum("kmn,km->n", Gf,
                                     jnp.asarray(res.z))
                    if prob.q is not None:
                        gf = gf + prob.q
                    if prob.P is not None:
                        gf = gf + prob.P @ jnp.asarray(self.xstar,
                                                       dtype)
                    self.v_star = np.asarray(recover_equality_dual(
                        rf.basis, prob.F, gf))
                else:
                    self.v_star = np.asarray(res.y)
                self.vstar = self.v_star

        self.last_metrics = metrics.solve_record(
            type(self).__name__,
            n=self.n, num_constraints=self.num_constraints,
            num_eq=(prob.F.shape[0] if prob.F is not None else 0),
            value=self.value, dual_gap=gap,
            outer_iters=iters, newton_iters=iters,
            backtrack_hist=None, wall_s=_time.time() - wall0,
            phase1_ran=False,
            extra={"algorithm": "pd", "converged": bool(res.converged),
                   "rp_norm": float(res.rp_norm),
                   "rd_norm": float(res.rd_norm)})
        metrics.emit(self.last_metrics)
        return self.value

    def _auto_algorithm(self) -> str:
        """SOCP routes to the barrier engine.  Not yet measured on the
        H100; ``algorithm="pd"`` stays available explicitly (the
        production-conic-solver algorithm family, ~8 iterations vs 100+
        Newton steps)."""
        return "barrier"

    def _check_x0(self, x):
        """Cone-membership validation (reference: SOCPSolver.py:755-810)."""
        prob = self._prob
        if prob.lb is not None and np.any(x <= np.asarray(prob.lb)):
            raise ValueError(
                "Initial x must be in domain of problem (all entries greater "
                "than lower bound)")
        if prob.ub is not None and np.any(x >= np.asarray(prob.ub)):
            raise ValueError(
                "Initial x must be in domain of problem (all entries less "
                "than upper bound)")
        if len(x) != self.n:
            raise ValueError("Initial x must have the correct dimension!")


@highest_precision
def solve_socp(A, b=None, c=None, d=None, P=None, q=None, F=None, g=None,
               lb=None, ub=None, cfg=None, x0=None, algorithm="barrier",
               **cfg_overrides):
    """Functional one-shot SOCP solve returning the raw IPMResult pytree
    (or a SOCPPDResult with ``algorithm="pd"`` — the NT-scaled conic
    Mehrotra engine, ops/socp_pd.py)."""
    from ..utils.config import SolverConfig
    from .base import _barrier_core

    if cfg is None:
        cfg = SolverConfig(**{"dtype": default_dtype(), **cfg_overrides})
    from .base import ensure_x64
    ensure_x64(cfg.dtype)
    dt = cfg.jnp_dtype
    prob = make_socp(A, b, c, d, P, q, F, g, lb, ub, dtype=dt)
    n = prob.n
    lb_vec = None if prob.lb is None else np.asarray(prob.lb)
    ub_vec = None if prob.ub is None else np.asarray(prob.ub)
    if x0 is None:
        x0 = synthesize_x0(lb_vec, ub_vec, n)
    if algorithm == "auto":
        # same routing as SOCPSolver._auto_algorithm
        algorithm = "barrier"
    if algorithm == "pd":
        from ..ops.socp_pd import cone_operator, socp_pd_solve

        G, h, qv = cone_operator(prob)
        return socp_pd_solve(G, h, qv, jnp.asarray(x0, dtype=dt), cfg,
                             P=prob.P, F=prob.F, g=prob.g,
                             lb=prob.lb, ub=prob.ub)
    if algorithm != "barrier":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    eq_gate = cfg.eq_gate if cfg.eq_gate is not None else 1e-3
    return _barrier_core(
        prob, prob.F, prob.g, jnp.asarray(x0, dtype=dt),
        jnp.asarray(cfg.t0, dtype=dt), cfg, _socp_oracle,
        make_phase1_socp_oracle, prob.num_ineq_constraints, float(eq_gate),
    )
