"""QP driver: min ½xᵀPx + qᵀx s.t. Ax = b, Cx ≤ d, lb ≤ x ≤ ub.

API-parity port target: reference QPSolver.py.  Shares the barrier core
with the LP driver; the only differences are the quadratic objective oracle
and the looser equality gate 1e-3 (reference: QPSolver.py:585-587).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops.barrier import make_phase1_linear_oracle, make_qp_oracle
from ..utils import oracle as oracle_check
from .base import BarrierDriver, default_dtype, synthesize_x0
from .lp import _validate_lp
from .problem import make_qp
from ..utils.precision import highest_precision


def _qp_oracle(prob):
    return make_qp_oracle(prob)


class QPSolver(BarrierDriver):
    """Drop-in analogue of the reference QPSolver (reference: QPSolver.py:18)."""

    def __init__(self, P=None, q=None, A=None, b=None, C=None, d=None,
                 lower_bound=0, upper_bound=None, t0=0.1,
                 max_outer_iters=20, max_inner_iters=50,
                 phase1_max_inner_iters=500, epsilon=1e-10,
                 inner_epsilon=1e-5, check_cvxpy=True,
                 linear_solve_method="cholesky", max_cg_iters=50,
                 alpha=0.2, beta=0.6, mu=15, suppress_print=False,
                 use_gpu=False, try_diag=True, track_loss=False,
                 get_dual_variables=False, phase1_tol=0, phase1_t0=0.01,
                 x0=None, update_slacks_every=0, dtype=None,
                 refine_steps=0, eq_gate=None, reduced=None,
                 staged_dispatch=False, algorithm="barrier",
                 pd_max_iters=60):
        del use_gpu
        if P is None:
            # (reference: QPSolver.py:104-107 rejects missing P)
            raise ValueError(
                "Must provide a quadratic objective term P! If you want to "
                "solve a linear program, use LPSolver instead.")
        P = np.asarray(P)
        if P.ndim != 2 or P.shape[0] != P.shape[1]:
            raise ValueError("P must be a square 2-dimensional matrix!")
        self.n = P.shape[1]
        if q is not None and len(np.asarray(q)) != self.n:
            raise ValueError("P and q must have agreeing dimensions!")
        _validate_lp(q if q is not None else np.zeros(self.n),
                     A, b, C, d, lower_bound, upper_bound)
        self.equality_constrained = A is not None

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
            update_slacks_every=update_slacks_every, dtype=dtype,
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
                oracle_check.check_qp(P, q, A, b, C, d, lb_vec, ub_vec))
            if self.feasible == "infeasible":
                raise ValueError("Provided problem instance is infeasible!")
            if self.feasible == "unbounded":
                raise ValueError("Provided problem instance is unbounded!")

        dt = self.cfg.jnp_dtype
        self._prob = make_qp(P, q, A, b, C, d, lb, ub, dtype=dt)
        self._eq = (self._prob.A, self._prob.b)
        self._oracle_fn = _qp_oracle
        self._p1_oracle_fn = (make_phase1_linear_oracle
                              if self._prob.C is not None else None)
        # Equality gate 1e-3, absolute (reference: QPSolver.py:585-587).
        self._eq_gate_default = 1e-3
        self.num_constraints = self._prob.num_ineq_constraints
        self.bounded = lb is not None or ub is not None

        want_reduced = reduced if reduced is not None else (
            self._prob.A is not None
            and self._prob.A.shape[0] < self.n
            and self.num_constraints > 0
            # full_kkt is an explicitly-requested full-space debug path
            and self.cfg.kkt_strategy != "full_kkt")
        if want_reduced and self._prob.A is not None:
            from ..ops.barrier import make_phase1_linear_oracle as _p1
            from .reduced import reduce_qp
            self._setup_reduced(reduce_qp, _qp_oracle, _p1)

    def _auto_algorithm(self) -> str:
        """QP routes to the Mehrotra engine wherever it applies.  Not yet
        measured on the H100."""
        return "pd" if self._pd_applicable() else "barrier"

    def _check_x0(self, x):
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
            raise ValueError("Initial x must be the same dimension as P!")


@highest_precision
def solve_qp(P, q=None, A=None, b=None, C=None, d=None, lb=None, ub=None,
             cfg=None, x0=None, algorithm="barrier", **cfg_overrides):
    """Functional one-shot QP solve returning the raw IPMResult pytree
    (or a PDResult with ``algorithm="pd"``)."""
    from ..utils.config import SolverConfig
    from .base import _barrier_core

    if cfg is None:
        cfg = SolverConfig(**{"dtype": default_dtype(), **cfg_overrides})
    from .base import ensure_x64
    ensure_x64(cfg.dtype)
    dt = cfg.jnp_dtype
    prob = make_qp(P, q, A, b, C, d, lb, ub, dtype=dt)
    n = prob.n
    lb_vec = None if prob.lb is None else np.asarray(prob.lb)
    ub_vec = None if prob.ub is None else np.asarray(prob.ub)
    if x0 is None:
        x0 = synthesize_x0(lb_vec, ub_vec, n)
    if algorithm == "auto":
        # same routing as QPSolver._auto_algorithm
        algorithm = "pd"
    if algorithm == "pd":
        from ..ops.pd import pd_solve
        from .reduced import full_space_pd_problem

        return pd_solve(full_space_pd_problem(prob, dt),
                        jnp.asarray(x0, dtype=dt), cfg,
                        A=prob.A, b=prob.b)
    if algorithm != "barrier":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    p1_fn = make_phase1_linear_oracle if prob.C is not None else None
    eq_gate = cfg.eq_gate if cfg.eq_gate is not None else 1e-3
    return _barrier_core(
        prob, prob.A, prob.b, jnp.asarray(x0, dtype=dt),
        jnp.asarray(cfg.t0, dtype=dt), cfg, _qp_oracle, p1_fn,
        prob.num_ineq_constraints, float(eq_gate),
    )
