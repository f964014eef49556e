"""LP driver: min cᵀx s.t. Ax = b, Cx ≤ d, lb ≤ x ≤ ub.

API-parity port target: reference LPSolver.py.  The solve path is the
jitted barrier core (ops/ipm.py); this module provides intake
validation matching the reference's error behaviour
(reference: LPSolver.py:226-318) and the functional ``solve_lp`` entry.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops.barrier import make_phase1_linear_oracle, make_qp_oracle
from ..utils import oracle as oracle_check
from .base import BarrierDriver, default_dtype, synthesize_x0
from .problem import LPProblem, make_lp
from ..utils.precision import highest_precision


def _oracle_try_diag(prob):
    return make_qp_oracle(prob, try_diag=True)


def _oracle_no_diag(prob):
    return make_qp_oracle(prob, try_diag=False)


def _validate_lp(c, A, b, C, d, lb, ub):
    """Dimension/type checks (reference: LPSolver.py:226-318)."""
    c_flag = c is not None
    n_A = n_C = None
    if c_flag and np.asarray(c).ndim != 1:
        raise ValueError("c must be 1-dimensional!")
    if (A is not None) ^ (b is not None):
        raise ValueError("Both A and b must be defined, or neither!")
    if A is not None:
        A = np.asarray(A)
        if A.ndim != 2:
            raise ValueError("A must be 2-dimensional!")
        m, n_A = A.shape
        if np.asarray(b).ndim != 1:
            raise ValueError("b must be 1-dimensional!")
        if len(b) != m:
            raise ValueError("A and b must have agreeing dimensions!")
        if c_flag and len(c) != n_A:
            raise ValueError(
                "c must have the same number of entries as A has columns!")
    if (C is not None) ^ (d is not None):
        raise ValueError("Both C and d must be defined, or neither!")
    if C is not None:
        C = np.asarray(C)
        if C.ndim != 2:
            raise ValueError("C must be 2-dimensional!")
        k, n_C = C.shape
        if np.asarray(d).ndim != 1:
            raise ValueError("d must be 1-dimensional!")
        if len(d) != k:
            raise ValueError("C and d must have agreeing dimensions!")
        if c_flag and len(c) != n_C:
            raise ValueError(
                "c must have the same number of entries as A has columns!")
    n = (len(c) if c_flag else n_A if n_A is not None else n_C)
    for name, bound in (("Lower", lb), ("Upper", ub)):
        if bound is not None and np.asarray(bound).ndim > 0:
            if len(np.asarray(bound)) != n:
                raise ValueError(
                    f"{name} bound must be a scalar or have the same number "
                    "of dimensions as other parameters!")
    if lb is not None and ub is not None:
        if np.any(np.asarray(ub) - np.asarray(lb) < 0):
            raise ValueError("Lower bound must be lower than upper bound")
    if n_C is not None and n_A is not None and n_C != n_A:
        raise ValueError("A and C must have the same number of columns!")
    return n


class LPSolver(BarrierDriver):
    """Drop-in analogue of the reference LPSolver (reference: LPSolver.py:18).

    ``use_gpu`` is accepted for API compatibility and ignored: arrays live
    on the default JAX device.  ``update_slacks_every``
    is accepted and ignored (see ops/barrier.py module docstring).
    """

    def __init__(self, c=None, A=None, b=None, C=None, d=None,
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
        self.n = _validate_lp(c, A, b, C, d, lower_bound, upper_bound)
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

        lb = lower_bound
        ub = upper_bound
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
                oracle_check.check_lp(c, A, b, C, d, lb_vec, ub_vec))
            if self.feasible == "infeasible":
                raise ValueError("Provided problem instance is infeasible!")
            if self.feasible == "unbounded":
                raise ValueError("Provided problem instance is unbounded!")

        dt = self.cfg.jnp_dtype
        self._prob = make_lp(c, A, b, C, d, lb, ub, dtype=dt)
        self._eq = (self._prob.A, self._prob.b)
        self._oracle_fn = _oracle_try_diag if try_diag else _oracle_no_diag
        # Phase-one exists only when there is a dense inequality block
        # (reference: LPSolver.py:221-222).
        self._p1_oracle_fn = (make_phase1_linear_oracle
                              if self._prob.C is not None else None)
        # Equality gate 1e-4·n (reference: LPSolver.py:600).
        self._eq_gate_default = 1e-4 * self.n
        self.num_constraints = self._prob.num_ineq_constraints
        self.bounded = lb is not None or ub is not None

        # Null-space fast path (ops/nullspace.py): auto-enabled for
        # equality-constrained problems with m < n and at least one
        # inequality/bound; pass reduced=False for the reference-parity
        # infeasible-start engine.
        want_reduced = reduced if reduced is not None else (
            self._prob.A is not None
            and self._prob.A.shape[0] < self.n
            and self.num_constraints > 0
            # full_kkt is an explicitly-requested full-space debug path
            and self.cfg.kkt_strategy != "full_kkt")
        if want_reduced and self._prob.A is not None:
            from ..ops.barrier import make_phase1_linear_oracle as _p1
            from .reduced import reduce_lp
            self._setup_reduced(reduce_lp, _oracle_no_diag, _p1)

    def _auto_algorithm(self) -> str:
        """LP routes to the Mehrotra engine wherever it applies.  Not yet
        measured on the H100."""
        return "pd" if self._pd_applicable() else "barrier"

    def _check_x0(self, x):
        """(reference: LPSolver.py:655-682)"""
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
            raise ValueError("Initial x must be the same dimension as c!")


@highest_precision
def solve_lp(c, A=None, b=None, C=None, d=None, lb=None, ub=None,
             cfg=None, x0=None, algorithm="barrier", **cfg_overrides):
    """Functional one-shot LP solve returning the raw IPMResult pytree
    (or a PDResult with ``algorithm="pd"`` — the Mehrotra engine on the
    full-space inequality form, ops/pd.py).

    Prefer this for batched/jitted composition; ``LPSolver`` for the
    reference-compatible object API.
    """
    from ..utils.config import SolverConfig
    from .base import _barrier_core

    if cfg is None:
        cfg = SolverConfig(**{"dtype": default_dtype(), **cfg_overrides})
    from .base import ensure_x64
    ensure_x64(cfg.dtype)
    dt = cfg.jnp_dtype
    prob = make_lp(c, A, b, C, d, lb, ub, dtype=dt)
    n = prob.n
    lb_vec = None if prob.lb is None else np.asarray(prob.lb)
    ub_vec = None if prob.ub is None else np.asarray(prob.ub)
    if x0 is None:
        x0 = synthesize_x0(lb_vec, ub_vec, n)
    if algorithm == "auto":
        # same routing as LPSolver._auto_algorithm
        algorithm = "pd"
    if algorithm == "pd":
        from ..ops.pd import pd_solve
        from .reduced import full_space_pd_problem

        return pd_solve(full_space_pd_problem(prob, dt),
                        jnp.asarray(x0, dtype=dt), cfg,
                        A=prob.A, b=prob.b)
    if algorithm != "barrier":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    oracle_fn = _oracle_try_diag if cfg.try_diag else _oracle_no_diag
    p1_fn = make_phase1_linear_oracle if prob.C is not None else None
    eq_gate = cfg.eq_gate if cfg.eq_gate is not None else 1e-4 * n
    return _barrier_core(
        prob, prob.A, prob.b, jnp.asarray(x0, dtype=dt),
        jnp.asarray(cfg.t0, dtype=dt), cfg, oracle_fn, p1_fn,
        prob.num_ineq_constraints, float(eq_gate),
    )
