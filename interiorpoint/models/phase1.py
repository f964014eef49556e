"""Standalone phase-one (feasibility) solvers.

Two API surfaces, mirroring the reference's pair:

* ``PhaseOneSolver`` — the current driver used by LP/QP/SOCP
  (reference: PhaseOneSolver.py): min s  s.t. slackᵢ(x) + s ≥ 0 over the
  augmented variable [x, s], early-exiting once s < −tol.
* ``PhaseOne`` — the legacy standalone class for polyhedra Gx ≤ h
  (reference: PhaseOne.py, utils_phase_one.py): returns (x, s, warn) with
  s < 0 ⇔ strictly feasible, s > 0 ⇔ likely empty.

Both run the same jitted feasible-start Newton + barrier core
(ops/ipm.py:phase1_solve).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.barrier import make_phase1_linear_oracle
from ..ops.ipm import phase1_solve
from ..ops.socp import make_phase1_socp_oracle
from ..utils.config import SolverConfig
from .base import default_dtype, ensure_x64
from .problem import LPProblem, make_lp, make_socp
from ..utils.precision import highest_precision


@partial(jax.jit, static_argnames=("cfg", "oracle_fn"))
@highest_precision
def _phase1_core(prob, x0, cfg, oracle_fn):
    return phase1_solve(oracle_fn(prob), x0, cfg)


class PhaseOneSolver:
    """Drop-in analogue of the reference PhaseOneSolver
    (reference: PhaseOneSolver.py:6-154).

    For LP/QP feasibility pass (C, d, bounds); for SOCP pass socp=True and
    socp_params=(A, b, c, d) (reference: PhaseOneSolver.py:62-84).
    """

    def __init__(self, C=None, d=None, lower_bound=0, upper_bound=None,
                 x0=None, max_outer_iters=50, max_inner_iters=20,
                 epsilon=1e-8, inner_epsilon=1e-5,
                 linear_solve_method="cholesky", max_cg_iters=50, alpha=0.2,
                 beta=0.6, mu=15, t0=1, suppress_print=False, use_gpu=False,
                 track_loss=False, n=None, tol=0.1, socp=False,
                 socp_params=None, use_psd_condition=False,
                 update_slacks_every=0, dtype=None):
        del use_gpu, update_slacks_every, track_loss
        dtype = dtype or default_dtype()
        ensure_x64(dtype)
        self.cfg = SolverConfig(
            t0=float(t0), mu=float(mu), epsilon=float(epsilon),
            max_outer_iters=int(max_outer_iters),
            inner_epsilon=float(inner_epsilon),
            max_inner_iters=int(max_inner_iters),
            phase1_max_inner_iters=int(max_inner_iters),
            phase1_t0=float(t0), phase1_tol=float(tol),
            alpha=float(alpha), beta=float(beta),
            kkt_strategy=linear_solve_method,
            max_cg_iters=int(max_cg_iters),
            use_psd_condition=bool(use_psd_condition),
            dtype=dtype,
        )
        dt = self.cfg.jnp_dtype
        self.tol = tol
        self.suppress_print = suppress_print

        if not socp:
            if C is None or d is None:
                raise ValueError("Phase one requires C and d")
            n = C.shape[1]
            self._prob = make_lp(np.zeros(n), C=C, d=d, lb=lower_bound,
                                 ub=upper_bound, dtype=dt)
            self._oracle_fn = make_phase1_linear_oracle
        else:
            A, b, c, d_socp = socp_params
            self._prob = make_socp(A, b, c, d_socp, lb=lower_bound,
                                   ub=upper_bound, dtype=dt)
            self._oracle_fn = make_phase1_socp_oracle
            n = self._prob.n
        self.n = n
        self.x = (np.asarray(x0, dtype=np.float64) if x0 is not None
                  else np.zeros(n))
        self.outer_iters = 0
        self.inner_iters = []

        # expose the starting slack like the reference's phase1_fm.s
        # (reference: FunctionManager.py:390-393; gates phase-one skipping
        # at LPSolver.py:546)
        oracle = self._oracle_fn(self._prob)
        z0 = jnp.concatenate([jnp.asarray(self.x, dtype=dt),
                              jnp.zeros((1,), dt)])
        self.s = float(-oracle.min_slack(z0) + 1.0)

    def solve(self, x0=None):
        """Returns (x_feasible, s) with s < −tol on success
        (reference: PhaseOneSolver.py:112-154)."""
        x = np.asarray(x0, dtype=np.float64) if x0 is not None else self.x
        res = _phase1_core(
            self._prob, jnp.asarray(x, dtype=self.cfg.jnp_dtype),
            self.cfg, self._oracle_fn)
        self.outer_iters = int(res.outer_iters)
        self.inner_iters = [int(res.newton_iters)]
        self.s = float(res.s)
        if not self.suppress_print:
            print(f"Current slack: {self.s}")
        return np.asarray(res.x), self.s


class PhaseOne:
    """Legacy standalone phase-one for Gx ≤ h
    (reference: PhaseOne.py:18-395; NumPy twin utils_phase_one.py).

    minimize s  s.t.  Gx − h ≤ s·1.  solve() → (x, s, warn): s < 0 strictly
    feasible, s ≈ 0 boundary, s > 0 likely empty; warn=True when iteration
    limits were hit (reference: PhaseOne.py:377-395).
    """

    def __init__(self, G, h, mu=15, x0=None, eps=1e-8,
                 max_iter_interior=200, max_iter_newton=200, use_cupy=False,
                 linear_solver="solve", max_cg_iters=50, dtype=None):
        del use_cupy
        dtype = dtype or default_dtype()
        ensure_x64(dtype)
        G = np.asarray(G, dtype=np.float64)
        h = np.asarray(h, dtype=np.float64)
        self.G, self.h = G, h
        self.m, self.n = G.shape
        self.x = (np.asarray(x0, dtype=np.float64) if x0 is not None
                  else np.zeros(self.n))
        self.cfg = SolverConfig(
            t0=1.0, mu=float(mu), epsilon=float(eps),
            max_outer_iters=int(max_iter_interior),
            max_inner_iters=int(max_iter_newton),
            phase1_max_inner_iters=int(max_iter_newton),
            phase1_t0=1.0, phase1_tol=0.0,
            kkt_strategy=linear_solver, max_cg_iters=int(max_cg_iters),
            dtype=dtype,
        )
        self._prob = make_lp(np.zeros(self.n), C=G, d=h, lb=None, ub=None,
                             dtype=self.cfg.jnp_dtype)
        self.s = None
        self.warn = False

    def solve(self):
        # short-circuit when already feasible (reference: PhaseOne.py:342-345)
        if np.max(self.G @ self.x - self.h) <= 0:
            self.s = -1.0
            return self.x, self.s, False
        res = _phase1_core(
            self._prob, jnp.asarray(self.x, dtype=self.cfg.jnp_dtype),
            self.cfg, make_phase1_linear_oracle)
        self.x = np.asarray(res.x)
        self.s = float(res.s)
        self.warn = bool(int(res.outer_iters) >= self.cfg.max_outer_iters
                         and self.s >= 0)
        return self.x, self.s, self.warn
