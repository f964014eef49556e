"""Solver configuration.

The reference implementation configures solvers through constructor kwargs
(reference: LPSolver.py:20-103).  Here the hyperparameters live in a frozen,
hashable dataclass so a config can be passed as a static argument to
``jax.jit`` — every distinct config compiles (and caches) its own XLA
program, replacing the reference's 16-way Newton-class dispatch
(reference: LPSolver.py:371-469) with trace-time specialization.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

# Linear-solve strategies, mirroring the reference's ``linear_solve_method``
# choices (reference: LPSolver.py:79-81).  The reference exposes
# {np_lstsq, np_solve, direct, cg, kkt, cholesky}; we accept those spellings
# and our canonical ones.
_STRATEGY_ALIASES = {
    "cholesky": "cholesky",
    "np_solve": "solve",
    "solve": "solve",
    "np_lstsq": "lstsq",
    "lstsq": "lstsq",
    "direct": "inverse",
    "inverse": "inverse",
    "cg": "cg",
    "kkt": "full_kkt",
    "full_kkt": "full_kkt",
    "diagonal": "diagonal",
}

_DTYPES = {
    "float32": jnp.float32,
    "float64": jnp.float64,
    "bfloat16": jnp.bfloat16,
}


def canonical_strategy(name: str) -> str:
    try:
        return _STRATEGY_ALIASES[name]
    except KeyError:
        raise ValueError(
            f"Unknown linear solve method {name!r}; valid options: "
            f"{sorted(set(_STRATEGY_ALIASES))}"
        ) from None


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Hyperparameters for the barrier interior-point core.

    Defaults match the reference drivers (reference: LPSolver.py:20-50):
    t0=0.1, mu=15, alpha=0.2, beta=0.6, epsilon=1e-10, inner_epsilon=1e-5,
    phase1_t0=0.01, phase1_max_inner_iters=500.
    """

    # Barrier (outer) loop.
    t0: float = 0.1
    mu: float = 15.0
    epsilon: float = 1e-10  # duality-gap stop: num_constraints / t < epsilon
    max_outer_iters: int = 20

    # Newton (inner) loop.
    inner_epsilon: float = 1e-5
    max_inner_iters: int = 50

    # Backtracking line search.
    alpha: float = 0.2
    beta: float = 0.6
    # Candidate steps are beta**k for k in [0, max_linesearch_steps).  The
    # reference's sequential search gives up below 1e-13
    # (reference: NewtonSolver.py:176, NewtonSolverInfeasibleStart.py:186);
    # with beta=0.6, beta**59 < 1e-13, so 64 candidates cover the default.
    max_linesearch_steps: int = 64

    # Phase-one (feasibility) solve.
    phase1_t0: float = 0.01
    phase1_max_inner_iters: int = 500
    phase1_tol: float = 0.0

    # KKT linear-solve strategy (canonical names; see canonical_strategy).
    kkt_strategy: str = "cholesky"
    max_cg_iters: int = 50
    # Adds 1e-9 to the Hessian diagonal before factorization
    # (reference: NewtonSolver.py:269-275 ``use_psd_condition``).
    use_psd_condition: bool = False
    # Diagonal-Hessian fast path when there is no dense inequality block
    # (reference: LPSolver.py:43 ``try_diag``).
    try_diag: bool = True

    # Equality-feasibility gate for accepting an outer iterate.  None selects
    # the per-problem-class reference default: 1e-4*n for LP
    # (reference: LPSolver.py:600), 1e-3 for QP/SOCP
    # (reference: QPSolver.py:585, SOCPSolver.py:702).
    eq_gate: Optional[float] = None

    # Numerics.
    dtype: str = "float32"
    # Rounds of iterative refinement applied to each Cholesky solve; useful
    # in float32 to recover accuracy lost to the factorization.
    refine_steps: int = 0
    # Mixed-precision Cholesky (float64 mode only): factor the
    # Jacobi-scaled Hessian in float32 and refine residuals in float64,
    # with a native f64 factorization when refinement stalls (ops/kkt.py).
    mixed_precision: bool = True
    # Host-stepped dispatch: one device call per barrier stage instead of a
    # single whole-solve execution (models/base.py).  Checkpointed solves
    # use it regardless, since they need host boundaries between stages.
    staged_dispatch: bool = False
    # Iteration cap for the primal-dual Mehrotra engines (algorithm="pd",
    # ops/pd.py and ops/socp_pd.py).  Separate from max_outer_iters: a
    # barrier "outer" is a whole centering stage, a pd iteration is one
    # factorization; typical solves take 10-40.
    pd_max_iters: int = 60

    def __post_init__(self):
        object.__setattr__(
            self, "kkt_strategy", canonical_strategy(self.kkt_strategy)
        )
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")

    @property
    def jnp_dtype(self):
        return _DTYPES[self.dtype]


@dataclasses.dataclass(frozen=True)
class AdmmConfig:
    """Hyperparameters for the batched ADMM LASSO solver.

    Defaults match the reference (reference: LassoSolver.py:18-36):
    rho=0.4, max_iters=1000, check_stop=10, eps_abs=1e-4, eps_rel=3e-2.
    """

    rho: float = 0.4
    max_iters: int = 1000
    check_stop: int = 10
    eps_abs: float = 1e-4
    eps_rel: float = 3e-2
    positive: bool = False
    add_bias: bool = False
    compute_loss: bool = False
    dtype: str = "float32"
    # Over-relaxation coefficient (Boyd et al., "Distributed Optimization
    # and Statistical Learning via ADMM", §3.4.3): x̂ = relax·x +
    # (1−relax)·α in the α/u updates.  1.0 reproduces the reference's
    # plain iteration (LassoSolver.py:240-337, which has no relaxation);
    # values in [1.5, 1.8] typically cut the iteration count 1.5–2× at
    # identical stopping tolerances.  The iteration is bandwidth-bound on
    # the (n, n) cached-inverse matvec, so fewer iterations translate
    # directly to wall-clock.
    relax: float = 1.0
    # Real adaptive ρ (the reference's flag is an unimplemented no-op —
    # LassoSolver.py:144-156): contraction-rate-triggered descents down a
    # precomputed ρ-ladder of ``rho_rungs`` rungs spaced by
    # ``rho_factor``; see ops/admm.py module docstring.
    adaptive_rho: bool = False
    rho_rungs: int = 5
    rho_factor: float = 4.0

    @property
    def jnp_dtype(self):
        return _DTYPES[self.dtype]
