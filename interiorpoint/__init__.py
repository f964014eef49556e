"""interiorpoint: a JAX/XLA convex-optimization framework with the
capabilities of the reference InteriorPoint-GPU suite.

Problem classes (SURVEY.md §0): LP, QP, SOCP via a log-barrier interior-point
method with (infeasible-start) Newton centering; batched LASSO via ADMM;
phase-one feasibility restoration; oracle-verified testing; benchmark harness.

Public API mirrors the reference drivers:
    LPSolver, QPSolver, SOCPSolver, LassoSolver, PhaseOneSolver
plus the functional, jit/vmap-composable entry points:
    solve_lp, solve_qp, solve_socp, solve_lasso
"""

from .models.lp import LPSolver, solve_lp
from .models.qp import QPSolver, solve_qp
from .models.socp import SOCPSolver, solve_socp
from .models.lasso import LassoSolver, solve_lasso
from .models.phase1 import PhaseOne, PhaseOneSolver
from .utils.config import SolverConfig, AdmmConfig
from .utils.certify import Certificate, certify
from .models.problem import (
    LPProblem, QPProblem, SOCPProblem, LassoProblem,
    make_lp, make_qp, make_socp, make_lasso,
)

__version__ = "0.1.0"

__all__ = [
    "LPSolver", "QPSolver", "SOCPSolver", "LassoSolver",
    "PhaseOneSolver", "PhaseOne",
    "solve_lp", "solve_qp", "solve_socp", "solve_lasso",
    "SolverConfig", "AdmmConfig", "Certificate", "certify",
    "LPProblem", "QPProblem", "SOCPProblem", "LassoProblem",
    "make_lp", "make_qp", "make_socp", "make_lasso",
]
