"""Null-space (reduced-space) elimination of equality constraints.

Algorithmic redesign, no reference analogue: the reference's
infeasible-start Newton factors an n×n barrier Hessian and an m×m Schur
complement at *every* Newton step (reference:
NewtonSolverInfeasibleStart.py:386-511) — O(n³ + m²n) of
triangular-solve-bound work per iteration.  Dense factorizations and
triangular solves run far below matmul throughput on an accelerator, so
we instead eliminate Ax = b once per problem:

    x = x_p + N z,   A x_p = b,   A N = 0,   NᵀN = I_r,   r = n − m

after which the barrier subproblems live in r dimensions with *only*
inequality constraints: every Newton step factors an r×r matrix (r = 0.2n
on the reference benchmark — a 125× FLOP cut on the factorization) and the
remaining per-iteration work is matmuls with the reduced constraint
matrix.  Equality feasibility holds by construction, so the
feasible-start engine applies and the dual iterate v is recovered once at
the end from the stationarity condition.

The drivers build the basis on the host with LAPACK QR
(``affine_elimination``).  The device variant (``_elimination_core``) uses
CholeskyQR² (matmuls + small Cholesky factors), whose orthogonality error
is O(eps) after the second pass for the well-conditioned projected
Gaussian blocks used here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .kkt import chol_solve, mixed_posdef_solve, robust_cholesky
from ..utils.precision import highest_precision


@jax.jit
@highest_precision
def _elimination_core(A, b, G):
    """Device-side affine elimination as one compiled program instead of
    ~20 eagerly-dispatched ops."""
    AAt = A @ A.T
    x_p = A.T @ mixed_posdef_solve(AAt, b)
    N0 = G - A.T @ mixed_posdef_solve(AAt, A @ G)
    N = _cholesky_qr2(N0)
    N = N - A.T @ mixed_posdef_solve(AAt, A @ N)
    N = _cholesky_qr2(N)
    return N, x_p, AAt


class AffineBasis(NamedTuple):
    """x = x_p + N z parameterization of {x : Ax = b}."""
    N: jax.Array       # (n, r) orthonormal null-space basis of A
    x_p: jax.Array     # (n,) particular solution (min-norm)
    AAt: jax.Array     # AAᵀ (reused for dual recovery via mixed solve)


def _cholesky_qr2(X):
    """Two-pass Cholesky-QR orthonormalization of the columns of X."""
    for _ in range(2):
        S = X.T @ X
        L = robust_cholesky(S)
        # X ← X L⁻ᵀ  (right triangular solve)
        X = jax.scipy.linalg.solve_triangular(L, X.T, lower=True).T
    return X


def affine_elimination(A, b, seed: int = 0) -> AffineBasis:
    """Factor {x : Ax = b} = {x_p + N z}.  Requires full row rank
    (guaranteed for the reference benchmark's dense Gaussian A;
    rank-deficient A surfaces as a non-finite factor → caller falls back
    to the full-space engine).

    Runs on the HOST in LAPACK float64: this is one-time setup, a host
    QR is exactly orthogonal, and only the three results (N, x_p, AAᵀ)
    are shipped to device.
    """
    del seed  # the host QR needs no random probe block
    dtype = getattr(A, "dtype", np.float64)
    A_h = np.asarray(A, dtype=np.float64)
    b_h = np.asarray(b, dtype=np.float64)
    m, n = A_h.shape
    r = n - m
    if r <= 0:
        raise ValueError("null-space elimination requires m < n")

    from scipy.linalg import qr, solve_triangular

    # Full QR of Aᵀ: columns m: of Q span null(A) exactly; with
    # Aᵀ = QR, x_p = Q₁ R₁⁻ᵀ b is the min-norm particular solution.
    Q, R = qr(A_h.T, mode="full")
    diag = np.abs(np.diag(R[:m, :m]))
    if diag.min() <= max(m, n) * np.finfo(np.float64).eps * diag.max():
        # Rank-deficient: surface the caller's fallback convention.
        nan = jnp.full((n, r), jnp.nan, dtype=dtype)
        return AffineBasis(N=nan, x_p=jnp.full((n,), jnp.nan, dtype=dtype),
                           AAt=jnp.asarray(A_h @ A_h.T, dtype=dtype))
    w = solve_triangular(R[:m, :m].T, b_h, lower=True)
    x_p = Q[:, :m] @ w
    N = Q[:, m:]
    AAt = A_h @ A_h.T
    return AffineBasis(N=jnp.asarray(N, dtype=dtype),
                       x_p=jnp.asarray(x_p, dtype=dtype),
                       AAt=jnp.asarray(AAt, dtype=dtype))


def recover_equality_dual(basis: AffineBasis, A, g_full):
    """v solving min‖Aᵀv + g_full‖: the equality multiplier consistent with
    stationarity at the final iterate (full-space analogue:
    the v carried by the infeasible-start engine; reference dual recovery
    v* = v/t at LPSolver.py:641-646 — here computed in closed form)."""
    return -mixed_posdef_solve(basis.AAt, A @ g_full)
