"""Reduced-space (null-space) problem transforms.

Builds the z-space problem for ops/nullspace.py's elimination x = x_p + Nz:
equality constraints vanish, bounds become general inequalities, cones are
rotated by N.  Slack *values* are identical to the full-space slacks at the
corresponding x (same ordering [Cx≤d, ub, lb] — FunctionManager.py:50-62),
so the duality gap m/t, the barrier trajectory semantics, and the dual
recovery λ* = 1/(t·slacks) all carry over unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.nullspace import AffineBasis, affine_elimination
from .problem import LPProblem, QPProblem, SOCPProblem
from ..utils.precision import highest_precision


class ReducedForm(NamedTuple):
    prob: object           # z-space problem pytree (no equality block)
    basis: AffineBasis
    obj_offset: jax.Array  # objective value contribution of x_p

    def expand(self, z):
        """Map a z-space iterate back to x-space."""
        return self.basis.x_p + self.basis.N @ z


def _reduced_ineq_block(prob, N, x_p):
    """Stack [C; I(ub); −I(lb)] · (x_p + Nz) ≤ [d; ub; −lb] into a single
    (k + #ub + #lb) × r inequality block, preserving slack order/values."""
    rows, rhs = [], []
    if prob.C is not None:
        rows.append(prob.C @ N)
        rhs.append(prob.d - prob.C @ x_p)
    if prob.ub is not None:
        rows.append(N)
        rhs.append(prob.ub - x_p)
    if prob.lb is not None:
        rows.append(-N)
        rhs.append(x_p - prob.lb)
    if not rows:
        return None, None
    return jnp.concatenate(rows, axis=0), jnp.concatenate(rhs)


@jax.jit
@highest_precision
def _reduce_lp_core(prob, N, x_p):
    C_z, d_z = _reduced_ineq_block(prob, N, x_p)
    return LPProblem(c=N.T @ prob.c, C=C_z, d=d_z), prob.c @ x_p


def reduce_lp(prob: LPProblem, seed: int = 0) -> ReducedForm:
    basis = affine_elimination(prob.A, prob.b, seed)
    prob_z, offset = _reduce_lp_core(prob, basis.N, basis.x_p)
    return ReducedForm(prob=prob_z, basis=basis, obj_offset=offset)


@jax.jit
@highest_precision
def _reduce_qp_core(prob, N, x_p):
    C_z, d_z = _reduced_ineq_block(prob, N, x_p)
    Px_p = prob.P @ x_p
    q_z = N.T @ (Px_p if prob.q is None else Px_p + prob.q)
    offset = 0.5 * x_p @ Px_p
    if prob.q is not None:
        offset = offset + prob.q @ x_p
    return QPProblem(P=N.T @ (prob.P @ N), q=q_z, C=C_z, d=d_z), offset


def reduce_qp(prob: QPProblem, seed: int = 0) -> ReducedForm:
    basis = affine_elimination(prob.A, prob.b, seed)
    prob_z, offset = _reduce_qp_core(prob, basis.N, basis.x_p)
    return ReducedForm(prob=prob_z, basis=basis, obj_offset=offset)


def reduce_socp(prob: SOCPProblem, seed: int = 0) -> ReducedForm:
    """Cones rotate: ‖A_i(x_p+Nz)+b_i‖ ≤ c_i·(x_p+Nz)+d_i becomes a cone in
    z with Ã=A_iN, b̃=A_ix_p+b_i, c̃=Nᵀc_i, d̃=c_i·x_p+d_i.  Requires no
    bound constraints (the SOCP problem pytree has no dense linear
    inequality block to fold them into); the driver falls back to the
    full-space engine when bounds are present."""
    if prob.lb is not None or prob.ub is not None:
        raise ValueError("reduced SOCP requires unbounded variables")
    basis = affine_elimination(prob.F, prob.g, seed)
    prob_z, offset = _reduce_socp_core(prob, basis.N, basis.x_p)
    return ReducedForm(prob=prob_z, basis=basis, obj_offset=offset)


@jax.jit
@highest_precision
def _reduce_socp_core(prob, N, x_p):
    A_z = jnp.einsum("kmn,nr->kmr", prob.A, N)
    b_z = jnp.einsum("kmn,n->km", prob.A, x_p) + prob.b
    c_z = prob.c @ N
    d_z = prob.d + prob.c @ x_p
    offset = jnp.zeros((), dtype=x_p.dtype)
    P_z = q_z = None
    if prob.P is not None:
        Px_p = prob.P @ x_p
        q_z = N.T @ (Px_p if prob.q is None else Px_p + prob.q)
        P_z = N.T @ (prob.P @ N)
        offset = offset + 0.5 * x_p @ Px_p
        if prob.q is not None:
            offset = offset + prob.q @ x_p
    elif prob.q is not None:
        q_z = N.T @ prob.q
        offset = offset + prob.q @ x_p
    return SOCPProblem(A=A_z, b=b_z, c=c_z, d=d_z, P=P_z, q=q_z), offset


def full_space_pd_problem(prob, dtype):
    """Inequality-form problem for the primal-dual engines (ops/pd.py):
    bounds stacked into the C block via the identity map x = I·z + 0
    (the n = r special case of ``_reduced_ineq_block``).  Shared by the
    driver fallback, the functional entries, and the batched path so the
    pd lowering exists exactly once.  Raises when the problem has no
    inequalities or bounds (pd needs a nonempty slack cone)."""
    n = prob.n
    C_z, d_z = _reduced_ineq_block(prob, jnp.eye(n, dtype=dtype),
                                   jnp.zeros((n,), dtype))
    if C_z is None:
        raise ValueError(
            "algorithm='pd' requires inequality constraints or bounds")
    if getattr(prob, "P", None) is not None:
        return QPProblem(P=prob.P, q=prob.q, C=C_z, d=d_z)
    return LPProblem(c=prob.c, C=C_z, d=d_z)
