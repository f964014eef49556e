"""Problem definitions as JAX pytrees.

The reference keeps problem data as mutable attributes on solver objects and
threads a stateful ``FunctionManager`` cache through every evaluation
(reference: FunctionManager.py:11-194).  Here a problem is an immutable
pytree of device arrays; oracles are pure functions of (problem, x, t), and
XLA's CSE replaces the reference's dirty-flag caching.

Field presence (None vs array) is pytree *structure*, so jitted solvers
specialize at trace time on which blocks exist — the functional analogue of
the reference's ``is_constrained`` / ``is_bounded`` branching
(reference: FunctionManager.py:47-48).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np
import jax.numpy as jnp


def _register(cls, data_fields):
    meta = [f.name for f in dataclasses.fields(cls) if f.name not in data_fields]
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta)
    return cls


@dataclasses.dataclass(frozen=True)
class LPProblem:
    """min cᵀx  s.t.  Ax = b, Cx ≤ d, lb ≤ x ≤ ub.

    (reference: LPSolver.py:51-56)
    """

    c: jax.Array
    A: Optional[jax.Array] = None
    b: Optional[jax.Array] = None
    C: Optional[jax.Array] = None
    d: Optional[jax.Array] = None
    lb: Optional[jax.Array] = None  # always a length-n vector when present
    ub: Optional[jax.Array] = None

    @property
    def n(self) -> int:
        return self.c.shape[-1]

    @property
    def num_ineq_constraints(self) -> int:
        """Inequality count used for the duality gap m/t
        (reference: LPSolver.py:179-185)."""
        m = 0
        if self.d is not None:
            m += self.d.shape[-1]
        if self.lb is not None:
            m += self.n
        if self.ub is not None:
            m += self.n
        return m


@dataclasses.dataclass(frozen=True)
class QPProblem:
    """min ½xᵀPx + qᵀx  s.t.  Ax = b, Cx ≤ d, lb ≤ x ≤ ub.

    (reference: QPSolver.py:55-60)
    """

    P: jax.Array
    q: Optional[jax.Array] = None
    A: Optional[jax.Array] = None
    b: Optional[jax.Array] = None
    C: Optional[jax.Array] = None
    d: Optional[jax.Array] = None
    lb: Optional[jax.Array] = None
    ub: Optional[jax.Array] = None

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def num_ineq_constraints(self) -> int:
        m = 0
        if self.d is not None:
            m += self.d.shape[-1]
        if self.lb is not None:
            m += self.n
        if self.ub is not None:
            m += self.n
        return m


@dataclasses.dataclass(frozen=True)
class SOCPProblem:
    """min ½xᵀPx + qᵀx  s.t.  ‖Aᵢx+bᵢ‖₂ ≤ cᵢᵀx+dᵢ (i=1..K), Fx = g, bounds.

    (reference: SOCPSolver.py:55-61)

    The reference stores cones as Python lists and loops over them in the
    oracle (reference: FunctionManager.py:1076-1158).  Here all K cones are
    packed into stacked, padded tensors so slack/gradient/Hessian
    evaluation is a handful of batched einsums:

      A:        (K, M, n)  rows beyond a cone's true height are zero-padded
      b:        (K, M)     zero padding keeps ‖·‖² sums exact
      c:        (K, n)
      d:        (K,)
    """

    A: jax.Array
    b: jax.Array
    c: jax.Array
    d: jax.Array
    P: Optional[jax.Array] = None
    q: Optional[jax.Array] = None
    F: Optional[jax.Array] = None
    g: Optional[jax.Array] = None
    lb: Optional[jax.Array] = None
    ub: Optional[jax.Array] = None

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def num_cones(self) -> int:
        return self.A.shape[-3]

    @property
    def num_ineq_constraints(self) -> int:
        """(reference: SOCPSolver.py:208-214)"""
        m = self.num_cones
        if self.lb is not None:
            m += self.n
        if self.ub is not None:
            m += self.n
        return m


@dataclasses.dataclass(frozen=True)
class LassoProblem:
    """min 1/(2m)‖Ax − b‖² + λ‖x‖₁, batched over columns of b and entries
    of reg.  (reference: LassoSolver.py:37-46)

      A:   (m, n)
      b:   (m, B)
      reg: (B,) or (1,) — per-problem regularization strength
    """

    A: jax.Array
    b: jax.Array
    reg: jax.Array

    @property
    def n(self) -> int:
        return self.A.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]

    @property
    def num_samples(self) -> int:
        return max(self.b.shape[-1], self.reg.shape[-1])


_register(LPProblem, ["c", "A", "b", "C", "d", "lb", "ub"])
_register(QPProblem, ["P", "q", "A", "b", "C", "d", "lb", "ub"])
_register(SOCPProblem, ["A", "b", "c", "d", "P", "q", "F", "g", "lb", "ub"])
_register(LassoProblem, ["A", "b", "reg"])


def _as_bound_vector(bound, n, dtype):
    """Broadcast scalar bounds to length-n vectors (the reference accepts
    scalars and relies on NumPy broadcasting; reference: LPSolver.py:271-306)."""
    if bound is None:
        return None
    arr = jnp.asarray(bound, dtype=dtype)
    if arr.ndim == 0:
        arr = jnp.full((n,), arr, dtype=dtype)
    return arr


def make_lp(c, A=None, b=None, C=None, d=None, lb=None, ub=None,
            dtype=jnp.float64) -> LPProblem:
    cvt = lambda v: None if v is None else jnp.asarray(v, dtype=dtype)
    c = cvt(c)
    n = c.shape[-1]
    return LPProblem(c=c, A=cvt(A), b=cvt(b), C=cvt(C), d=cvt(d),
                     lb=_as_bound_vector(lb, n, dtype),
                     ub=_as_bound_vector(ub, n, dtype))


def make_qp(P, q=None, A=None, b=None, C=None, d=None, lb=None, ub=None,
            dtype=jnp.float64) -> QPProblem:
    cvt = lambda v: None if v is None else jnp.asarray(v, dtype=dtype)
    P = cvt(P)
    n = P.shape[-1]
    return QPProblem(P=P, q=cvt(q), A=cvt(A), b=cvt(b), C=cvt(C), d=cvt(d),
                     lb=_as_bound_vector(lb, n, dtype),
                     ub=_as_bound_vector(ub, n, dtype))


def make_socp(A, b=None, c=None, d=None, P=None, q=None, F=None, g=None,
              lb=None, ub=None, dtype=jnp.float64) -> SOCPProblem:
    """Pack list-of-cones input (reference API shape, SOCPSolver.py:255-382)
    into stacked padded tensors.

    ``A`` is a list of (mᵢ, n) matrices (or 1-D arrays interpreted as
    diagonal, matching the reference's diagonal compression at
    SOCPSolver.py:285-292); b a list of (mᵢ,) vectors; c a list of (n,)
    vectors; d a list of scalars.
    """
    if not isinstance(A, (list, tuple)):
        A = [A]
    K = len(A)
    A_mats = []
    for Ai in A:
        Ai = np.asarray(Ai)
        if Ai.ndim == 1:
            Ai = np.diag(Ai)
        A_mats.append(Ai)
    n = A_mats[0].shape[1]
    M = max(Ai.shape[0] for Ai in A_mats)

    A_pad = np.zeros((K, M, n))
    for i, Ai in enumerate(A_mats):
        A_pad[i, : Ai.shape[0], :] = Ai

    b_pad = np.zeros((K, M))
    if b is not None:
        if not isinstance(b, (list, tuple)):
            b = [b]
        if len(b) == 1:
            b = list(b) * K  # broadcast like reference SOCPSolver.py:313-314
        for i, bi in enumerate(b):
            bi = np.asarray(bi)
            b_pad[i, : bi.shape[0]] = bi

    c_pad = np.zeros((K, n))
    if c is not None:
        if not isinstance(c, (list, tuple)):
            c = [c]
        for i, ci in enumerate(c):
            c_pad[i] = np.asarray(ci)

    d_pad = np.zeros((K,))
    if d is not None:
        if not isinstance(d, (list, tuple)):
            d = [d]
        if len(d) == 1:
            d = list(d) * K  # broadcast like reference SOCPSolver.py:375-376
        for i, di in enumerate(d):
            d_pad[i] = float(di)

    cvt = lambda v: None if v is None else jnp.asarray(v, dtype=dtype)
    return SOCPProblem(
        A=jnp.asarray(A_pad, dtype=dtype),
        b=jnp.asarray(b_pad, dtype=dtype),
        c=jnp.asarray(c_pad, dtype=dtype),
        d=jnp.asarray(d_pad, dtype=dtype),
        P=cvt(P), q=cvt(q), F=cvt(F), g=cvt(g),
        lb=_as_bound_vector(lb, n, dtype),
        ub=_as_bound_vector(ub, n, dtype),
    )


def make_lasso(A, b, reg=1.0, dtype=jnp.float64) -> LassoProblem:
    A = jnp.asarray(A, dtype=dtype)
    b = jnp.asarray(b, dtype=dtype)
    if b.ndim < 2:
        b = b[:, None]  # (reference: LassoSolver.py:98-99)
    reg = jnp.atleast_1d(jnp.asarray(reg, dtype=dtype))
    return LassoProblem(A=A, b=b, reg=reg)
