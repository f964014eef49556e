"""Batched ADMM for LASSO: one jitted while_loop over matrix-shaped state.

The reference iterates ADMM in Python with periodic host-synced stopping
checks (reference: LassoSolver.py:240-337).  Here the x-update matmul,
soft-threshold prox, dual update, and stopping-norm evaluation all live in
a single ``lax.while_loop`` — the stopping norms are computed on device and
feed the loop condition directly, so the whole batch of problems runs with
zero host round trips.

Batch semantics follow the reference: a (n × B) iterate matrix solves B
problem instances simultaneously, with a per-problem regularization vector
(reference: LassoSolver.py:109-111) and a *global* (whole-batch) stopping
criterion (reference: LassoSolver.py:273-298).

Adaptive ρ (``cfg.adaptive_rho``): the reference's
``adaptive_rho`` flag is accepted but never implemented (its computation
assigns a dead local — reference: LassoSolver.py:144-156).  Here it is
real.  The classical residual-balancing rule is useless on this iteration
family — both residuals decay at the SAME geometric rate at any ρ
(measured: their ratio locks at ~1.1 while the rate varies 20× across ρ)
— so the trigger is the contraction rate itself: every ``check_stop``
iterations the primal residual is compared against the previous check,
and when the per-check contraction is worse than ``_GAMMA_T`` the solve
descends a precomputed ρ-ladder (ρ0/4^j), rescaling the scaled dual u by
the ρ ratio.  The ladder factorizations are built ONCE in
``admm_prepare`` (the reference factors its single Q at construction
too — LassoSolver.py:158-189) and each rung's segment runs as its own
while_loop with the rung's arrays baked in, so the hot loop has no
dynamic factor selection.  Measured on the reference benchmark recipe
(n=1000, 30 problems, ε=1e-6): 190 iterations vs 2500 plain at matching
objectives (~1e-8 relative).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from ..utils.precision import highest_precision

# Descend the ρ-ladder when the primal residual contracts slower than
# this factor per check interval (see module docstring).
_GAMMA_T = 0.7


class ADMMResult(NamedTuple):
    X: jax.Array           # (n, B) solution (the alpha iterate, as in ref)
    solutions: jax.Array   # (B,) final objective values
    gaps: jax.Array        # (max_iters, B) per-iteration objectives, or (0, B)
    iterations: jax.Array  # scalar int: iterations executed


def soft_threshold(v, eta, positive: bool, add_bias: bool):
    """Proximal operator of η‖·‖₁ (reference: LassoSolver.py:517-543);
    the bias row is passed through unregularized."""
    x = jnp.maximum(v - eta, 0.0)
    if not positive:
        x = x - jnp.maximum(-v - eta, 0.0)
    if add_bias:
        x = x.at[0].set(v[0])
    return x


def lasso_objective(A, b, reg, alpha, positive: bool, add_bias: bool):
    """1/(2m)‖Aα−b‖² + reg·‖α‖₁ column-wise, bias row unregularized
    (reference: LassoSolver.py:487-515)."""
    m = A.shape[0]
    f = (0.5 / m) * jnp.sum((A @ alpha - b) ** 2, axis=0)
    x_abs = alpha if positive else jnp.abs(alpha)
    norm1 = jnp.sum(x_abs[1:], axis=0) if add_bias else jnp.sum(x_abs, axis=0)
    return f + reg * norm1


def _ladder_rhos(cfg):
    """Static ρ rungs: cfg.rho, then /cfg.rho_factor per descent."""
    if not cfg.adaptive_rho:
        return (float(cfg.rho),)
    return tuple(float(cfg.rho) / (float(cfg.rho_factor) ** j)
                 for j in range(int(cfg.rho_rungs)))


def _inverse_for(AtA, eye, m, rho):
    """Q⁻¹ for Q = AᵀA + mρI (reference factors once:
    LassoSolver.py:158-189); the mixed f32-factor + f64-refined solve on
    f64 input (ops/kkt.py)."""
    from .kkt import mixed_posdef_solve

    dtype = AtA.dtype
    Q = AtA + (m * rho) * eye
    if dtype == jnp.float64:
        return mixed_posdef_solve(Q, eye)
    L = jnp.linalg.cholesky(Q)
    Y = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return jax.scipy.linalg.solve_triangular(L.T, Y, lower=False)


def _prepare_impl(A, cfg):
    """Per-rung Q⁻¹ tuple (traced; call under jit)."""
    dtype = A.dtype
    m, n = A.shape
    AtA = A.T @ A
    eye = jnp.eye(n, dtype=dtype)
    return tuple(_inverse_for(AtA, eye, m, rho) for rho in _ladder_rhos(cfg))


@partial(jax.jit, static_argnames=("cfg",))
@highest_precision
def admm_prepare(A, cfg):
    """One-time factorization ladder for ``admm_core_prepared``.

    Drivers cache the result across ``solve()`` calls and sample chunks —
    the reference's cached-Cholesky-at-construction semantics
    (LassoSolver.py:158-189) extended to the adaptive-ρ rungs."""
    return _prepare_impl(A, cfg)


@partial(jax.jit, static_argnames=("cfg", "num_samples"))
@highest_precision
def admm_core_prepared(Qinvs, A, b, reg, cfg,
                       num_samples: int) -> ADMMResult:
    """Run the (possibly ρ-adaptive) batched ADMM given the prepared
    inverse ladder (``admm_prepare``)."""
    dtype = A.dtype
    m, n = A.shape
    B = num_samples
    rhos = _ladder_rhos(cfg)
    J = len(rhos)
    assert len(Qinvs) == J, "prepared ladder does not match cfg"

    Atb = A.T @ b

    rungs = []
    for j in range(J):
        bA_j = Qinvs[j] @ Atb                     # (n, b_cols)
        Qs_j = -(m * rhos[j]) * Qinvs[j]          # (reference: :219)
        rungs.append((bA_j, Qs_j))

    stop_multiplier = cfg.eps_abs * jnp.sqrt(jnp.asarray(n * B, dtype))
    gaps_rows = cfg.max_iters if cfg.compute_loss else 0

    class S(NamedTuple):
        x: jax.Array
        alpha: jax.Array
        u: jax.Array
        gaps: jax.Array
        it: jax.Array
        done: jax.Array
        act: jax.Array      # this rung's segment is live
        desc: jax.Array     # contraction too slow -> take the next rung
        r_prev: jax.Array   # primal residual at the previous check
        checks: jax.Array   # completed checks on this rung

    def cond(s: S):
        return s.act & (~s.done) & (~s.desc) & (s.it < cfg.max_iters)

    def make_body(bA, Qs, rho, allow_desc: bool):
        rho_t = jnp.asarray(rho, dtype)
        eta = reg / rho_t                         # (B,) or (1,)

        def body(s: S):
            x = bA + Qs @ (s.u - s.alpha)
            last_alpha = s.alpha
            # Over-relaxation (cfg.relax in [1.5, 1.8]; 1.0 = reference
            # iteration): x̂ replaces x in the α and u updates only — the
            # stopping residual below keeps the true r = x − α.
            if cfg.relax != 1.0:
                xh = cfg.relax * x + (1.0 - cfg.relax) * s.alpha
            else:
                xh = x
            alpha = soft_threshold(xh + s.u, eta, cfg.positive,
                                   cfg.add_bias)
            u = s.u + xh - alpha

            if cfg.compute_loss:
                f = lasso_objective(A, b, reg, alpha, cfg.positive,
                                    cfg.add_bias)
                gaps = s.gaps.at[s.it].set(f)
            else:
                gaps = s.gaps

            def check(_):
                r_norm = jnp.linalg.norm(x - alpha)
                d_norm = rho_t * jnp.linalg.norm(alpha - last_alpha)
                tol_primal = (stop_multiplier
                              + cfg.eps_rel * jnp.linalg.norm(alpha))
                tol_dual = (stop_multiplier
                            + cfg.eps_rel * rho_t * jnp.linalg.norm(u))
                done = (r_norm < tol_primal) & (d_norm < tol_dual)
                if allow_desc:
                    slow = ((s.checks >= 1) & jnp.isfinite(s.r_prev)
                            & (r_norm > _GAMMA_T * s.r_prev))
                    desc = (~done) & slow
                else:
                    desc = jnp.zeros((), bool)
                return done, desc, r_norm, s.checks + 1

            def no_check(_):
                return (jnp.zeros((), bool), jnp.zeros((), bool),
                        s.r_prev, s.checks)

            is_check = (s.it % cfg.check_stop) == (cfg.check_stop - 1)
            done, desc, r_prev, checks = lax.cond(is_check, check,
                                                  no_check, None)
            return S(x=x, alpha=alpha, u=u, gaps=gaps, it=s.it + 1,
                     done=done, act=s.act, desc=desc, r_prev=r_prev,
                     checks=checks)

        return body

    zeros = jnp.zeros((n, B), dtype)
    st = S(x=zeros, alpha=zeros, u=zeros,
           gaps=jnp.zeros((gaps_rows, B), dtype),
           it=jnp.zeros((), jnp.int32), done=jnp.zeros((), bool),
           act=jnp.ones((), bool), desc=jnp.zeros((), bool),
           r_prev=jnp.asarray(jnp.inf, dtype),
           checks=jnp.zeros((), jnp.int32))

    inf = jnp.asarray(jnp.inf, dtype)
    for j in range(J):
        if j > 0:
            # Enter rung j only when rung j-1 asked to descend; the
            # scaled dual u = y/ρ rescales by the ρ ratio.
            act = st.act & st.desc
            scale = rhos[j - 1] / rhos[j]
            st = st._replace(u=jnp.where(act, st.u * scale, st.u),
                             act=act, desc=jnp.zeros((), bool),
                             r_prev=inf,
                             checks=jnp.zeros((), jnp.int32))
        body = make_body(*rungs[j], rhos[j], allow_desc=(j + 1 < J))
        st = lax.while_loop(cond, body, st)

    solutions = lasso_objective(A, b, reg, st.alpha, cfg.positive,
                                cfg.add_bias)
    return ADMMResult(X=st.alpha, solutions=solutions, gaps=st.gaps,
                      iterations=st.it)


def admm_core(A, b, reg, cfg, num_samples: int) -> ADMMResult:
    """Solve the batched LASSO with cached-Cholesky ADMM.

    Factors Q = AᵀA + mρI (reference: LassoSolver.py:158-189) — per
    ladder rung when ``cfg.adaptive_rho``.  Deviation (bugfix): the
    reference only builds AtA_cache when ``add_bias=True`` and crashes
    otherwise (reference: LassoSolver.py:122-130 vs :161); here it is
    always computed.  Drivers that solve repeatedly should use
    ``admm_prepare`` + ``admm_core_prepared`` to reuse the factors
    (this convenience wrapper rebuilds them every call).
    """
    return admm_core_prepared(admm_prepare(A, cfg), A, b, reg, cfg,
                              num_samples)
