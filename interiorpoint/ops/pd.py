"""Primal-dual Mehrotra predictor-corrector engine for LP/QP.

New capability beyond the reference suite, which implements only the
log-barrier method (reference: LPSolver.py:514-653 outer loop,
NewtonSolverInfeasibleStart.py:72-273 inner loop): an infeasible-start
primal-dual interior-point method on the inequality-form problem

    min ½ zᵀP z + qᵀz   s.t.   C z ≤ d        (P = 0 for LP)

— i.e. the reduced (null-space-eliminated) problem the drivers already
build (models/reduced.py), where equality constraints are gone and
bounds are rows of C.  Compared to the barrier path at equal tolerance
it typically needs 15–40 iterations instead of 70–150 Newton steps
(one r×r factorization each), and it needs NO phase-one solve: the
method is infeasible-start in both primal and dual, so a starting point
that violates C z ≤ d costs a few extra iterations instead of a whole
auxiliary barrier solve.

Structure: the entire solve is ONE jitted ``lax.while_loop`` over a
small state pytree — no host round trips — and each iteration factors
the Newton matrix H = P + Cᵀdiag(λ/s)C once, reusing the factor for the
predictor and corrector solves (ops/kkt.py ``posdef_solver``: the
mixed-precision f32 factor + f64 refinement when
``cfg.mixed_precision``, a native-precision Cholesky otherwise).

Algorithm (Mehrotra 1992; Wright, "Primal-Dual Interior-Point Methods"
ch. 10): affine-scaling predictor, adaptive centering σ = (μ_aff/μ)³,
corrector with the dS_aff·dΛ_aff complementarity correction, and
fraction-to-boundary steps γ = 0.99995.

Selected via ``LPSolver(..., algorithm="pd")`` / ``QPSolver(...,
algorithm="pd")``; the default remains the reference-parity barrier.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .kkt import posdef_solver

_HIGHEST = jax.lax.Precision.HIGHEST

# Fraction-to-boundary: keep (s, λ) strictly positive.
_GAMMA = 0.99995
# Declare a stall when neither the primal nor dual step moves.
_STALL_STEP = 1e-10


class PDResult(NamedTuple):
    z: jax.Array          # primal iterate (reduced or full space)
    lam: jax.Array        # inequality multipliers, order matching C's rows
    s: jax.Array          # primal slacks d − Cz (up to the residual rp)
    v: jax.Array          # equality multipliers (zeros(0) when no A)
    iters: jax.Array      # iterations taken
    converged: jax.Array  # bool: gap + feasibility tolerances met
    gap: jax.Array        # final complementarity gap sᵀλ
    rp_norm: jax.Array    # ‖Cz + s − d‖∞ (∨ ‖Az − b‖∞ when A given)
    rd_norm: jax.Array    # ‖Pz + q + Cᵀλ + Aᵀv‖∞


def _max_step(v, dv):
    """Largest α ∈ (0, 1] with v + α·dv ≥ 0 (v > 0 elementwise)."""
    ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
    return jnp.minimum(1.0, jnp.min(ratio))


def pd_solve(prob, z0, cfg, max_iters=None, A=None, b=None) -> PDResult:
    """Run the predictor-corrector solve on an inequality-form problem
    pytree (LPProblem/QPProblem: ``C``/``d`` plus ``c`` or ``P``/``q``),
    optionally with an equality pair ``A x = b`` handled by the same
    Schur block elimination the Newton engines use (ops/kkt.py:
    H·Y = Aᵀ, S = A·H⁻¹Aᵀ) — the H and S factorizations are built once
    per iteration and reused across the predictor and corrector.
    Jit-compatible (also under vmap); returns a :class:`PDResult`."""
    C, d = prob.C, prob.d
    P = getattr(prob, "P", None)
    if P is not None:
        q = prob.q if prob.q is not None else jnp.zeros_like(z0)
    else:
        q = prob.c
    dtype = C.dtype
    k = C.shape[0]
    has_eq = A is not None
    mixed = bool(cfg.mixed_precision) and dtype == jnp.float64
    if max_iters is None:
        max_iters = int(cfg.pd_max_iters)

    z0 = z0.astype(dtype)
    # Infeasible start (Mehrotra-style): a strictly feasible z0 keeps
    # s = d − Cz exactly (rp = 0, full warm-start value); a violated one
    # gets a GLOBAL slack shift δ ≈ 1.5·|worst violation| — the balanced
    # complementarity this produces converges in ~15 iterations where a
    # per-row floor (tiny s, huge λ on violated rows) took ~40.
    s_hat = d - C @ z0
    floor = 1e-4 * (1.0 + jnp.max(jnp.abs(d)))
    smin = jnp.min(s_hat)
    delta = jnp.where(smin < floor,
                      -1.5 * jnp.minimum(smin, 0.0) + floor, 0.0)
    s0 = jnp.maximum(s_hat + delta, floor)
    lam0 = jnp.clip(1.0 / s0, 1e-6, 1e6)
    v0 = jnp.zeros(A.shape[0] if has_eq else 0, dtype=dtype)

    gap_tol = jnp.asarray(cfg.epsilon, dtype)
    # Feasibility tolerances (relative): PD residuals contract by (1−α)
    # per step, so they reach these levels within the iterations that
    # close the gap; tied to epsilon so loose solves stay cheap.
    feas_tol = jnp.maximum(1e-9, jnp.minimum(1e-6, gap_tol))
    d_scale = 1.0 + jnp.max(jnp.abs(d))
    if has_eq:
        d_scale = jnp.maximum(d_scale, 1.0 + jnp.max(jnp.abs(b)))
    q_scale = 1.0 + jnp.max(jnp.abs(q))

    def residuals(z, s, lam, v):
        rd = q + C.T @ lam
        if P is not None:
            rd = rd + P @ z
        if has_eq:
            rd = rd + A.T @ v
        rp = C @ z + s - d
        rpe = (A @ z - b) if has_eq else jnp.zeros(0, dtype=dtype)
        return rd, rp, rpe

    def prepare(H):
        return posdef_solver(H, mixed)

    def body(st):
        z, s, lam, v, it, *_ = st
        rd, rp, rpe = residuals(z, s, lam, v)
        w = lam / s
        H = jnp.matmul(C.T * w[None, :], C, precision=_HIGHEST)
        if P is not None:
            H = H + P
        solve_h = prepare(H)
        if has_eq:
            Hinv_AT = solve_h(A.T)
            S = A @ Hinv_AT
            solve_s = prepare(0.5 * (S + S.T))

        def direction(rc):
            rhs = -rd + C.T @ ((rc - lam * rp) / s)
            if has_eq:
                # H dz + Aᵀ dv = rhs, A dz = −rpe  ⇒  S dv = A H⁻¹rhs + rpe
                t1 = solve_h(rhs)
                dv = solve_s(A @ t1 + rpe)
                dz = t1 - Hinv_AT @ dv
            else:
                dv = jnp.zeros(0, dtype=dtype)
                dz = solve_h(rhs)
            ds = -rp - C @ dz
            dlam = (-rc - lam * ds) / s
            return dz, ds, dlam, dv

        mu = jnp.dot(s, lam) / k
        # predictor (affine scaling, σ = 0)
        dz_a, ds_a, dl_a, _ = direction(s * lam)
        ap_a = _max_step(s, ds_a)
        ad_a = _max_step(lam, dl_a)
        mu_aff = jnp.dot(s + ap_a * ds_a, lam + ad_a * dl_a) / k
        sigma = jnp.clip((mu_aff / mu) ** 3, 0.0, 1.0)
        # corrector (same factorizations)
        rc = s * lam - sigma * mu + ds_a * dl_a
        dz, ds, dlam, dv = direction(rc)
        ap = jnp.minimum(1.0, _GAMMA * _max_step(s, ds))
        ad = jnp.minimum(1.0, _GAMMA * _max_step(lam, dlam))

        z2 = z + ap * dz
        s2 = s + ap * ds
        lam2 = lam + ad * dlam
        v2 = v + ad * dv
        rd2, rp2, rpe2 = residuals(z2, s2, lam2, v2)
        gap2 = jnp.dot(s2, lam2)
        rpn2 = jnp.max(jnp.abs(rp2))
        if has_eq:
            rpn2 = jnp.maximum(rpn2, jnp.max(jnp.abs(rpe2)))
        rdn2 = jnp.max(jnp.abs(rd2))
        stalled = (ap < _STALL_STEP) & (ad < _STALL_STEP)
        # non-finite guard (as in ops/socp_pd.py): a degenerate late-stage
        # factorization must keep the last good iterate and stop, not
        # overwrite the state with NaN
        bad = ~(jnp.isfinite(gap2) & jnp.isfinite(rpn2) & jnp.isfinite(rdn2)
                & jnp.all(jnp.isfinite(z2)) & jnp.all(jnp.isfinite(lam2)))
        keep = lambda new, old: jnp.where(bad, old, new)
        old = st
        return (keep(z2, old[0]), keep(s2, old[1]), keep(lam2, old[2]),
                keep(v2, old[3]), it + 1, keep(gap2, old[5]),
                keep(rpn2, old[6]), keep(rdn2, old[7]), stalled | bad)

    def cond(st):
        _, _, _, _, it, gap, rpn, rdn, stalled = st
        done = ((gap < gap_tol) & (rpn < feas_tol * d_scale)
                & (rdn < feas_tol * q_scale))
        return (it < max_iters) & ~done & ~stalled & jnp.isfinite(gap)

    rd0, rp0, rpe0 = residuals(z0, s0, lam0, v0)
    rpn0 = jnp.max(jnp.abs(rp0))
    if has_eq:
        rpn0 = jnp.maximum(rpn0, jnp.max(jnp.abs(rpe0)))
    st0 = (z0, s0, lam0, v0, jnp.zeros((), jnp.int32),
           jnp.dot(s0, lam0), rpn0, jnp.max(jnp.abs(rd0)),
           jnp.zeros((), bool))
    z, s, lam, v, it, gap, rpn, rdn, _ = lax.while_loop(cond, body, st0)
    converged = ((gap < gap_tol) & (rpn < feas_tol * d_scale)
                 & (rdn < feas_tol * q_scale))
    return PDResult(z=z, lam=lam, s=s, v=v, iters=it, converged=converged,
                    gap=gap, rp_norm=rpn, rd_norm=rdn)
