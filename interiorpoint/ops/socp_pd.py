"""Conic primal-dual Mehrotra engine for SOCP (Nesterov–Todd scaling).

New capability beyond the reference (whose SOCP path is the squared-cone
log-barrier, FunctionManager.py:834-1162): a primal-dual
predictor-corrector interior-point method on the natural conic form

    min ½xᵀPx + qᵀx
    s.t.  F x = g,
          u_k := G_k x + h_k ∈ Q^{1+M}   (G_k = [c_kᵀ; A_k], h_k = [d_k; b_k])
          lb ≤ x ≤ ub                     (nonnegative-orthant segments)

with the standard second-order-cone Jordan algebra: per-cone NT scaling
points, arrow-operator solves for the linearized complementarity
λ∘(W dz + W⁻¹ds) = σμe − λ∘λ − corr, Mehrotra's affine predictor /
centering-corrector, and fraction-to-boundary steps in the cone norm.
This is the algorithm family of production conic solvers (ECOS,
Clarabel); iteration counts are 10–30 versus the barrier's 100+ Newton
steps on the benchmark recipes.

Structure: all K cones live in stacked (K, M+1) tensors and
every Jordan/NT operation is a batched elementwise/matvec sweep; the
whole solve is one jitted ``lax.while_loop``; the Newton matrix
H = P + Σ G_kᵀW_k⁻²G_k + bound-diag is assembled from the rank-3
structure of W⁻² (one stacked GᵀG einsum + three rank-1 outer products
per cone) and factored once per iteration, reused across predictor and
corrector (ops/kkt.py ``posdef_solver``).

Selected via ``SOCPSolver(..., algorithm="pd")``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .kkt import posdef_solver
from .pd import _max_step as _max_step_lin

_HIGHEST = jax.lax.Precision.HIGHEST
_GAMMA = 0.99
_STALL_STEP = 1e-10


def dir_stall_tol(epsilon: float, floor: float = 1e-6,
                  cap: float = 1e-3) -> float:
    """ε-derived direction-quality target for the PCG-escalated
    H-solves of the ``exact_fallback=False`` path.

    Maps the solve's requested duality-gap tolerance to the L2-relative
    direction residual the escalation chases: τ = clamp(0.1·√ε, floor,
    cap) — a loose solve must not polish directions orders of magnitude
    past what ε needs."""
    return min(cap, max(floor, 0.1 * math.sqrt(epsilon)))


# ---------------------------------------------------------------------------
# Second-order-cone Jordan algebra, batched over the leading cone axis.
# Vectors live in R^{1+M} as (v0, v̄); J = diag(1, −I).
# ---------------------------------------------------------------------------


def _jmul(u, v):
    """Jordan product u∘v = (uᵀv; u₀v̄ + v₀ū), batched (K, 1+M)."""
    head = jnp.sum(u * v, axis=-1, keepdims=True)
    tail = u[..., :1] * v[..., 1:] + v[..., :1] * u[..., 1:]
    return jnp.concatenate([head, tail], axis=-1)


def _jdet(u):
    """det(u) = u₀² − ‖ū‖² (the cone residual), batched → (K,)."""
    return u[..., 0] ** 2 - jnp.sum(u[..., 1:] ** 2, axis=-1)


def _jreflect(u):
    """J u = (u₀; −ū)."""
    return jnp.concatenate([u[..., :1], -u[..., 1:]], axis=-1)


def _arrow_solve(lam, r):
    """Solve L_λ x = r where L_λ = [[λ₀, λ̄ᵀ], [λ̄, λ₀ I]] (the Jordan
    multiplication operator), batched.  Closed form via the 2×2 head
    system + Sherman–Morrison on the λ₀I block:
        x̄ = (r̄ − x₀ λ̄)/λ₀,   λ₀ x₀ + λ̄ᵀx̄ = r₀
        ⇒ x₀ = (λ₀ r₀ − λ̄ᵀr̄) / (λ₀² − ‖λ̄‖²) = (λ₀ r₀ − λ̄ᵀr̄)/det(λ)."""
    lam0 = lam[..., :1]
    lbar = lam[..., 1:]
    det = _jdet(lam)[..., None]
    x0 = (lam0 * r[..., :1]
          - jnp.sum(lbar * r[..., 1:], axis=-1, keepdims=True)) / det
    xbar = (r[..., 1:] - x0 * lbar) / lam0
    return jnp.concatenate([x0, xbar], axis=-1)


def nt_scaling(s, z):
    """NT scaling for each cone: returns (u, eta) where u = w^{1/2} is
    the Jordan square root of the normalized scaling point
    w = (s̄ + Jz̄)/(2γ), γ² = (1 + s̄ᵀz̄)/2, and η = sqrt(det s/det z).
    With Q_u v = 2(uᵀv)u − det(u)·Jv the quadratic representation
    (det u = 1 here), the scaling matrix is W = √η·Q_u and satisfies
    W z = W⁻¹ s = λ (the scaled point), W² = η·Q_w, Q_w z̄ = s̄ —
    identities checked in tests/test_socp_pd.py."""
    ds = _jdet(s)[..., None]
    dz = _jdet(z)[..., None]
    sb = s / jnp.sqrt(ds)
    zb = z / jnp.sqrt(dz)
    gamma = jnp.sqrt((1.0 + jnp.sum(sb * zb, axis=-1, keepdims=True)) / 2.0)
    w = (sb + _jreflect(zb)) / (2.0 * gamma)
    u0 = jnp.sqrt((w[..., :1] + 1.0) / 2.0)
    u = jnp.concatenate([u0, w[..., 1:] / (2.0 * u0)], axis=-1)
    eta = jnp.sqrt(ds / dz)
    return u, eta


def _hyp_mul(u, v):
    """Q_u v = 2(uᵀv)u − Jv for det(u) = 1 (unit hyperboloid), batched."""
    coef = 2.0 * jnp.sum(u * v, axis=-1, keepdims=True)
    return coef * u - _jreflect(v)


def w_mul(u, eta, v):
    """W v = √η · Q_u v."""
    return jnp.sqrt(eta) * _hyp_mul(u, v)


def w_inv_mul(u, eta, v):
    """W⁻¹ v = η^{−1/2} · Q_{u⁻¹} v, with u⁻¹ = Ju (det u = 1)."""
    return _hyp_mul(_jreflect(u), v) / jnp.sqrt(eta)


class SOCPPDResult(NamedTuple):
    x: jax.Array          # primal iterate
    y: jax.Array          # equality multipliers (zeros(0) when no F)
    z: jax.Array          # cone duals (K, 1+M)
    s: jax.Array          # cone slacks (K, 1+M)
    lam_ub: jax.Array     # upper-bound multipliers (masked)
    lam_lb: jax.Array     # lower-bound multipliers (masked)
    iters: jax.Array
    converged: jax.Array
    gap: jax.Array        # Σ s_kᵀz_k + Σ bound s·λ
    rp_norm: jax.Array
    rd_norm: jax.Array


def socp_pd_solve(G, h, q, x0, cfg, *, P=None, F=None, g=None,
                  lb=None, ub=None, max_iters=None,
                  exact_fallback=True) -> SOCPPDResult:
    """Conic Mehrotra predictor-corrector solve (module docstring).

    Args:
      G: (K, 1+M, n) stacked cone maps [c_kᵀ; A_k].
      h: (K, 1+M) stacked offsets [d_k; b_k].
      q: (n,) linear objective; ``P`` optional PSD quadratic term.
      F, g: optional equality pair (Schur elimination, factor reuse).
      lb, ub: optional (n,) bounds (±inf entries masked out).
      exact_fallback: whether the mixed-precision H-solves may fall back
        to a native f64 factorization when refinement stalls (the
        default).  ``False`` never factors H in f64: the direction
        solves then run PCG against the matrix-free operator with the
        f32 factor as preconditioner (see the comment at ``exact_fb``
        below).
    """
    dtype = G.dtype
    K, M1, n = G.shape
    has_P = P is not None
    has_eq = F is not None
    mixed = bool(cfg.mixed_precision) and dtype == jnp.float64
    if max_iters is None:
        max_iters = int(cfg.pd_max_iters)
    e = jnp.zeros((K, M1), dtype).at[:, 0].set(1.0)

    ub_v = (jnp.full((n,), jnp.inf, dtype) if ub is None else ub)
    lb_v = (jnp.full((n,), -jnp.inf, dtype) if lb is None else lb)
    fub = jnp.isfinite(ub_v).astype(dtype)
    flb = jnp.isfinite(lb_v).astype(dtype)
    ubf = jnp.where(fub > 0, ub_v, 0.0)
    lbf = jnp.where(flb > 0, lb_v, 0.0)
    # total complementarity degree: one per cone (s∘z = μe pins sᵀz = μ)
    # plus one per finite bound
    kcnt = jnp.asarray(K, dtype) + jnp.sum(fub) + jnp.sum(flb)

    # cone-Gram constant: GᵀJG = c_kc_kᵀ − A_kᵀA_k per cone (precomputed;
    # the per-iteration W⁻² assembly is rank-1 updates around it)
    jsign = jnp.concatenate([jnp.ones((1,), dtype),
                             -jnp.ones((M1 - 1,), dtype)])
    JG = jnp.einsum("m,kmn,kmo->kno", jsign, G, G, precision=_HIGHEST)

    gap_tol = jnp.asarray(cfg.epsilon, dtype)
    feas_tol = jnp.maximum(1e-9, jnp.minimum(1e-6, gap_tol))
    # dual-feasibility floors at 1e-8 relative: at gaps ≲ 1e-10 the
    # recomputed rd = q − Gᵀz (+…) carries NT-scaling roundoff that a
    # tighter test can never meet even though the iterate is optimal to
    # machine precision (measured: rd dips to ~1e-10 then floats at
    # ~1e-8 while the gap keeps closing)
    feas_tol_d = jnp.maximum(1e-8, feas_tol)
    h_scale = 1.0 + jnp.max(jnp.abs(h))
    if has_eq:
        h_scale = jnp.maximum(h_scale, 1.0 + jnp.max(jnp.abs(g)))
    h_scale = jnp.maximum(h_scale, 1.0 + jnp.max(
        jnp.abs(jnp.concatenate([ubf * fub, lbf * flb]))))
    q_scale = 1.0 + jnp.max(jnp.abs(q))

    # --- initialization ---------------------------------------------------
    x0 = x0.astype(dtype)
    u0 = jnp.einsum("kmn,n->km", G, x0, precision=_HIGHEST) + h
    lam_min = u0[:, 0] - jnp.linalg.norm(u0[:, 1:], axis=-1)
    shift = jnp.maximum(0.0, 0.1 * h_scale - lam_min)
    s0 = u0 + shift[:, None] * e
    z0 = e * jnp.maximum(1.0, 0.1 * q_scale)
    floor = 1e-4 * h_scale
    su0 = jnp.where(fub > 0, jnp.maximum(ubf - x0, floor), 1.0)
    lu0 = jnp.where(fub > 0, jnp.clip(1.0 / su0, 1e-6, 1e6), 0.0)
    sl0 = jnp.where(flb > 0, jnp.maximum(x0 - lbf, floor), 1.0)
    ll0 = jnp.where(flb > 0, jnp.clip(1.0 / sl0, 1e-6, 1e6), 0.0)
    y0 = jnp.zeros(F.shape[0] if has_eq else 0, dtype)

    # With the stall fallback off, Richardson refinement of the block
    # elimination is κ·eps32-limited and the late-stage DUAL residual
    # stalls ~1e-4 (the iterate closes the gap to 1e-15 while rd freezes,
    # burning the iteration budget unconverged).  So exact_fb=False uses
    # PCG-escalated accurate H-solves against the matrix-free h_op (f32
    # factor as preconditioner only, kkt.matrix_free_prepared_solve) and
    # a Schur-CG for the equality multipliers.
    exact_fb = bool(exact_fallback)
    if not exact_fb:
        from .kkt import matrix_free_prepare, matrix_free_prepared_solve
        mf_dir_tol = dir_stall_tol(float(cfg.epsilon), cap=1e-4)
        mf_cg_tol = max(1e-12, 1e-2 * mf_dir_tol)

    def prepare(H):
        return posdef_solver(H, mixed, exact_fallback=exact_fb)

    def body(st):
        (x, y, s, z, su, lu, sl, ll, it, *_) = st
        # residuals
        rd = q - jnp.einsum("kmn,km->n", G, z, precision=_HIGHEST) \
            + lu * fub - ll * flb
        if has_P:
            rd = rd + P @ x
        if has_eq:
            rd = rd + F.T @ y
        rp = jnp.einsum("kmn,n->km", G, x, precision=_HIGHEST) + h - s
        rpu = (x + su - ubf) * fub
        rpl = (-x + sl + lbf) * flb
        rpe = (F @ x - g) if has_eq else jnp.zeros(0, dtype)

        # NT scaling per cone; λ = W z = W⁻¹ s
        uw, eta = nt_scaling(s, z)
        w = _jmul(uw, uw)
        lam = w_mul(uw, eta, z)
        eta1 = eta[:, 0]

        # H = P + Σ (1/η)(2 q_k q_kᵀ − GᵀJG_k) + bound diag
        wt = _jreflect(w)                     # w⁻¹ (det w = 1)
        qk = jnp.einsum("kmn,km->kn", G, wt, precision=_HIGHEST)
        H = (2.0 * jnp.einsum("kn,ko->no", qk / eta1[:, None], qk,
                              precision=_HIGHEST)
             - jnp.einsum("k,kno->no", 1.0 / eta1, JG,
                          precision=_HIGHEST))
        db = fub * lu / su + flb * ll / sl
        H = H + jnp.diag(db)
        if has_P:
            H = H + P
        # no explicit jitter: a fixed trace-relative shift would scale
        # with the 1/μ-blowing bound diagonal and corrupt late
        # directions; robust_cholesky's escalating ladder (ops/kkt.py)
        # regularizes only when the factorization actually fails
        H = 0.5 * (H + H.T)
        solve_h = prepare(H)
        if not exact_fb:
            mf_fac = matrix_free_prepare(H, dtype)

            def solve_h_acc(bb):
                """Accurate H-solve without any f64 factor: f32 factor
                preconditioner + PCG escalation against the matrix-free
                true operator (ε-derived target)."""
                x_, _ = matrix_free_prepared_solve(
                    mf_fac, h_op, bb, rtol=mf_dir_tol)
                return x_
        if has_eq:
            Hinv_FT = solve_h(F.T)
            S = F @ Hinv_FT
            solve_s = prepare(0.5 * (S + S.T))

        def winv2(vv):
            """W⁻² v = (1/η)(2(w⁻¹ᵀv)w⁻¹ − Jv) per cone."""
            coef = 2.0 * jnp.sum(wt * vv, axis=-1, keepdims=True)
            return (coef * wt - _jreflect(vv)) / eta1[:, None]

        def h_op(dx):
            """Matrix-free H·dx (exactly the assembled H's action, in
            f64) for the true-residual refinement rounds."""
            out = jnp.einsum(
                "kmn,km->n", G,
                winv2(jnp.einsum("kmn,n->km", G, dx, precision=_HIGHEST)),
                precision=_HIGHEST) + db * dx
            if has_P:
                out = out + P @ dx
            return out

        def direction(dcomp, rcu, rcl):
            """Newton direction for complementarity targets: cone dcomp
            (K, 1+M), linear rcu/rcl (n,)."""
            t = -_arrow_solve(lam, dcomp)
            zc = w_inv_mul(uw, eta, t) - winv2(rp)
            r1 = (-rd + jnp.einsum("kmn,km->n", G, zc, precision=_HIGHEST)
                  + fub * (rcu - lu * rpu) / su
                  - flb * (rcl - ll * rpl) / sl)
            if has_eq and exact_fb:
                t1 = solve_h(r1)
                dy = solve_s(F @ t1 + rpe)
                dx = t1 - Hinv_FT @ dy
                # true-residual KKT refinement (factors reused): the
                # block elimination's κ(H)·eps error floors the dual
                # residual otherwise (same scheme as the row-sharded
                # barrier, parallel/distributed.py).  4 rounds: each is
                # matvec-cheap (h_op einsums + the reused factors).
                for _ in range(4):
                    e1 = r1 - (h_op(dx) + F.T @ dy)
                    e2 = -rpe - F @ dx
                    f = solve_s(F @ solve_h(e1) - e2)
                    dx = dx + solve_h(e1 - F.T @ f)
                    dy = dy + f
            elif has_eq:
                # exact_fb=False: Schur-CG.  Operator applications go
                # through the ACCURATE H-solves; the f32-grade solve_s
                # is only the preconditioner.
                # Richardson refinement of (dx, dy) diverges here once
                # κ(H)·eps32 > 1 (see the exact_fb comment above).
                t1 = solve_h_acc(r1)
                u = F @ t1 + rpe
                un = jnp.linalg.norm(u)

                def s_apply(y):
                    return F @ solve_h_acc(F.T @ y)

                def cg_cond(c):
                    i, y_, r_, z_, p_, rz_ = c
                    return ((i < 16)
                            & (jnp.linalg.norm(r_) > mf_cg_tol * un)
                            & jnp.isfinite(rz_))

                def cg_body(c):
                    i, y_, r_, z_, p_, rz_ = c
                    sp = s_apply(p_)
                    den = jnp.dot(p_, sp)
                    a = rz_ / jnp.where(jnp.abs(den) > 1e-300, den,
                                        1e-300)
                    y_ = y_ + a * p_
                    r_ = r_ - a * sp
                    z_ = solve_s(r_)
                    rz2 = jnp.dot(r_, z_)
                    beta = rz2 / jnp.where(jnp.abs(rz_) > 1e-300, rz_,
                                           1e-300)
                    return i + 1, y_, r_, z_, z_ + beta * p_, rz2

                z0_ = solve_s(u)
                _, dy, _, _, _, _ = lax.while_loop(
                    cg_cond, cg_body,
                    (jnp.zeros((), jnp.int32), jnp.zeros_like(u), u,
                     z0_, z0_, jnp.dot(u, z0_)))
                dx = solve_h_acc(r1 - F.T @ dy)
            else:
                dy = jnp.zeros(0, dtype)
                if exact_fb:
                    dx = solve_h(r1)
                    for _ in range(3):
                        dx = dx + solve_h(r1 - h_op(dx))
                else:
                    dx = solve_h_acc(r1)
            ds = jnp.einsum("kmn,n->km", G, dx, precision=_HIGHEST) + rp
            dz = w_inv_mul(uw, eta, t) - winv2(ds)
            dsu = (-rpu - dx) * fub
            dlu = jnp.where(fub > 0, (-rcu - lu * dsu) / su, 0.0)
            dsl = (-rpl + dx) * flb
            dll = jnp.where(flb > 0, (-rcl - ll * dsl) / sl, 0.0)
            return dx, dy, ds, dz, dsu, dlu, dsl, dll

        def gap_of(ss, zz, ssu, llu, ssl, lll):
            return (jnp.sum(ss * zz)
                    + jnp.sum(ssu * llu * fub) + jnp.sum(ssl * lll * flb))

        mu = gap_of(s, z, su, lu, sl, ll) / kcnt

        # predictor: dcomp = λ∘λ, linear rc = s·λ
        aff = direction(_jmul(lam, lam), su * lu * fub, sl * ll * flb)
        dx_a, dy_a, ds_a, dz_a, dsu_a, dlu_a, dsl_a, dll_a = aff
        ap_a = jnp.minimum(
            jnp.minimum(max_step_cone(s, ds_a), _max_step_lin(su, dsu_a)),
            _max_step_lin(sl, dsl_a))
        ad_a = jnp.minimum(
            jnp.minimum(max_step_cone(z, dz_a), _max_step_lin(lu, dlu_a)),
            _max_step_lin(ll, dll_a))
        mu_aff = gap_of(s + ap_a * ds_a, z + ad_a * dz_a,
                        su + ap_a * dsu_a, lu + ad_a * dlu_a,
                        sl + ap_a * dsl_a, ll + ad_a * dll_a) / kcnt
        sigma = jnp.clip((mu_aff / mu) ** 3, 0.0, 1.0)

        # corrector: dcomp = λ∘λ − σμe + (W⁻¹ds_aff)∘(W dz_aff)
        corr = _jmul(w_inv_mul(uw, eta, ds_a), w_mul(uw, eta, dz_a))
        dcomp = _jmul(lam, lam) - sigma * mu * e + corr
        rcu = (su * lu - sigma * mu + dsu_a * dlu_a) * fub
        rcl = (sl * ll - sigma * mu + dsl_a * dll_a) * flb
        dx, dy, ds, dz, dsu, dlu, dsl, dll = direction(dcomp, rcu, rcl)
        ap = _GAMMA * jnp.minimum(
            jnp.minimum(max_step_cone(s, ds), _max_step_lin(su, dsu)),
            _max_step_lin(sl, dsl))
        ad = _GAMMA * jnp.minimum(
            jnp.minimum(max_step_cone(z, dz), _max_step_lin(lu, dlu)),
            _max_step_lin(ll, dll))
        ap = jnp.minimum(1.0, ap)
        ad = jnp.minimum(1.0, ad)

        x2 = x + ap * dx
        y2 = y + ad * dy
        s2 = s + ap * ds
        z2 = z + ad * dz
        su2 = jnp.where(fub > 0, su + ap * dsu, 1.0)
        lu2 = lu + ad * dlu
        sl2 = jnp.where(flb > 0, sl + ap * dsl, 1.0)
        ll2 = ll + ad * dll

        rd2 = q - jnp.einsum("kmn,km->n", G, z2, precision=_HIGHEST) \
            + lu2 * fub - ll2 * flb
        if has_P:
            rd2 = rd2 + P @ x2
        if has_eq:
            rd2 = rd2 + F.T @ y2
        rp2 = jnp.einsum("kmn,n->km", G, x2, precision=_HIGHEST) + h - s2
        rpu2 = (x2 + su2 - ubf) * fub
        rpl2 = (-x2 + sl2 + lbf) * flb
        gap2 = gap_of(s2, z2, su2, lu2, sl2, ll2)
        rpn2 = jnp.maximum(jnp.max(jnp.abs(rp2)),
                           jnp.maximum(jnp.max(jnp.abs(rpu2)),
                                       jnp.max(jnp.abs(rpl2))))
        if has_eq:
            rpn2 = jnp.maximum(rpn2, jnp.max(jnp.abs(F @ x2 - g)))
        rdn2 = jnp.max(jnp.abs(rd2))
        stalled = (ap < _STALL_STEP) & (ad < _STALL_STEP)
        # non-finite guard: at μ ≈ machine precision the NT scaling's
        # cone determinants underflow to 0 and the step degenerates —
        # keep the previous (already-converged-to-f64) iterate and stop
        # instead of poisoning the state
        bad = ~(jnp.isfinite(gap2) & jnp.isfinite(rpn2)
                & jnp.isfinite(rdn2)
                & jnp.all(jnp.isfinite(x2)) & jnp.all(jnp.isfinite(z2)))
        keep = lambda new, old: jnp.where(bad, old, new)
        st_old = st
        return (keep(x2, st_old[0]), keep(y2, st_old[1]),
                keep(s2, st_old[2]), keep(z2, st_old[3]),
                keep(su2, st_old[4]), keep(lu2, st_old[5]),
                keep(sl2, st_old[6]), keep(ll2, st_old[7]), it + 1,
                keep(gap2, st_old[9]), keep(rpn2, st_old[10]),
                keep(rdn2, st_old[11]), stalled | bad)

    def cond(st):
        it, gap, rpn, rdn, stalled = st[8], st[9], st[10], st[11], st[12]
        done = ((gap < gap_tol) & (rpn < feas_tol * h_scale)
                & (rdn < feas_tol_d * q_scale))
        return (it < max_iters) & ~done & ~stalled & jnp.isfinite(gap)

    rd0 = q - jnp.einsum("kmn,km->n", G, z0, precision=_HIGHEST) \
        + lu0 * fub - ll0 * flb
    if has_P:
        rd0 = rd0 + P @ x0
    rp0 = u0 - s0
    rpn0 = jnp.max(jnp.abs(rp0))
    rpn0 = jnp.maximum(rpn0, jnp.max(jnp.abs((x0 + su0 - ubf) * fub)))
    rpn0 = jnp.maximum(rpn0, jnp.max(jnp.abs((-x0 + sl0 + lbf) * flb)))
    if has_eq:
        rpn0 = jnp.maximum(rpn0, jnp.max(jnp.abs(F @ x0 - g)))
    st0 = (x0, y0, s0, z0, su0, lu0, sl0, ll0, jnp.zeros((), jnp.int32),
           jnp.sum(s0 * z0) + jnp.sum(su0 * lu0 * fub)
           + jnp.sum(sl0 * ll0 * flb),
           rpn0, jnp.max(jnp.abs(rd0)), jnp.zeros((), bool))
    out = lax.while_loop(cond, body, st0)
    x, y, s, z, su, lu, sl, ll, it, gap, rpn, rdn, _ = out
    converged = ((gap < gap_tol) & (rpn < feas_tol * h_scale)
                 & (rdn < feas_tol_d * q_scale))
    return SOCPPDResult(x=x, y=y, z=z, s=s, lam_ub=lu, lam_lb=ll,
                        iters=it, converged=converged, gap=gap,
                        rp_norm=rpn, rd_norm=rdn)


def max_step_cone(s, ds):
    """Largest α ∈ (0, 1] with s + α·ds ∈ Q for every cone (s strictly
    interior).  Boundary when det(s+αds) = 0 or (s+αds)₀ = 0:
    det(s+αds) = det(s) + 2α⟨s, Jds⟩ + α²det(ds) — smallest positive
    root of the quadratic, per cone, reduced with a min."""
    a = _jdet(ds)
    b = 2.0 * jnp.sum(s * _jreflect(ds), axis=-1)
    c = _jdet(s)
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    # roots of a α² + b α + c = 0, taking care of the a→0 (linear) case
    r1 = jnp.where(jnp.abs(a) > 1e-300, (-b - sq) / (2.0 * a),
                   -c / jnp.where(jnp.abs(b) > 1e-300, b, -1e-300))
    r2 = jnp.where(jnp.abs(a) > 1e-300, (-b + sq) / (2.0 * a), jnp.inf)
    pos_roots = jnp.where((disc >= 0) & (r1 > 0), r1, jnp.inf)
    pos_roots = jnp.minimum(
        pos_roots, jnp.where((disc >= 0) & (r2 > 0), r2, jnp.inf))
    # head hitting zero
    h = jnp.where(ds[..., 0] < 0, -s[..., 0] / ds[..., 0], jnp.inf)
    alpha = jnp.minimum(jnp.min(pos_roots), jnp.min(h))
    return jnp.minimum(1.0, alpha)


def cone_operator(prob):
    """(G, h, q) for ``socp_pd_solve`` from a stacked SOCPProblem pytree:
    G_k = [c_kᵀ; A_k], h_k = [d_k; b_k].  Shared by the driver, the
    functional entry, and the batched path."""
    G = jnp.concatenate([prob.c[:, None, :], prob.A], axis=1)
    h = jnp.concatenate([prob.d[:, None], prob.b], axis=1)
    q = (prob.q if prob.q is not None
         else jnp.zeros((prob.n,), G.dtype))
    return G, h, q
