"""SOCP barrier oracles over stacked, padded cone tensors.

The reference evaluates slack/gradient/Hessian with a Python loop over cone
blocks, accumulating AᵢᵀAᵢ/sᵢ and outer-product terms one cone at a time
(reference: FunctionManager.py:933-994, 1055-1158) — the main per-cone
serialization called out in SURVEY.md §3.3.  Here all K cones live in
(K, M, n)/(K, M)/(K, n)/(K,) tensors (zero-padded rows are exact no-ops in
the ‖·‖² sums), so each oracle evaluation is a handful of batched einsums.

Barrier formulation: the reference uses the *squared-cone* slack
sᵢ = (cᵢᵀx + dᵢ)² − ‖Aᵢx + bᵢ‖², appending the raw rhs values to the slack
vector so the line-search domain check also enforces cᵢᵀx + dᵢ ≥ 0
(reference: FunctionManager.py:962-988).  The rhs entries are *not* part of
the barrier sum (constraint_indices excludes them,
FunctionManager.py:1042-1050).  We keep this formulation for behavioral
parity.

Hessian convention: the reference's curvature term adds +cᵢcᵢᵀ where the
analytic Hessian of −log(rhs²−‖lhs‖²) has −cᵢcᵢᵀ
(reference: FunctionManager.py:1132-1136).  The + sign keeps the matrix PSD
(a Gauss–Newton-style approximation) and is what the reference's observed
convergence behaviour reflects, so we reproduce it.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..utils import memory
from .barrier import Oracle, SLACK_EPS, SOCP_SLACK_EPS

# Cache per-cone AᵀA + ccᵀ (K, n, n) when it fits in this share of the
# device's memory; otherwise recompute the weighted sum per iteration from
# the stacked (K·M, n) matrix.  (reference always caches:
# FunctionManager.py:869-894.)
_CACHE_MEMORY_SHARE = 1 / 8


def _cone_contractions(prob, ata_cct):
    """(_Ax, _ATy, _curvature) closures — shared by the main and
    phase-one SOCP oracles."""

    def _Ax(x):
        """einsum('kmn,n->km') — the hot (K, M, n) contraction."""
        return jnp.einsum("kmn,n->km", prob.A, x)

    def _ATy(y):
        """einsum('kmn,km->kn')."""
        return jnp.einsum("kmn,km->kn", prob.A, y)

    def _curvature(w):
        return _weighted_curvature(prob, ata_cct, w)

    return _Ax, _ATy, _curvature


def _cone_parts(prob, x):
    lhs = jnp.einsum("kmn,n->km", prob.A, x) + prob.b      # (K, M)
    rhs = prob.c @ x + prob.d                               # (K,)
    slack = rhs**2 - jnp.sum(lhs**2, axis=-1)               # (K,)
    return lhs, rhs, slack


def _bound_slack_parts(prob, x):
    parts = []
    if prob.ub is not None:
        parts.append(prob.ub - x)
    if prob.lb is not None:
        parts.append(x - prob.lb)
    return parts


def socp_full_slacks(prob, x):
    """Full slack vector in reference order [cones, ub, lb, rhs]
    (reference: FunctionManager.py:962-988); used for dual recovery."""
    lhs, rhs, slack = _cone_parts(prob, x)
    parts = [slack] + _bound_slack_parts(prob, x) + [rhs]
    return jnp.concatenate([p.reshape(-1) for p in parts])


def _make_ata_cct(prob):
    """Σ-ready per-cone curvature blocks AᵀA + ccᵀ, or None when too large
    to cache (the weighted sum is then recomputed per iteration)."""
    K, M, n = prob.A.shape
    cache_bytes = K * n * n * prob.A.dtype.itemsize
    if cache_bytes <= _CACHE_MEMORY_SHARE * memory.device_bytes_limit():
        ata = jnp.einsum("kmn,kml->knl", prob.A, prob.A)
        cct = jnp.einsum("kn,kl->knl", prob.c, prob.c)
        return ata + cct
    return None


def _weighted_curvature(prob, ata_cct, w):
    """Σ_k w_k (A_kᵀA_k + c_k c_kᵀ) as one matmul."""
    if ata_cct is not None:
        return jnp.einsum("k,knl->nl", w, ata_cct)
    K, M, n = prob.A.shape
    scaled = jnp.sqrt(w)[:, None, None] * prob.A
    B = scaled.reshape(K * M, n)
    cw = jnp.sqrt(w)[:, None] * prob.c
    return B.T @ B + cw.T @ cw


def make_socp_oracle(prob) -> Oracle:
    n = prob.n
    bounded = prob.lb is not None or prob.ub is not None
    ata_cct = _make_ata_cct(prob)
    _Ax, _ATy, _curvature = _cone_contractions(prob, ata_cct)

    def _Px(x):
        return prob.P @ x

    def _parts(x):
        lhs = _Ax(x) + prob.b                                   # (K, M)
        rhs = prob.c @ x + prob.d                               # (K,)
        slack = rhs**2 - jnp.sum(lhs**2, axis=-1)               # (K,)
        return lhs, rhs, slack

    def obj(x):
        val = jnp.zeros((), dtype=x.dtype)
        if prob.P is not None:
            val = val + 0.5 * x @ _Px(x)
        if prob.q is not None:
            val = val + prob.q @ x
        return val

    def _lin_grad(x):
        g = jnp.zeros((n,), dtype=x.dtype)
        if prob.P is not None:
            g = g + _Px(x)
        if prob.q is not None:
            g = g + prob.q
        return g

    def _G(lhs, rhs):
        """Per-cone ∇slack/(-2) = A_kᵀ lhs_k − c_k rhs_k, stacked (K, n)
        (reference: FunctionManager.py:1125-1135 s_grad_term)."""
        return _ATy(lhs) - prob.c * rhs[:, None]

    def grad(x, t):
        lhs, rhs, slack = _parts(x)
        w = 2.0 / (slack + SOCP_SLACK_EPS)
        g = t * _lin_grad(x) + w @ _G(lhs, rhs)
        if prob.lb is not None:
            g = g - 1.0 / (x - prob.lb + SLACK_EPS)
        if prob.ub is not None:
            g = g + 1.0 / (prob.ub - x + SLACK_EPS)
        return g

    def hess(x, t):
        lhs, rhs, slack = _parts(x)
        w = 2.0 / (slack + SOCP_SLACK_EPS)
        H = _curvature(w)
        Gw = w[:, None] * _G(lhs, rhs)            # (K, n)
        H = H + Gw.T @ Gw                         # Σ_k outer(g_k, g_k)
        if prob.P is not None:
            H = H + t * prob.P
        if bounded:
            # SLACK_EPS here matches grad's bound guards: the eps in
            # d/dx[-log(s+eps)] = 1/(s+eps) must agree between the first
            # and second derivative or the line-search objective and the
            # Newton model describe slightly different barriers near the
            # boundary.
            db = jnp.zeros((n,), dtype=x.dtype)
            if prob.lb is not None:
                db = db + 1.0 / (x - prob.lb + SLACK_EPS) ** 2
            if prob.ub is not None:
                db = db + 1.0 / (prob.ub - x + SLACK_EPS) ** 2
            H = H + jnp.diag(db)
        return H

    def newton_obj(x, t):
        """Barrier sums cone + bound slacks only; the appended rhs entries
        are domain-only (reference: FunctionManager.py:1042-1050).
        Cone slacks use SOCP_SLACK_EPS, matching grad/hess."""
        _, _, slack = _parts(x)
        val = t * obj(x) - jnp.sum(jnp.log(slack + SOCP_SLACK_EPS))
        for p in _bound_slack_parts(prob, x):
            val = val - jnp.sum(jnp.log(p + SLACK_EPS))
        return val

    def min_slack(x):
        lhs, rhs, slack = _parts(x)
        parts = [slack] + _bound_slack_parts(prob, x) + [rhs]
        return jnp.min(jnp.concatenate([p.reshape(-1) for p in parts]))

    def _cands(x, dx, sigmas):
        """Quadratic-in-σ cone slacks plus affine bound slacks.

        slack(σ) = s0 + σ·p1 + σ²·p2 with p1 = 2(rhs·cdx − Σ lhs·lhsdx),
        p2 = cdx² − Σ lhsdx².
        """
        lhs, rhs, s0 = _parts(x)
        lhsdx = _Ax(dx)
        cdx = prob.c @ dx
        p1 = 2.0 * (rhs * cdx - jnp.sum(lhs * lhsdx, axis=-1))
        p2 = cdx**2 - jnp.sum(lhsdx**2, axis=-1)
        cone_cands = (s0[:, None] + sigmas[None, :] * p1[:, None]
                      + (sigmas**2)[None, :] * p2[:, None])     # (K, J)
        rhs_cands = rhs[:, None] + sigmas[None, :] * cdx[:, None]
        bound_cands = []
        if prob.ub is not None:
            bound_cands.append((prob.ub - x)[:, None]
                               - sigmas[None, :] * dx[:, None])
        if prob.lb is not None:
            bound_cands.append((x - prob.lb)[:, None]
                               + sigmas[None, :] * dx[:, None])
        ok = jnp.all(cone_cands > 0.0, axis=0) & jnp.all(rhs_cands > 0.0,
                                                         axis=0)
        for bc in bound_cands:
            ok = ok & jnp.all(bc > 0.0, axis=0)
        return ok, cone_cands, bound_cands, (lhs, rhs, lhsdx, cdx)

    def ls_grads(x, dx, t, sigmas):
        ok, cone_cands, bound_cands, (lhs, rhs, lhsdx, cdx) = _cands(
            x, dx, sigmas)
        J = sigmas.shape[0]
        W = 2.0 / (cone_cands + SOCP_SLACK_EPS)                # (K, J)
        G0 = _G(lhs, rhs)                                      # (K, n)
        G1 = jnp.einsum("kmn,km->kn", prob.A, lhsdx) - prob.c * cdx[:, None]
        grads = G0.T @ W + G1.T @ (W * sigmas[None, :])        # (n, J)
        g_lin = t * _lin_grad(x)
        grads = grads + g_lin[:, None]
        dlin = jnp.zeros((n,), dtype=x.dtype)
        if prob.P is not None:
            dlin = t * _Px(dx)
        grads = grads + sigmas[None, :] * dlin[:, None]
        it = iter(bound_cands)
        if prob.ub is not None:
            grads = grads + 1.0 / (next(it) + SLACK_EPS)
        if prob.lb is not None:
            grads = grads - 1.0 / (next(it) + SLACK_EPS)
        return ok, grads

    def ls_objs(x, dx, t, sigmas):
        ok, cone_cands, bound_cands, _ = _cands(x, dx, sigmas)
        f0 = obj(x)
        lin_term = _lin_grad(x) @ dx
        vals = t * (f0 + sigmas * lin_term)
        if prob.P is not None:
            vals = vals + t * (0.5 * (dx @ _Px(dx))) * sigmas**2
        vals = vals - jnp.sum(jnp.log(cone_cands + SOCP_SLACK_EPS), axis=0)
        for bc in bound_cands:
            vals = vals - jnp.sum(jnp.log(bc + SLACK_EPS), axis=0)
        return ok, vals

    return Oracle(n=n, diag_hessian=False, obj=obj, grad=grad, hess=hess,
                  newton_obj=newton_obj, min_slack=min_slack,
                  ls_grads=ls_grads, ls_objs=ls_objs)


def make_phase1_socp_oracle(prob) -> Oracle:
    """Phase-one oracle over z = [x, s]: min s s.t. squared-cone and bound
    slacks + s ≥ 0 (reference: FunctionManagerSOCPPhase1 at
    FunctionManager.py:1165-1460).

    Parity note: the reference leaves the appended rhs entries unshifted
    and domain-only (FunctionManager.py:1258-1262 adds s to
    constraint_indices only), so its phase one cannot start from any x0
    with cᵢᵀx + dᵢ < 0.  We deviate deliberately: phase one treats
    rhsᵢ + s ≥ 0 as REAL barrier constraints (−log(rhsᵢ+s) terms with
    matching gradient/Hessian blocks).  Every start is then valid, the
    iterate cannot park on the rhs boundary (a domain-only shift stalls
    there — measured), and any s < 0 exit still certifies
    cᵢᵀx + dᵢ > −s > 0 for the main solve's squared-cone barrier.
    """
    n = prob.n
    ata_cct = _make_ata_cct(prob)
    _Ax, _ATy, _curvature = _cone_contractions(prob, ata_cct)

    def _parts(z):
        x, s = z[:-1], z[-1]
        lhs = _Ax(x) + prob.b
        rhs = prob.c @ x + prob.d
        slack = rhs**2 - jnp.sum(lhs**2, axis=-1)
        cone_sl = slack + s
        bound_sl = [p + s for p in _bound_slack_parts(prob, x)]
        return x, s, lhs, rhs, cone_sl, bound_sl

    def obj(z):
        return z[-1]

    def _G(lhs, rhs):
        return _ATy(lhs) - prob.c * rhs[:, None]

    def grad(z, t):
        x, s, lhs, rhs, cone_sl, bound_sl = _parts(z)
        inv_cone = 1.0 / (cone_sl + SLACK_EPS)
        w = 2.0 * inv_cone
        inv_rhs = 1.0 / (rhs + s + SLACK_EPS)                 # (K,)
        gx = w @ _G(lhs, rhs) - inv_rhs @ prob.c
        inv_sum = jnp.sum(inv_cone) + jnp.sum(inv_rhs)
        it = iter(bound_sl)
        if prob.ub is not None:
            iu = 1.0 / (next(it) + SLACK_EPS)
            gx = gx + iu
            inv_sum = inv_sum + jnp.sum(iu)
        if prob.lb is not None:
            il = 1.0 / (next(it) + SLACK_EPS)
            gx = gx - il
            inv_sum = inv_sum + jnp.sum(il)
        gs = t - inv_sum
        return jnp.concatenate([gx, gs[None]])

    def hess(z, t):
        x, s, lhs, rhs, cone_sl, bound_sl = _parts(z)
        dtype = z.dtype
        inv_cone = 1.0 / (cone_sl + SLACK_EPS)
        w = 2.0 * inv_cone
        Hxx = _curvature(w)
        Gw = w[:, None] * _G(lhs, rhs)
        Hxx = Hxx + Gw.T @ Gw
        # h_xs = −Σ_k inv_k · (w_k G_k)  (reference: FunctionManager.py:1415)
        hxs = -(inv_cone @ Gw)
        hss = jnp.sum(inv_cone**2)
        # rhs + s barrier blocks: ∇²(−log(rhs_k+s)) contributes
        # c_k c_kᵀ / u², c_k / u², 1 / u² with u = rhs_k + s.
        inv_rhs = 1.0 / (rhs + s + SLACK_EPS)
        Cw = inv_rhs[:, None] * prob.c                        # (K, n)
        Hxx = Hxx + Cw.T @ Cw
        hxs = hxs + inv_rhs**2 @ prob.c
        hss = hss + jnp.sum(inv_rhs**2)
        db = jnp.zeros((n,), dtype=dtype)
        it = iter(bound_sl)
        if prob.ub is not None:
            iu2 = (1.0 / (next(it) + SLACK_EPS)) ** 2
            db = db + iu2
            hxs = hxs - iu2
            hss = hss + jnp.sum(iu2)
        if prob.lb is not None:
            il2 = (1.0 / (next(it) + SLACK_EPS)) ** 2
            db = db + il2
            hxs = hxs + il2
            hss = hss + jnp.sum(il2)
        Hxx = Hxx + jnp.diag(db)
        top = jnp.concatenate([Hxx, hxs[:, None]], axis=1)
        bot = jnp.concatenate([hxs, hss[None]])[None, :]
        return jnp.concatenate([top, bot], axis=0)

    def newton_obj(z, t):
        x, s, lhs, rhs, cone_sl, bound_sl = _parts(z)
        val = t * s - jnp.sum(jnp.log(cone_sl + SLACK_EPS))
        val = val - jnp.sum(jnp.log(rhs + s + SLACK_EPS))
        for p in bound_sl:
            val = val - jnp.sum(jnp.log(p + SLACK_EPS))
        return val

    def min_slack(z):
        x, s, lhs, rhs, cone_sl, bound_sl = _parts(z)
        # The domain-only rhs entries are shifted by s here (deviation
        # from the reference, whose phase one keeps them unshifted and
        # therefore cannot start from any x0 with cᵢᵀx+dᵢ < 0 —
        # FunctionManager.py:1258-1262).  Shifting enlarges the basin:
        # s0 = −min_slack+1 makes the start valid, and any exit with
        # s < 0 still certifies rhs = (rhs+s) − s > 0.
        parts = [cone_sl] + bound_sl + [rhs + s]
        return jnp.min(jnp.concatenate([p.reshape(-1) for p in parts]))

    def ls_objs(z, dz, t, sigmas):
        x, s, lhs, rhs, cone_sl, bound_sl = _parts(z)
        dx, dsg = dz[:-1], dz[-1]
        lhsdx = _Ax(dx)
        cdx = prob.c @ dx
        p1 = 2.0 * (rhs * cdx - jnp.sum(lhs * lhsdx, axis=-1)) + dsg
        p2 = cdx**2 - jnp.sum(lhsdx**2, axis=-1)
        cone_cands = (cone_sl[:, None] + sigmas[None, :] * p1[:, None]
                      + (sigmas**2)[None, :] * p2[:, None])
        # rhs + s domain entries, shifted like min_slack (see above).
        rhs_cands = ((rhs + s)[:, None]
                     + sigmas[None, :] * (cdx + dsg)[:, None])
        ok = jnp.all(cone_cands > 0.0, axis=0) & jnp.all(rhs_cands > 0.0,
                                                         axis=0)
        vals = t * (s + sigmas * dsg)
        vals = vals - jnp.sum(jnp.log(cone_cands + SLACK_EPS), axis=0)
        vals = vals - jnp.sum(jnp.log(rhs_cands + SLACK_EPS), axis=0)
        bound_d = []
        if prob.ub is not None:
            bound_d.append(-dx)
        if prob.lb is not None:
            bound_d.append(dx)
        for p, dp in zip(bound_sl, bound_d):
            bc = p[:, None] + sigmas[None, :] * (dp + dsg)[:, None]
            ok = ok & jnp.all(bc > 0.0, axis=0)
            vals = vals - jnp.sum(jnp.log(bc + SLACK_EPS), axis=0)
        return ok, vals

    def ls_grads(z, dz, t, sigmas):
        raise NotImplementedError("SOCP phase-1 uses the feasible-start engine")

    return Oracle(n=n + 1, diag_hessian=False, obj=obj, grad=grad, hess=hess,
                  newton_obj=newton_obj, min_slack=min_slack,
                  ls_grads=ls_grads, ls_objs=ls_objs)
