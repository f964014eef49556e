"""Cone-sharded distributed conic Mehrotra solve.

The multi-chip form of ops/socp_pd.py (as parallel/pd_dist.py is to
ops/pd.py): the stacked cone tensors are sharded on the CONE axis, each
chip runs the Jordan/NT algebra for its cones locally (scalings, arrow
solves, step-to-boundary quadratics — embarrassingly parallel), and the
collectives are ``psum`` at the H/gradient/gap reduction points plus a
``pmax`` for the global step lengths — the same layout as the
cone-sharded barrier (`socp_dist._cone_sharded_barrier`) at a 10-30×
lower iteration count.

Padded cones (A=0, b=0, c=0, d=1 — `socp_dist._pad_cones`) are genuine
trivial cones: their slack pins at e, their dual converges to σμ·e → 0
with the gap, and they contribute zero to every reduction that matters;
they ARE counted in the complementarity degree (kcnt), which only
rescales μ by Kp/K.

Entry point: ``solve_socp_pd_cone_sharded``, or ``algorithm="pd"`` on
``solve_socp_cone_sharded``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.socp_pd import (_arrow_solve, _jmul, _jreflect, max_step_cone,
                           nt_scaling, w_inv_mul, w_mul)
from ..ops.pd import _max_step as _max_step_lin
from .distributed import make_factor_tools
from .socp_dist import _pad_cones, shard_cones
from ..utils.precision import highest_precision

_GAMMA = 0.99
_STALL_STEP = 1e-10


def _cone_sharded_pd(mesh: Mesh, axis: str, *, m_true: int, Kp: int,
                     eps: float, max_iters: int, has_P: bool,
                     has_q: bool, distributed_factor=False,
                     factor_dtype: str = "float64",
                     chol_block: int = 256, ndev: int = 1):
    """Build the jitted shard_map predictor-corrector program (see the
    module docstring)."""
    mixed = factor_dtype == "float32"
    _make_solve = make_factor_tools(axis, ndev, distributed_factor,
                                    chol_block)

    def prog(qv, Pm, A, b, cv, d, F, g_eq, lb, ub, x0):
        dtype = x0.dtype
        n = x0.shape[0]
        Kl, M = A.shape[0], A.shape[1]
        G = jnp.concatenate([cv[:, None, :], A], axis=1)   # (Kl, 1+M, n)
        h = jnp.concatenate([d[:, None], b], axis=1)       # (Kl, 1+M)
        M1 = M + 1
        e = jnp.zeros((Kl, M1), dtype).at[:, 0].set(1.0)
        jsign = jnp.concatenate([jnp.ones((1,), dtype),
                                 -jnp.ones((M,), dtype)])
        JG = jnp.einsum("m,kmn,kmo->kno", jsign, G, G)
        mg = F.shape[0]
        pad_diag = (jnp.arange(mg) >= m_true).astype(dtype)

        psum = lambda u: lax.psum(u, axis)
        pmin = lambda u: -lax.pmax(-u, axis)

        q = qv if has_q else jnp.zeros((n,), dtype)
        fub = jnp.isfinite(ub).astype(dtype)
        flb = jnp.isfinite(lb).astype(dtype)
        ubf = jnp.where(fub > 0, ub, 0.0)
        lbf = jnp.where(flb > 0, lb, 0.0)
        kcnt = (jnp.asarray(Kp, dtype) + jnp.sum(fub) + jnp.sum(flb))

        gap_tol = jnp.asarray(eps, dtype)
        feas_tol = jnp.maximum(1e-9, jnp.minimum(1e-6, gap_tol))
        # dual tolerance floors at 1e-8 relative (NT-scaling roundoff in
        # the recomputed rd at machine-precision gaps; see ops/socp_pd.py)
        feas_tol_d = jnp.maximum(1e-8, feas_tol)
        h_scale = 1.0 + lax.pmax(jnp.max(jnp.abs(h)), axis)
        h_scale = jnp.maximum(
            h_scale, 1.0 + jnp.max(jnp.abs(g_eq)))
        h_scale = jnp.maximum(h_scale, 1.0 + jnp.max(
            jnp.abs(jnp.concatenate([ubf * fub, lbf * flb]))))
        q_scale = 1.0 + jnp.max(jnp.abs(q))

        # --- initialization (ops/socp_pd.py semantics) -------------------
        u0 = jnp.einsum("kmn,n->km", G, x0) + h
        lam_min = u0[:, 0] - jnp.linalg.norm(u0[:, 1:], axis=-1)
        shift = jnp.maximum(0.0, 0.1 * h_scale - lam_min)
        s0 = u0 + shift[:, None] * e
        z0 = e * jnp.maximum(1.0, 0.1 * q_scale)
        floor = 1e-4 * h_scale
        su0 = jnp.where(fub > 0, jnp.maximum(ubf - x0, floor), 1.0)
        lu0 = jnp.where(fub > 0, jnp.clip(1.0 / su0, 1e-6, 1e6), 0.0)
        sl0 = jnp.where(flb > 0, jnp.maximum(x0 - lbf, floor), 1.0)
        ll0 = jnp.where(flb > 0, jnp.clip(1.0 / sl0, 1e-6, 1e6), 0.0)
        y0 = jnp.zeros((mg,), dtype)

        def gap_of(s, z, su, lu, sl, ll):
            return (psum(jnp.sum(s * z))
                    + jnp.sum(su * lu * fub) + jnp.sum(sl * ll * flb))

        def body(st):
            (x, y, s, z, su, lu, sl, ll, it, *_) = st
            rd = q - psum(jnp.einsum("kmn,km->n", G, z)) \
                + lu * fub - ll * flb + F.T @ y
            if has_P:
                rd = rd + Pm @ x
            rp = jnp.einsum("kmn,n->km", G, x) + h - s
            rpu = (x + su - ubf) * fub
            rpl = (-x + sl + lbf) * flb
            rpe = F @ x - g_eq

            uw, eta = nt_scaling(s, z)
            w = _jmul(uw, uw)
            lam = w_mul(uw, eta, z)
            eta1 = eta[:, 0]
            wt = _jreflect(w)
            qk = jnp.einsum("kmn,km->kn", G, wt)
            H = psum(2.0 * jnp.einsum("kn,ko->no", qk / eta1[:, None], qk)
                     - jnp.einsum("k,kno->no", 1.0 / eta1, JG))
            db = fub * lu / su + flb * ll / sl
            H = H + jnp.diag(db)
            if has_P:
                H = H + Pm
            H = 0.5 * (H + H.T)
            # factor-only per-row relative regularization (see
            # parallel/pd_dist.py); the true operator h_op is unshifted
            H_fac = H + jnp.diag(1e-13 * jnp.abs(jnp.diag(H)) + 1e-30)

            def winv2(vv):
                coef = 2.0 * jnp.sum(wt * vv, axis=-1, keepdims=True)
                return (coef * wt - _jreflect(vv)) / eta1[:, None]

            def h_op(dx):
                out = psum(jnp.einsum(
                    "kmn,km->n", G,
                    winv2(jnp.einsum("kmn,n->km", G, dx)))) + db * dx
                if has_P:
                    out = out + Pm @ dx
                return out

            def make_dir(f32_factor):
                solve = _make_solve(H_fac, dtype, f32_factor)
                Hinv_FT = solve(F.T)
                S = F @ Hinv_FT
                S = 0.5 * (S + S.T)
                S = S + jnp.diag(pad_diag
                                 + 1e-13 * jnp.max(jnp.diag(S)))
                solve_S = _make_solve(S, dtype, f32_factor)

                def direction(r1, r2):
                    t1 = solve(r1)
                    dy = solve_S(F @ t1 - r2)
                    dx = t1 - Hinv_FT @ dy
                    for _ in range(3 if f32_factor else 2):
                        e1 = r1 - (h_op(dx) + F.T @ dy)
                        e2 = r2 - F @ dx
                        f = solve_S(F @ solve(e1) - e2)
                        dx = dx + solve(e1 - F.T @ f)
                        dy = dy + f
                    return dx, dy
                return direction

            if mixed:
                dir32 = make_dir(True)

                def direction(r1, r2):
                    dx, dy = dir32(r1, r2)
                    e1 = r1 - (h_op(dx) + F.T @ dy)
                    e2 = r2 - F @ dx
                    ok = (jnp.sum(e1**2) + jnp.sum(e2**2)) \
                        < 1e-16 * (jnp.sum(r1**2) + jnp.sum(r2**2)
                                   + jnp.asarray(1e-300, dtype))
                    return lax.cond(ok, lambda _: (dx, dy),
                                    lambda _: make_dir(False)(r1, r2),
                                    None)
            else:
                direction = make_dir(False)

            def full_dir(dcomp, rcu, rcl):
                t = -_arrow_solve(lam, dcomp)
                zc = w_inv_mul(uw, eta, t) - winv2(rp)
                r1 = (-rd + psum(jnp.einsum("kmn,km->n", G, zc))
                      + fub * (rcu - lu * rpu) / su
                      - flb * (rcl - ll * rpl) / sl)
                dx, dy = direction(r1, -rpe)
                ds = jnp.einsum("kmn,n->km", G, dx) + rp
                dz = w_inv_mul(uw, eta, t) - winv2(ds)
                dsu = (-rpu - dx) * fub
                dlu = jnp.where(fub > 0, (-rcu - lu * dsu) / su, 0.0)
                dsl = (-rpl + dx) * flb
                dll = jnp.where(flb > 0, (-rcl - ll * dsl) / sl, 0.0)
                return dx, dy, ds, dz, dsu, dlu, dsl, dll

            mu = gap_of(s, z, su, lu, sl, ll) / kcnt

            aff = full_dir(_jmul(lam, lam), su * lu * fub, sl * ll * flb)
            dx_a, dy_a, ds_a, dz_a, dsu_a, dlu_a, dsl_a, dll_a = aff
            ap_a = jnp.minimum(pmin(max_step_cone(s, ds_a)), jnp.minimum(
                _max_step_lin(su, dsu_a), _max_step_lin(sl, dsl_a)))
            ad_a = jnp.minimum(pmin(max_step_cone(z, dz_a)), jnp.minimum(
                _max_step_lin(lu, dlu_a), _max_step_lin(ll, dll_a)))
            mu_aff = gap_of(s + ap_a * ds_a, z + ad_a * dz_a,
                            su + ap_a * dsu_a, lu + ad_a * dlu_a,
                            sl + ap_a * dsl_a, ll + ad_a * dll_a) / kcnt
            sigma = jnp.clip((mu_aff / mu) ** 3, 0.0, 1.0)

            corr = _jmul(w_inv_mul(uw, eta, ds_a), w_mul(uw, eta, dz_a))
            dcomp = _jmul(lam, lam) - sigma * mu * e + corr
            rcu = (su * lu - sigma * mu + dsu_a * dlu_a) * fub
            rcl = (sl * ll - sigma * mu + dsl_a * dll_a) * flb
            dx, dy, ds, dz, dsu, dlu, dsl, dll = full_dir(dcomp, rcu, rcl)
            ap = jnp.minimum(1.0, _GAMMA * jnp.minimum(
                pmin(max_step_cone(s, ds)), jnp.minimum(
                    _max_step_lin(su, dsu), _max_step_lin(sl, dsl))))
            ad = jnp.minimum(1.0, _GAMMA * jnp.minimum(
                pmin(max_step_cone(z, dz)), jnp.minimum(
                    _max_step_lin(lu, dlu), _max_step_lin(ll, dll))))

            x2 = x + ap * dx
            y2 = y + ad * dy
            s2 = s + ap * ds
            z2 = z + ad * dz
            su2 = jnp.where(fub > 0, su + ap * dsu, 1.0)
            lu2 = lu + ad * dlu
            sl2 = jnp.where(flb > 0, sl + ap * dsl, 1.0)
            ll2 = ll + ad * dll

            rd2 = q - psum(jnp.einsum("kmn,km->n", G, z2)) \
                + lu2 * fub - ll2 * flb + F.T @ y2
            if has_P:
                rd2 = rd2 + Pm @ x2
            rp2 = jnp.einsum("kmn,n->km", G, x2) + h - s2
            gap2 = gap_of(s2, z2, su2, lu2, sl2, ll2)
            rpn2 = lax.pmax(jnp.max(jnp.abs(rp2)), axis)
            rpn2 = jnp.maximum(rpn2, jnp.max(jnp.abs(
                (x2 + su2 - ubf) * fub)))
            rpn2 = jnp.maximum(rpn2, jnp.max(jnp.abs(
                (-x2 + sl2 + lbf) * flb)))
            rpn2 = jnp.maximum(rpn2, jnp.max(jnp.abs(F @ x2 - g_eq)))
            rdn2 = jnp.max(jnp.abs(rd2))
            stalled = (ap < _STALL_STEP) & (ad < _STALL_STEP)
            bad = ~(jnp.isfinite(gap2) & jnp.isfinite(rpn2)
                    & jnp.isfinite(rdn2) & jnp.all(jnp.isfinite(x2)))
            keep = lambda new, old: jnp.where(bad, old, new)
            return (keep(x2, st[0]), keep(y2, st[1]), keep(s2, st[2]),
                    keep(z2, st[3]), keep(su2, st[4]), keep(lu2, st[5]),
                    keep(sl2, st[6]), keep(ll2, st[7]), it + 1,
                    keep(gap2, st[9]), keep(rpn2, st[10]),
                    keep(rdn2, st[11]), stalled | bad)

        def cond(st):
            it, gap, rpn, rdn, stalled = (st[8], st[9], st[10], st[11],
                                          st[12])
            done = ((gap < gap_tol) & (rpn < feas_tol * h_scale)
                    & (rdn < feas_tol_d * q_scale))
            return (it < max_iters) & ~done & ~stalled & jnp.isfinite(gap)

        rd0 = q - psum(jnp.einsum("kmn,km->n", G, z0)) \
            + lu0 * fub - ll0 * flb
        if has_P:
            rd0 = rd0 + Pm @ x0
        rp0 = u0 - s0
        rpn0 = lax.pmax(jnp.max(jnp.abs(rp0)), axis)
        rpn0 = jnp.maximum(rpn0, jnp.max(jnp.abs(F @ x0 - g_eq)))
        st0 = (x0, y0, s0, z0, su0, lu0, sl0, ll0,
               jnp.zeros((), jnp.int32),
               gap_of(s0, z0, su0, lu0, sl0, ll0),
               rpn0, jnp.max(jnp.abs(rd0)), jnp.zeros((), bool))
        out = lax.while_loop(cond, body, st0)
        x, y, s, z, su, lu, sl, ll, it, gap, rpn, rdn, _ = out
        converged = ((gap < gap_tol) & (rpn < feas_tol * h_scale)
                     & (rdn < feas_tol_d * q_scale))
        obj = (q @ x if has_q else 0.0) \
            + (0.5 * x @ (Pm @ x) if has_P else 0.0)
        z_g = lax.all_gather(z, axis, axis=0, tiled=True)
        return x, y, obj, it, gap, converged, z_g, lu, ll

    spec_cones = lambda nd: P(axis, *([None] * (nd - 1)))
    rep = P()
    return jax.jit(shard_map(
        highest_precision(prog), mesh=mesh,
        in_specs=(rep, rep, spec_cones(3), spec_cones(2), spec_cones(2),
                  spec_cones(1), rep, rep, rep, rep, rep),
        out_specs=(rep,) * 9,
        check_vma=False,
    ))


def solve_socp_pd_cone_sharded(mesh: Mesh, A, b, c, d, P_obj=None, q=None,
                               F=None, g=None, lb=None, ub=None, *,
                               x0=None, epsilon=1e-8, max_iters: int = 60,
                               axis: str = "cones",
                               distributed_factor=False,
                               factor_dtype: str = "float64",
                               chol_block: int = 256):
    """Distributed conic Mehrotra solve with the cone axis sharded:
    min ½xᵀPx + qᵀx s.t. ‖A_k x + b_k‖ ≤ c_kᵀx + d_k, Fx = g, bounds.

    Infeasible-start (no phase one: a cone-infeasible x0 enters via the
    shifted slack initialization); K need not divide the mesh.  Returns
    a dict with x, y (equality multipliers), z (conic duals, (K, 1+M)),
    lam_ub/lam_lb, objective, iterations, gap, converged.
    """
    from ..models.base import ensure_x64

    ensure_x64("float64")
    ndev = mesh.shape[axis]
    A = jnp.asarray(A, jnp.float64)
    dtype = A.dtype
    K, M, n = A.shape
    b = jnp.asarray(b, dtype)
    c = jnp.asarray(c, dtype)
    d = jnp.asarray(d, dtype)

    Kp = -(-K // ndev) * ndev
    A_p, b_p, c_p, d_p = _pad_cones(A, b, c, d, Kp)

    has_F = F is not None
    m_true = F.shape[0] if has_F else 0
    mg = max(m_true, 1)
    F_p = jnp.zeros((mg, n), dtype)
    g_p = jnp.zeros((mg,), dtype)
    if has_F:
        F_p = F_p.at[:m_true].set(jnp.asarray(F, dtype))
        g_p = g_p.at[:m_true].set(jnp.asarray(g, dtype))

    lb_v = (jnp.full((n,), -jnp.inf, dtype) if lb is None
            else jnp.broadcast_to(jnp.asarray(lb, dtype), (n,)))
    ub_v = (jnp.full((n,), jnp.inf, dtype) if ub is None
            else jnp.broadcast_to(jnp.asarray(ub, dtype), (n,)))
    if x0 is None:
        x0 = jnp.zeros((n,), dtype)
        if lb is not None and ub is not None:
            x0 = 0.5 * (lb_v + ub_v)
    x0 = jnp.asarray(x0, dtype)

    has_P = P_obj is not None
    has_q = q is not None
    Pm = jnp.asarray(P_obj, dtype) if has_P else jnp.zeros((1, 1), dtype)
    qv = jnp.asarray(q, dtype) if has_q else jnp.zeros((1,), dtype)

    prog = _cone_sharded_pd(
        mesh, axis, m_true=m_true, Kp=Kp, eps=float(epsilon),
        max_iters=int(max_iters), has_P=has_P, has_q=has_q,
        distributed_factor=bool(distributed_factor),
        factor_dtype=factor_dtype, chol_block=int(chol_block), ndev=ndev)

    x, y, obj, it, gap, conv, z_g, lu, ll = prog(
        qv, Pm, shard_cones(mesh, A_p, axis), shard_cones(mesh, b_p, axis),
        shard_cones(mesh, c_p, axis), shard_cones(mesh, d_p, axis),
        F_p, g_p, lb_v, ub_v, x0)

    import numpy as np

    it = int(it)
    y_true = np.asarray(y)[:m_true]
    return dict(x=x, y=y_true, objective=float(obj),
                iterations=it, gap=float(gap),
                converged=bool(conv), z=np.asarray(z_g)[:K],
                lam_ub=(np.asarray(lu) if ub is not None else None),
                lam_lb=(np.asarray(ll) if lb is not None else None),
                # barrier-result aliases so callers dispatching via
                # solve_socp_cone_sharded(algorithm="pd") keep working
                v=y_true, outer_iters=it, newton_iters=it)
