"""Distributed primal-dual Mehrotra solve: constraint rows sharded.

The multi-chip form of ops/pd.py (new capability — the reference suite
is single-device and barrier-only): one huge LP/QP instance with the
inequality rows C and equality rows A sharded over a mesh axis, and the
WHOLE predictor-corrector iteration as one jitted ``shard_map`` program.
Per iteration the collectives are the same pattern as the row-sharded
barrier (`parallel/distributed.py:_row_sharded_barrier`) — partial
Hessian ``psum``, Schur panels ``all_gather``, step-length ``pmax`` —
but the iteration count is 15–40 instead of the barrier's 70–150 Newton
steps, so total communication volume drops proportionally.

Bounds enter as replicated diagonal slack/multiplier segments (not
stacked rows): their Hessian contribution is a diagonal, their
complementarity terms are elementwise, and ±inf bounds are masked out
(vacuous constraints carry s = 1, λ = 0 and contribute nothing).

Entry points: ``solve_pd_row_sharded`` here, or
``solve_lp_row_sharded(..., algorithm="pd")`` /
``solve_qp_row_sharded(..., algorithm="pd")`` in
``parallel.distributed``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .distributed import _pad_rows, make_factor_tools, shard_rows
from ..utils.precision import highest_precision

_GAMMA = 0.99995
_STALL_STEP = 1e-10


def _row_sharded_pd(mesh: Mesh, axis: str, *, m_true: int, k_true: int,
                    eps: float, max_iters: int, has_P: bool,
                    distributed_factor=False, factor_dtype: str = "float64",
                    chol_block: int = 256, ndev: int = 1):
    """Build the jitted shard_map predictor-corrector program.

    Row padding follows the barrier program's convention: padded C rows
    are zero with d = 1 (their slack pins at 1 with λ = 0 — an exact
    fixed point of the iteration), padded A rows are zero with b = 0
    and +1 on the Schur diagonal.
    """
    mixed = factor_dtype == "float32"
    _make_solve = make_factor_tools(axis, ndev, distributed_factor,
                                    chol_block)

    def prog(c, Pm, A, b, C, d, lb, ub, x0):
        dtype = x0.dtype
        k_local, m_local = C.shape[0], A.shape[0]
        idx_m = lax.axis_index(axis) * m_local
        row0 = lax.axis_index(axis) * k_local
        mask = (row0 + jnp.arange(k_local) < k_true).astype(dtype)
        fub = jnp.isfinite(ub).astype(dtype)
        flb = jnp.isfinite(lb).astype(dtype)
        # finite bound values for arithmetic; masked terms are zeroed
        ubf = jnp.where(fub > 0, ub, 0.0)
        lbf = jnp.where(flb > 0, lb, 0.0)
        kcnt = (jnp.asarray(k_true, dtype) + jnp.sum(fub) + jnp.sum(flb))

        gather0 = lambda u: lax.all_gather(u, axis, axis=0, tiled=True)
        pmax = lambda u: lax.pmax(u, axis)
        psum = lambda u: lax.psum(u, axis)

        d_max = pmax(jnp.max(jnp.abs(d * mask))) if k_local else 0.0
        b_max = pmax(jnp.max(jnp.abs(b))) if m_local else 0.0
        bscale = jnp.max(jnp.abs(jnp.concatenate(
            [ubf * fub, lbf * flb])))
        d_scale = 1.0 + jnp.maximum(jnp.maximum(d_max, b_max), bscale)
        q_scale = 1.0 + jnp.max(jnp.abs(c))
        gap_tol = jnp.asarray(eps, dtype)
        feas_tol = jnp.maximum(1e-9, jnp.minimum(1e-6, gap_tol))

        # --- initialization (ops/pd.py semantics, segment-wise, with the
        # Mehrotra-style GLOBAL slack shift on violated starts — the
        # worst violation reduces over the mesh) -------------------------
        floor = 1e-4 * d_scale
        s_hat = d - C @ x0
        smin = -pmax(jnp.max(jnp.where(mask > 0, -s_hat, -jnp.inf)))
        delta = jnp.where(smin < floor,
                          -1.5 * jnp.minimum(smin, 0.0) + floor, 0.0)
        s0 = jnp.where(mask > 0, jnp.maximum(s_hat + delta, floor), 1.0)
        lam0 = jnp.where(mask > 0, jnp.clip(1.0 / s0, 1e-6, 1e6), 0.0)
        su0 = jnp.where(fub > 0, jnp.maximum(ubf - x0, floor), 1.0)
        lu0 = jnp.where(fub > 0, jnp.clip(1.0 / su0, 1e-6, 1e6), 0.0)
        sl0 = jnp.where(flb > 0, jnp.maximum(x0 - lbf, floor), 1.0)
        ll0 = jnp.where(flb > 0, jnp.clip(1.0 / sl0, 1e-6, 1e6), 0.0)
        v0 = jnp.zeros((m_local * ndev,), dtype)

        def residuals(x, v, s, lam, su, lu, sl, ll):
            v_loc = lax.dynamic_slice_in_dim(v, idx_m, m_local)
            rd = c + psum(C.T @ lam) + lu * fub - ll * flb \
                + psum(A.T @ v_loc)
            if has_P:
                rd = rd + Pm @ x
            rp = (C @ x + s - d) * mask
            rpu = (x + su - ubf) * fub
            rpl = (-x + sl + lbf) * flb
            rpe = A @ x - b
            return rd, rp, rpu, rpl, rpe

        def gap_of(s, lam, su, lu, sl, ll):
            return (psum(jnp.sum(s * lam * mask))
                    + jnp.sum(su * lu * fub) + jnp.sum(sl * ll * flb))

        def max_step_local(vv, dv):
            r = jnp.where(dv < 0, -vv / jnp.where(dv < 0, dv, -1.0),
                          jnp.inf)
            return jnp.min(r)

        def body(st):
            (x, v, s, lam, su, lu, sl, ll, it, *_) = st
            rd, rp, rpu, rpl, rpe = residuals(x, v, s, lam, su, lu, sl, ll)

            w_C = jnp.where(mask > 0, lam / s, 0.0)
            db = fub * lu / su + flb * ll / sl
            H = psum(C.T @ (w_C[:, None] * C)) + jnp.diag(db)
            if has_P:
                H = H + Pm
            # Factor-only regularization, PER-ROW relative (equivalent to
            # an absolute 1e-13 shift after Jacobi scaling): a
            # max(diag)-relative shift would scale with the 1/μ-blowing
            # bound diagonal and corrupt late directions (see
            # ops/socp_pd.py).  The true operator kkt_apply is UNshifted,
            # so the refinement rounds remove the perturbation — it only
            # keeps the factor finite when db = 0 and k < n leave the
            # Gram singular.
            H_fac = H + jnp.diag(1e-13 * jnp.abs(jnp.diag(H)) + 1e-30)

            def kkt_apply(dz, dv_loc):
                Hdz = psum(C.T @ (w_C * (C @ dz))) + db * dz
                if has_P:
                    Hdz = Hdz + Pm @ dz
                return Hdz + psum(A.T @ dv_loc), A @ dz

            def make_dir(f32_factor):
                solve = _make_solve(H_fac, dtype, f32_factor)
                Y_local = solve(A.T)
                Y = lax.all_gather(Y_local, axis, axis=1, tiled=True)
                S_rows = A @ Y
                S = gather0(S_rows)
                S = 0.5 * (S + S.T)
                mg = S.shape[0]
                pad_diag = (jnp.arange(mg) >= m_true).astype(dtype)
                S = S + jnp.diag(pad_diag + 1e-13 * jnp.max(jnp.diag(S)))
                solve_S = _make_solve(S, dtype, f32_factor)

                def direction(r1, r2_local):
                    """Solve [[H Aᵀ],[A 0]]·[dz, dv] = [r1, r2] by block
                    elimination, with true-residual refinement rounds
                    (factors reused)."""
                    t1 = solve(r1)
                    dv = solve_S(gather0(A @ t1) - gather0(r2_local))
                    dv_loc = lax.dynamic_slice_in_dim(dv, idx_m, m_local)
                    dz = t1 - solve(psum(A.T @ dv_loc))
                    for _ in range(3 if f32_factor else 2):
                        dv_l = lax.dynamic_slice_in_dim(dv, idx_m, m_local)
                        dual, Adz = kkt_apply(dz, dv_l)
                        e1 = r1 - dual
                        e2_local = r2_local - Adz
                        f = solve_S(gather0(A @ solve(e1))
                                    - gather0(e2_local))
                        f_l = lax.dynamic_slice_in_dim(f, idx_m, m_local)
                        dz = dz + solve(e1 - psum(A.T @ f_l))
                        dv = dv + f
                    return dz, dv
                return direction

            if mixed:
                dir32 = make_dir(True)

                def direction(r1, r2_local):
                    dz, dv = dir32(r1, r2_local)
                    dv_l = lax.dynamic_slice_in_dim(dv, idx_m, m_local)
                    dual, Adz = kkt_apply(dz, dv_l)
                    r1n = jnp.sum((r1 - dual) ** 2)
                    r2n = psum(jnp.sum((r2_local - Adz) ** 2))
                    scale = (jnp.sum(r1**2) + psum(jnp.sum(r2_local**2))
                             + jnp.asarray(1e-300, dtype))
                    ok = (r1n + r2n) < 1e-16 * scale
                    # the f64 factor is built INSIDE the fallback branch
                    # (as in _row_sharded_barrier): it must only execute
                    # on an actual f32-refinement stall, not every
                    # iteration
                    return lax.cond(ok, lambda _: (dz, dv),
                                    lambda _: make_dir(False)(r1, r2_local),
                                    None)
            else:
                direction = make_dir(False)

            def full_dir(rc, rcu, rcl):
                r1 = (-rd
                      + psum(C.T @ jnp.where(mask > 0,
                                             (rc - lam * rp) / s, 0.0))
                      + fub * (rcu - lu * rpu) / su
                      - flb * (rcl - ll * rpl) / sl)
                dz, dv = direction(r1, -rpe)
                ds = (-rp - C @ dz) * mask
                dlam = jnp.where(mask > 0, (-rc - lam * ds) / s, 0.0)
                dsu = (-rpu - dz) * fub
                dlu = jnp.where(fub > 0, (-rcu - lu * dsu) / su, 0.0)
                dsl = (-rpl + dz) * flb
                dll = jnp.where(flb > 0, (-rcl - ll * dsl) / sl, 0.0)
                return dz, dv, ds, dlam, dsu, dlu, dsl, dll

            mu = gap_of(s, lam, su, lu, sl, ll) / kcnt

            # predictor (affine scaling)
            aff = full_dir(s * lam * mask, su * lu * fub, sl * ll * flb)
            dz_a, dv_a, ds_a, dl_a, dsu_a, dlu_a, dsl_a, dll_a = aff
            ap_a = -pmax(-jnp.minimum(
                jnp.minimum(max_step_local(s, ds_a),
                            max_step_local(su, dsu_a)),
                max_step_local(sl, dsl_a)))
            ap_a = jnp.minimum(1.0, ap_a)
            ad_a = -pmax(-jnp.minimum(
                jnp.minimum(max_step_local(lam, dl_a),
                            max_step_local(lu, dlu_a)),
                max_step_local(ll, dll_a)))
            ad_a = jnp.minimum(1.0, ad_a)
            mu_aff = gap_of(s + ap_a * ds_a, lam + ad_a * dl_a,
                            su + ap_a * dsu_a, lu + ad_a * dlu_a,
                            sl + ap_a * dsl_a, ll + ad_a * dll_a) / kcnt
            sigma = jnp.clip((mu_aff / mu) ** 3, 0.0, 1.0)

            # corrector (factors reused inside `direction`)
            rc = (s * lam - sigma * mu + ds_a * dl_a) * mask
            rcu = (su * lu - sigma * mu + dsu_a * dlu_a) * fub
            rcl = (sl * ll - sigma * mu + dsl_a * dll_a) * flb
            dz, dv, ds, dlam, dsu, dlu, dsl, dll = full_dir(rc, rcu, rcl)
            ap = jnp.minimum(1.0, _GAMMA * -pmax(-jnp.minimum(
                jnp.minimum(max_step_local(s, ds),
                            max_step_local(su, dsu)),
                max_step_local(sl, dsl))))
            ad = jnp.minimum(1.0, _GAMMA * -pmax(-jnp.minimum(
                jnp.minimum(max_step_local(lam, dlam),
                            max_step_local(lu, dlu)),
                max_step_local(ll, dll))))

            x2 = x + ap * dz
            v2 = v + ad * dv
            s2 = jnp.where(mask > 0, s + ap * ds, 1.0)
            lam2 = lam + ad * dlam
            su2 = jnp.where(fub > 0, su + ap * dsu, 1.0)
            lu2 = lu + ad * dlu
            sl2 = jnp.where(flb > 0, sl + ap * dsl, 1.0)
            ll2 = ll + ad * dll
            rd2, rp2, rpu2, rpl2, rpe2 = residuals(
                x2, v2, s2, lam2, su2, lu2, sl2, ll2)
            gap2 = gap_of(s2, lam2, su2, lu2, sl2, ll2)
            rpn2 = pmax(jnp.maximum(jnp.max(jnp.abs(rp2)),
                                    jnp.max(jnp.abs(rpe2))))
            rpn2 = jnp.maximum(rpn2, jnp.maximum(jnp.max(jnp.abs(rpu2)),
                                                 jnp.max(jnp.abs(rpl2))))
            rdn2 = jnp.max(jnp.abs(rd2))
            stalled = (ap < _STALL_STEP) & (ad < _STALL_STEP)
            return (x2, v2, s2, lam2, su2, lu2, sl2, ll2, it + 1,
                    gap2, rpn2, rdn2, stalled)

        def cond(st):
            it, gap, rpn, rdn, stalled = st[8], st[9], st[10], st[11], st[12]
            done = ((gap < gap_tol) & (rpn < feas_tol * d_scale)
                    & (rdn < feas_tol * q_scale))
            return (it < max_iters) & ~done & ~stalled & jnp.isfinite(gap)

        rd0, rp0, rpu0, rpl0, rpe0 = residuals(
            x0, v0, s0, lam0, su0, lu0, sl0, ll0)
        rpn0 = pmax(jnp.maximum(jnp.max(jnp.abs(rp0)),
                                jnp.max(jnp.abs(rpe0))))
        rpn0 = jnp.maximum(rpn0, jnp.maximum(jnp.max(jnp.abs(rpu0)),
                                             jnp.max(jnp.abs(rpl0))))
        st0 = (x0, v0, s0, lam0, su0, lu0, sl0, ll0,
               jnp.zeros((), jnp.int32), gap_of(s0, lam0, su0, lu0,
                                                sl0, ll0),
               rpn0, jnp.max(jnp.abs(rd0)), jnp.zeros((), bool))
        out = lax.while_loop(cond, body, st0)
        x, v, s, lam, su, lu, sl, ll, it, gap, rpn, rdn, _ = out
        converged = ((gap < gap_tol) & (rpn < feas_tol * d_scale)
                     & (rdn < feas_tol * q_scale))
        obj = c @ x + (0.5 * x @ (Pm @ x) if has_P else 0.0)
        lam_g = gather0(lam)
        return x, v, obj, it, gap, converged, lam_g, lu, ll

    spec_rows = P(axis, None)
    spec_vec = P(axis)
    rep = P()
    return jax.jit(shard_map(
        highest_precision(prog), mesh=mesh,
        in_specs=(rep, rep, spec_rows, spec_vec, spec_rows, spec_vec,
                  rep, rep, rep),
        out_specs=(rep, rep, rep, rep, rep, rep, rep, rep, rep),
        check_vma=False,
    ))


def solve_pd_row_sharded(mesh: Mesh, c, A, b, C, d, lb=None, ub=None, *,
                         P_obj=None, x0=None, epsilon=1e-8,
                         max_iters: int = 60, axis: str = "rows",
                         distributed_factor=False,
                         factor_dtype: str = "float64",
                         chol_block: int = 256):
    """Distributed Mehrotra predictor-corrector solve of one huge LP/QP
    with constraint rows sharded over the mesh:
    min cᵀx (+½xᵀPx) s.t. Ax = b, Cx ≤ d, lb ≤ x ≤ ub.

    Infeasible-start: no phase one runs (any x0 — default bound midpoint
    or zeros — is absorbed as a primal residual).  Row counts need not
    divide the mesh; bounds are optional (masked, not stacked).  Returns
    a dict with x, v (true equality rows), lam (inequality multipliers,
    slack order [Cx≤d, ub, lb]), objective, iterations, gap, converged.
    """
    from ..models.base import ensure_x64

    ensure_x64("float64")
    ndev = mesh.shape[axis]
    c = jnp.asarray(c, jnp.float64)
    n = c.shape[0]
    dtype = c.dtype
    A = (jnp.zeros((0, n), dtype) if A is None else jnp.asarray(A, dtype))
    b = (jnp.zeros((0,), dtype) if b is None else jnp.asarray(b, dtype))
    C = (jnp.zeros((0, n), dtype) if C is None else jnp.asarray(C, dtype))
    d = (jnp.zeros((0,), dtype) if d is None else jnp.asarray(d, dtype))
    m_true, k_true = A.shape[0], C.shape[0]
    if k_true == 0 and lb is None and ub is None:
        raise ValueError("pd requires inequality constraints or bounds")

    mp = max(-(-m_true // ndev) * ndev, ndev)
    kp = max(-(-k_true // ndev) * ndev, ndev)
    A_p = _pad_rows(A, mp)
    b_p = _pad_rows(b, mp)
    C_p = _pad_rows(C, kp)
    d_p = _pad_rows(d, kp, fill=1.0)

    lb_v = (jnp.full((n,), -jnp.inf, dtype) if lb is None
            else jnp.broadcast_to(jnp.asarray(lb, dtype), (n,)))
    ub_v = (jnp.full((n,), jnp.inf, dtype) if ub is None
            else jnp.broadcast_to(jnp.asarray(ub, dtype), (n,)))
    if x0 is None:
        if lb is not None and ub is not None:
            x0 = 0.5 * (lb_v + ub_v)
        else:
            x0 = jnp.zeros((n,), dtype)
    x0 = jnp.asarray(x0, dtype)

    has_P = P_obj is not None
    Pm = (jnp.asarray(P_obj, dtype) if has_P
          else jnp.zeros((1, 1), dtype))

    prog = _row_sharded_pd(
        mesh, axis, m_true=m_true, k_true=k_true, eps=float(epsilon),
        max_iters=int(max_iters), has_P=has_P,
        distributed_factor=bool(distributed_factor),
        factor_dtype=factor_dtype, chol_block=int(chol_block), ndev=ndev)

    x, v, obj, it, gap, conv, lam_g, lu, ll = prog(
        c, Pm, shard_rows(mesh, A_p, axis), shard_rows(mesh, b_p, axis),
        shard_rows(mesh, C_p, axis), shard_rows(mesh, d_p, axis),
        lb_v, ub_v, x0)

    import numpy as np

    lam_parts = [np.asarray(lam_g)[:k_true]]
    if ub is not None:
        lam_parts.append(np.asarray(lu))
    if lb is not None:
        lam_parts.append(np.asarray(ll))
    it = int(it)
    return dict(x=x, v=v[:m_true], objective=float(obj),
                iterations=it, gap=float(gap),
                converged=bool(conv),
                lam=np.concatenate(lam_parts) if lam_parts else None,
                # barrier-result aliases so callers dispatching via
                # solve_lp_row_sharded(algorithm="pd") see the same keys
                outer_iters=it, newton_iters=it)
