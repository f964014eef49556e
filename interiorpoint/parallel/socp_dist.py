"""Cone-axis sharding for single huge SOCP instances.

Completes the distributed story across the problem classes (LP/QP row
sharding lives in ``parallel/distributed.py``): the stacked cone tensors
A (K, M, n) / b (K, M) / c (K, n) / d (K,) are sharded over the mesh on
the CONE axis, so each chip owns K/ndev cones and evaluates its share of
the barrier oracle — the FLOP-dominant Σ_k w_k(A_kᵀA_k + c_kc_kᵀ)
curvature and the (K, M, n) contractions (SURVEY.md §3.3 hot loop;
reference evaluates the same math with a per-cone Python loop,
FunctionManager.py:1076-1158, on one GPU).  Cross-chip communication is
``psum`` at the gradient/Hessian/candidate-gradient reduction points;
the equality block F stays replicated (it is small in the reference
recipe, testSolver.py:862-880) and feeds a replicated — or cooperative,
via ``parallel/chol.py`` — factorization.

The full IPM (outer t-loop, infeasible-start Newton over (x, v),
residual-backtracking candidate line search) runs as ONE jitted
shard_map program, the same zero-host-round-trip structure as the
row-sharded LP/QP program and the single-chip engine (ops/newton.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.barrier import SLACK_EPS, SOCP_SLACK_EPS
from .distributed import _dispatch_barrier, _load_checkpoint, \
    make_factor_tools
from ..utils.precision import highest_precision


def shard_cones(mesh: Mesh, arr, axis: str = "cones"):
    """Place a stacked cone tensor with its cone axis on ``axis``."""
    spec = P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def _pad_cones(A, b, c, d, Kp):
    """Pad the stacked cone tensors to Kp cones with inert entries:
    A = 0, b = 0, c = 0, d = 1 gives slack ≡ 1 on the padding — zero
    gradient force, zero curvature, always-positive candidates."""
    K, M, n = A.shape
    dt = A.dtype
    A_p = jnp.zeros((Kp, M, n), dt).at[:K].set(A)
    b_p = jnp.zeros((Kp, M), dt).at[:K].set(b)
    c_p = jnp.zeros((Kp, n), dt).at[:K].set(c)
    d_p = jnp.ones((Kp,), dt).at[:K].set(d)
    return A_p, b_p, c_p, d_p


def _cone_sharded_barrier(mesh: Mesh, axis: str, *, m_true: int,
                          num_ineq: int, mu: float, eps: float,
                          inner_eps: float, alpha: float, beta: float,
                          J: int, max_inner: int,
                          has_P: bool, has_q: bool,
                          distributed_factor=False,
                          factor_dtype: str = "float64",
                          chol_block: int = 256, ndev: int = 1):
    """Build the ONE jitted shard_map program for the distributed SOCP
    barrier solve.

    Squared-cone barrier parity with the single-chip oracle
    (ops/socp.py; reference: FunctionManager.py:962-1158): slack_k =
    (c_kᵀx + d_k)² − ‖A_kx + b_k‖², the rhs values c_kᵀx + d_k are
    domain-only (not in the barrier sum), and the curvature keeps the
    reference's +c_kc_kᵀ Gauss–Newton sign.

    The equality block is padded to ≥1 rows with zero rows carrying
    +1 on the Schur diagonal (rhs 0 ⇒ their multipliers stay 0), so the
    F-is-None case runs the same program with every row inert — one
    compiled program for both shapes.  ``factor_dtype="float32"`` and
    ``distributed_factor`` follow the row-sharded LP program's
    mixed-precision / cooperative-factor strategy (make_factor_tools),
    including the refinement-stall escalation back to the f64 factor.
    """
    mixed = factor_dtype == "float32"
    _make_solve = make_factor_tools(axis, ndev, distributed_factor,
                                    chol_block)

    def prog(q, Pm, A, b, cv, d, F, g_eq, lb, ub, x0, v0, t0v, max_outer):
        # max_outer is a traced operand — see _row_sharded_barrier.
        dtype = x0.dtype
        n = x0.shape[0]
        mg = F.shape[0]
        sig = jnp.asarray(beta, dtype) ** jnp.arange(J, dtype=dtype)
        pad_diag = (jnp.arange(mg) >= m_true).astype(dtype)

        def _lin_grad(x):
            g0 = jnp.zeros((n,), dtype)
            if has_P:
                g0 = g0 + Pm @ x
            if has_q:
                g0 = g0 + q
            return g0

        def newton_body(t, s):
            x, v, it, resid, done, success = s

            # --- local cone oracle over this chip's shard ------------
            lhs = jnp.einsum("kmn,n->km", A, x) + b        # (K_l, M)
            rhs = cv @ x + d                               # (K_l,)
            slack = rhs**2 - jnp.sum(lhs**2, axis=-1)
            w = 2.0 / (slack + SOCP_SLACK_EPS)
            G0 = jnp.einsum("kmn,km->kn", A, lhs) - cv * rhs[:, None]
            g = lax.psum(w @ G0, axis)
            g = g + t * _lin_grad(x) \
                + 1.0 / (ub - x + SLACK_EPS) \
                - 1.0 / (x - lb + SLACK_EPS)

            # Hessian: Σ_k w_k (A_kᵀA_k + c_kc_kᵀ) + Σ_k outer(w_k g_k)
            sw = jnp.sqrt(w)
            B = (sw[:, None, None] * A).reshape(-1, n)
            cw = sw[:, None] * cv
            Gw = w[:, None] * G0
            H_local = B.T @ B + cw.T @ cw + Gw.T @ Gw
            H = lax.psum(H_local, axis)
            db = (1.0 / (ub - x + SLACK_EPS) ** 2
                  + 1.0 / (x - lb + SLACK_EPS) ** 2)
            H = H + jnp.diag(db)
            if has_P:
                H = H + t * Pm

            rpri = F @ x - g_eq                            # replicated

            def _direction(f32_factor):
                """Block elimination on the replicated KKT system (F is
                replicated, so no panel gathers are needed — the psum
                above already produced the full H) + iterative
                refinement against the true residuals."""
                solve = _make_solve(H, dtype, f32_factor)
                Y = solve(F.T)                             # (n, mg)
                S = F @ Y
                S = 0.5 * (S + S.T)
                jit_s = 1e-13 * jnp.max(jnp.diag(S) + pad_diag)
                S = S + jnp.diag(pad_diag + jit_s)
                solve_S = _make_solve(S, dtype, f32_factor)

                rhs_S = rpri - F @ solve(g)
                wv = solve_S(rhs_S)
                dx = -solve(g + F.T @ wv)

                for _ in range(3 if f32_factor else 2):
                    r1 = -g - (H @ dx + F.T @ wv)
                    r2 = -rpri - F @ dx
                    f = solve_S(F @ solve(r1) - r2)
                    e = solve(r1 - F.T @ f)
                    dx = dx + e
                    wv = wv + f
                return dx, wv

            if mixed:
                dx, wv = _direction(True)
                # f32-factor stall detection (same policy as the
                # row-sharded LP program): redo with the f64 factor
                # when refinement failed to reach ~f64 residuals.
                r1n = jnp.sum((g + H @ dx + F.T @ wv) ** 2)
                r2n = jnp.sum((rpri + F @ dx) ** 2)
                scale = (jnp.sum(g**2) + jnp.sum(rpri**2)
                         + jnp.asarray(1e-300, dtype))
                okf = (r1n + r2n) < 1e-16 * scale
                dx, wv = lax.cond(okf, lambda _: (dx, wv),
                                  lambda _: _direction(False), None)
            else:
                dx, wv = _direction(False)

            dv = wv - v

            # --- residual-backtracking candidate sweep ---------------
            # cone slacks are quadratic in σ: slack(σ) = s0 + σp1 + σ²p2
            lhsdx = jnp.einsum("kmn,n->km", A, dx)
            cdx = cv @ dx
            p1 = 2.0 * (rhs * cdx - jnp.sum(lhs * lhsdx, axis=-1))
            p2 = cdx**2 - jnp.sum(lhsdx**2, axis=-1)
            cone_c = (slack[:, None] + sig[None, :] * p1[:, None]
                      + (sig**2)[None, :] * p2[:, None])     # (K_l, J)
            rhs_c = rhs[:, None] + sig[None, :] * cdx[:, None]
            ok_l = (jnp.all(cone_c > 0.0, axis=0)
                    & jnp.all(rhs_c > 0.0, axis=0))          # (J,)
            ok = lax.pmin(ok_l.astype(jnp.int32), axis) > 0
            xc = x[:, None] + sig[None, :] * dx[:, None]     # (n, J)
            ok = ok & jnp.all(xc < ub[:, None], axis=0) \
                    & jnp.all(xc > lb[:, None], axis=0)

            r0 = jnp.sqrt(jnp.sum((g + F.T @ v) ** 2)
                          + jnp.sum(rpri**2))

            W = 2.0 / (cone_c + SOCP_SLACK_EPS)              # (K_l, J)
            G1 = jnp.einsum("kmn,km->kn", A, lhsdx) - cv * cdx[:, None]
            gc = lax.psum(G0.T @ W + G1.T @ (W * sig[None, :]), axis)
            lin0 = _lin_grad(x)
            gc = gc + t * lin0[:, None]
            if has_P:
                Pdx = Pm @ dx
                gc = gc + t * sig[None, :] * Pdx[:, None]
            gc = gc + 1.0 / (ub[:, None] - xc + SLACK_EPS) \
                    - 1.0 / (xc - lb[:, None] + SLACK_EPS)
            vc = v[:, None] + sig[None, :] * dv[:, None]     # (mg, J)
            r_dual = gc + F.T @ vc
            r_pri_c = rpri[:, None] + sig[None, :] * (F @ dx)[:, None]
            rn = jnp.sqrt(jnp.sum(r_dual**2, axis=0)
                          + jnp.sum(r_pri_c**2, axis=0))

            accept = ok & (rn <= (1.0 - alpha * sig) * r0)
            any_acc = jnp.any(accept)
            j = jnp.argmax(accept)
            sigma = jnp.where(any_acc, sig[j], jnp.zeros((), dtype))

            x_new = jnp.where(any_acc, x + sigma * dx, x)
            v_new = jnp.where(any_acc, v + sigma * dv, v)
            res_new = jnp.where(any_acc, rn[j], r0)
            converged = res_new < inner_eps
            done = (~any_acc) | converged
            return (x_new, v_new, it + 1, res_new, done, converged)

        def newton_loop(x, v, t):
            def cond(s):
                return (~s[4]) & (s[2] < max_inner)

            init = (x, v, jnp.zeros((), jnp.int32),
                    jnp.asarray(jnp.inf, dtype), jnp.zeros((), bool),
                    jnp.zeros((), bool))
            out = lax.while_loop(cond, lambda s: newton_body(t, s), init)
            return out[0], out[1], out[2], out[5]

        def outer_body(s):
            x, v, t, it, total_nt, done = s
            x, v, nt, success = newton_loop(x, v, t)
            done = jnp.asarray(num_ineq, dtype) / t < eps
            return (x, v, t * mu, it + 1, total_nt + nt, done)

        def outer_cond(s):
            return (~s[5]) & (s[3] < max_outer)

        out = lax.while_loop(
            outer_cond, outer_body,
            (x0, v0, t0v, jnp.zeros((), jnp.int32),
             jnp.zeros((), jnp.int32), jnp.zeros((), bool)))
        x, v, t_fin, outer_it, total_nt, done = out
        obj = jnp.zeros((), dtype)
        if has_P:
            obj = obj + 0.5 * x @ (Pm @ x)
        if has_q:
            obj = obj + q @ x
        return x, v, obj, outer_it, total_nt, t_fin, done

    spec_cones = lambda nd: P(axis, *([None] * (nd - 1)))
    rep = P()
    return jax.jit(shard_map(
        highest_precision(prog), mesh=mesh,
        in_specs=(rep, rep, spec_cones(3), spec_cones(2), spec_cones(2),
                  spec_cones(1), rep, rep, rep, rep, rep, rep, rep, rep),
        out_specs=(rep, rep, rep, rep, rep, rep, rep),
        check_vma=False,
    ))


def solve_socp_cone_sharded(mesh: Mesh, A, b, c, d, P_obj=None, q=None,
                            F=None, g=None, lb=None, ub=None, *,
                            x0=None, t0=1.0, mu=15.0, epsilon=1e-8,
                            inner_epsilon=1e-8, alpha=0.2, beta=0.6,
                            max_linesearch_steps=40, max_outer_iters=30,
                            max_inner_iters=60, axis: str = "cones",
                            distributed_factor=False,
                            factor_dtype="float64", chol_block=256,
                            phase1="auto", checkpoint_path=None,
                            checkpoint_every=1, resume=False,
                            algorithm="barrier", pd_max_iters=60):
    """Full distributed SOCP barrier solve with the cone axis sharded
    over the mesh:

    ``algorithm="pd"`` dispatches to the distributed conic Mehrotra
    solve (``parallel.socp_pd_dist.solve_socp_pd_cone_sharded``): NT
    scaling, 10–30 iterations, no phase one; the barrier-only knobs
    (t0, mu, inner tolerances, line search, checkpointing) do not
    apply there.

        min ½xᵀPx + qᵀx
        s.t. ‖A_k x + b_k‖₂ ≤ c_kᵀx + d_k  (k = 1..K),
             Fx = g,  lb ≤ x ≤ ub

    with A (K, M, n), b (K, M), c (K, n), d (K,) stacked cone tensors
    (zero-pad individual cones to a common M; padded rows are exact
    no-ops in the ‖·‖² sums — the single-chip layout of
    models/problem.py:SOCPProblem).  K need not divide the mesh (inert
    cone padding), F/g, bounds, P and q are all optional.

    ``x0`` must be strictly cone-feasible, or ``phase1="auto"`` (the
    default) runs the distributed SOCP phase one (min s over the
    rhs-shifted cones — the same extended-problem trick as the
    single-chip make_phase1_socp_oracle) and raises ValueError when the
    problem is strictly infeasible.  Reference semantics:
    SOCPSolver.py; the distribution scheme is new capability (the
    reference is single-GPU, SURVEY.md §2.2).

    ``checkpoint_path``/``checkpoint_every``/``resume`` enable mid-solve
    checkpointing exactly as in ``solve_lp_row_sharded`` (host-stepped
    chunks, atomic .npz, phase-1 ``.p1`` sidecar, process-0 writes —
    see that docstring).  Without a checkpoint path the whole solve is
    ONE device program.

    Returns a dict with x, v (equality multipliers, empty when F is
    None), objective, outer_iters, newton_iters.
    """
    if algorithm == "pd":
        if checkpoint_path is not None:
            raise ValueError("algorithm='pd' does not support mid-solve "
                             "checkpointing (solves are 10-30 iterations)")
        from .socp_pd_dist import solve_socp_pd_cone_sharded
        return solve_socp_pd_cone_sharded(
            mesh, A, b, c, d, P_obj=P_obj, q=q, F=F, g=g, lb=lb, ub=ub,
            x0=x0, epsilon=epsilon, max_iters=pd_max_iters, axis=axis,
            distributed_factor=distributed_factor,
            factor_dtype=factor_dtype, chol_block=chol_block)
    if algorithm != "barrier":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    from ..models.base import ensure_x64
    ensure_x64("float64")
    ndev = mesh.shape[axis]
    A = jnp.asarray(A, jnp.float64)
    dtype = A.dtype
    K, M, n = A.shape
    b = jnp.asarray(b, dtype)
    c = jnp.asarray(c, dtype)
    d = jnp.asarray(d, dtype)
    num_ineq = K + (n if lb is not None else 0) \
        + (n if ub is not None else 0)

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

    # resume from a mid-solve checkpoint: the stored iterate replaces x0
    # BEFORE the cone-feasibility gate (it is strictly feasible, so
    # phase one is skipped rather than re-run)
    ck_state = _load_checkpoint(checkpoint_path, resume)
    if ck_state is not None:
        x0 = jnp.asarray(ck_state["x"], dtype)

    if phase1 == "auto" or phase1 is True:
        lhs = jnp.einsum("kmn,n->km", A, x0) + b
        rhs = c @ x0 + d
        slack_min = float(jnp.min(jnp.concatenate([
            rhs**2 - jnp.sum(lhs**2, axis=-1), rhs,
            ub_v - x0, x0 - lb_v])))
        if not slack_min > 0:
            x0 = _cone_sharded_phase1(
                mesh, A, b, c, d, F_p if has_F else None,
                g_p[:m_true] if has_F else None, lb_v, ub_v, x0,
                axis=axis, distributed_factor=distributed_factor,
                factor_dtype=factor_dtype, chol_block=chol_block,
                checkpoint_path=(None if checkpoint_path is None
                                 else checkpoint_path + ".p1"),
                checkpoint_every=checkpoint_every, resume=resume)
            # gate fired on a resumed iterate ⇒ data changed since the
            # checkpoint: restart the schedule (see _solve_row_sharded)
            ck_state = None

    has_P = P_obj is not None
    has_q = q is not None
    Pm = jnp.asarray(P_obj, dtype) if has_P else jnp.zeros((1, 1), dtype)
    qv = jnp.asarray(q, dtype) if has_q else jnp.zeros((1,), dtype)
    v0 = jnp.zeros((mg,), dtype)

    prog = _cone_sharded_barrier(
        mesh, axis, m_true=m_true, num_ineq=num_ineq,
        mu=float(mu), eps=float(epsilon), inner_eps=float(inner_epsilon),
        alpha=float(alpha), beta=float(beta),
        J=int(max_linesearch_steps),
        max_inner=int(max_inner_iters), has_P=has_P, has_q=has_q,
        distributed_factor=bool(distributed_factor),
        factor_dtype=factor_dtype, chol_block=int(chol_block), ndev=ndev)

    operands = (qv, Pm, shard_cones(mesh, A_p, axis),
                shard_cones(mesh, b_p, axis), shard_cones(mesh, c_p, axis),
                shard_cones(mesh, d_p, axis), F_p, g_p, lb_v, ub_v)
    prog_call = lambda x, v, tv, mo: prog(
        *operands, x, v, tv, jnp.asarray(mo, jnp.int32))

    x, v, obj, outer_it, total_nt = _dispatch_barrier(
        prog_call, x0, v0, float(t0), dtype, int(max_outer_iters),
        checkpoint_path, int(checkpoint_every), ck_state)
    return dict(x=x, v=v[:m_true], objective=obj,
                outer_iters=outer_it, newton_iters=total_nt)


def _cone_sharded_phase1(mesh, A, b, c, d, F, g, lb_v, ub_v, x0, *, axis,
                         distributed_factor, factor_dtype, chol_block,
                         checkpoint_path=None, checkpoint_every=1,
                         resume=False):
    """Distributed SOCP phase one over z = [x, s]: minimize s subject to
    the rhs-shifted cones ‖A_k x + b_k‖ ≤ c_kᵀx + s + d_k (extended
    cone tensors A_ext = [A | 0], c_ext = [c | 1]), Fx = g and the box —
    strictly feasible by construction at s₀ = max_k(‖A_kx₀+b_k‖ −
    c_kᵀx₀ − d_k) + 1.  s* < 0 certifies a strictly feasible x for the
    original cones (the distributed analogue of
    ops/socp.py:make_phase1_socp_oracle's shifted-rhs formulation)."""
    import numpy as np

    K, M, n = A.shape
    dtype = A.dtype
    lo = jnp.maximum(lb_v, -1e12)
    hi = jnp.minimum(ub_v, 1e12)
    x0c = jnp.clip(x0, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    lhs = jnp.einsum("kmn,n->km", A, x0c) + b
    s0 = jnp.maximum(
        jnp.max(jnp.sqrt(jnp.sum(lhs**2, axis=-1)) - c @ x0c - d) + 1.0,
        0.0)

    A_ext = jnp.concatenate([A, jnp.zeros((K, M, 1), dtype)], axis=2)
    c_ext = jnp.concatenate([c, jnp.ones((K, 1), dtype)], axis=1)
    q_ext = jnp.zeros((n + 1,), dtype).at[n].set(1.0)
    F_ext = (jnp.concatenate([F, jnp.zeros((F.shape[0], 1), dtype)],
                             axis=1) if F is not None else None)
    # s bounded below at -1: min s over rhs-shifted cones is unbounded
    # whenever the cone margins are (s* < 0 is all the certificate
    # needs); the bound terminates those instances — same policy as
    # _row_sharded_phase1.
    lb_ext = jnp.concatenate([lb_v, jnp.asarray([-1.0], dtype)])
    ub_ext = jnp.concatenate([ub_v, jnp.asarray([jnp.inf], dtype)])
    z0 = jnp.concatenate([x0c, s0[None]])

    res = solve_socp_cone_sharded(
        mesh, A_ext, b, c_ext, d, None, q_ext, F_ext, g, lb_ext, ub_ext,
        x0=z0, epsilon=1e-6, axis=axis,
        distributed_factor=distributed_factor,
        factor_dtype=factor_dtype, chol_block=chol_block, phase1=False,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume)
    z = np.asarray(res["x"])
    if not np.isfinite(z).all() or z[n] >= 0:
        raise ValueError(
            "Phase 1 did not find a strictly cone-feasible point "
            f"(optimal shift s* = {z[n]:.3e} >= 0): problem infeasible")
    x1 = z[:n]
    lhs1 = np.einsum("kmn,n->km", np.asarray(A), x1) + np.asarray(b)
    rhs1 = np.asarray(c) @ x1 + np.asarray(d)
    slack_min = min(
        float(np.min(rhs1**2 - np.sum(lhs1**2, axis=-1))),
        float(np.min(rhs1)),
        float(np.min(np.asarray(ub_v) - x1)),
        float(np.min(x1 - np.asarray(lb_v))))
    if not slack_min > 0:
        raise ValueError(
            "Phase 1 terminated with s* < 0 but a non-positive slack "
            f"(min slack {slack_min:.3e}); the problem is feasible but "
            "barely — tighten phase-1 epsilon or supply a feasible x0")
    return jnp.asarray(x1, dtype)
