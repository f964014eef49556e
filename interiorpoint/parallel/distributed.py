"""Constraint-row sharding for single huge instances.

The barrier Hessian H = CᵀD²C + diag and the Schur products A·H⁻¹Aᵀ are the
FLOP-dominant pieces of each Newton step (SURVEY.md §3.2 hot loops).  For
one instance too large for a chip — or to cut wall-clock per step — the
constraint rows of C and A are sharded across the mesh:

  * each chip forms its partial Hessian C_dᵀ D_d² C_d; a ``psum`` over the
    row axis yields the replicated H (the factorization itself is
    replicated — it is the serial core of the method);
  * the Schur complement is assembled from per-chip panels
    Y_d = H⁻¹A_dᵀ with an ``all_gather`` of the panels;
  * gradients reduce with the same psum pattern.

Also: ``initialize()`` wraps jax.distributed.initialize for multi-host
clusters.  This whole module is new capability — the reference is
single-device (SURVEY.md §2.2).
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.barrier import SLACK_EPS
from ..ops.kkt import robust_cholesky
from ..utils.precision import highest_precision


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Multi-host init (one process per host).  No-op when
    JAX is already initialized or single-process."""
    if num_processes is None or num_processes <= 1:
        return
    state = getattr(jax.distributed, "global_state", None)
    if state is not None and getattr(state, "client", None) is not None:
        return  # already initialized (retrying launchers call this twice)
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def row_sharded_lp_newton_step(mesh: Mesh, axis: str = "rows"):
    """Build a jitted infeasible-start LP Newton step with C and A rows
    sharded over ``axis``.

    Returns step(c, A, b, C, d, lb, ub, x, v, t) -> (x_new, v_new, resid)
    where A, b, C, d enter pre-sharded on their row axis (use
    ``shard_rows``); x, v, c, lb, ub, t are replicated.

    Constraints of this single-step demo (lifted by the full distributed
    solve in ``solve_lp_row_sharded``): both bounds must be finite arrays
    (the slack terms use ub−x and x−lb unconditionally), and the row
    counts of A and C must divide evenly by the mesh axis size (the
    back-substitution slices ``w`` by equal per-shard row counts).

    The math matches ops/kkt.py's block elimination (reference:
    NewtonSolverInfeasibleStart.py:386-511) with communication only at the
    psum/all_gather points noted inline.
    """
    def step(c, A, b, C, d, lb, ub, x, v, t):
        # --- slacks & gradient: per-shard inequality rows, psum-reduced ---
        s_C = d - C @ x                       # local rows
        inv_C = 1.0 / (s_C + SLACK_EPS)
        g_local = C.T @ inv_C                 # (n,) partial
        g = lax.psum(g_local, axis)           # all-reduce
        g = g + t * c + 1.0 / (ub - x + SLACK_EPS) \
            - 1.0 / (x - lb + SLACK_EPS)

        # --- Hessian: partial CᵀD²C, psum, replicated bound diagonal -----
        H_local = C.T @ (inv_C[:, None] ** 2 * C)
        H = lax.psum(H_local, axis)
        db = 1.0 / (ub - x + SLACK_EPS) ** 2 + 1.0 / (x - lb + SLACK_EPS) ** 2
        H = H + jnp.diag(db)

        # --- replicated factorization (serial core) ----------------------
        L = jnp.linalg.cholesky(H)
        solve = lambda B: jax.scipy.linalg.solve_triangular(
            L.T, jax.scipy.linalg.solve_triangular(L, B, lower=True),
            lower=False)

        # --- Schur panels: local solve, all_gather ------------------------
        rpri_local = A @ x - b                # local equality rows
        Y_local = solve(A.T)                  # (n, m_local) panel
        Y = lax.all_gather(Y_local, axis, axis=1, tiled=True)   # (n, m)
        Hinv_g = solve(g)
        S_rows = A @ Y                        # (m_local, m)
        S = lax.all_gather(S_rows, axis, axis=0, tiled=True)    # (m, m)
        S = 0.5 * (S + S.T)
        rpri = lax.all_gather(rpri_local, axis, axis=0, tiled=True)
        rhs = rpri - lax.all_gather(A @ Hinv_g, axis, axis=0, tiled=True)
        Ls = jnp.linalg.cholesky(S)
        w = jax.scipy.linalg.solve_triangular(
            Ls.T, jax.scipy.linalg.solve_triangular(Ls, rhs, lower=True),
            lower=False)

        # --- back-substitution: AᵀW reduces over sharded rows -------------
        m_local = A.shape[0]
        idx = lax.axis_index(axis) * m_local
        w_local = lax.dynamic_slice_in_dim(w, idx, m_local)
        ATw = lax.psum(A.T @ w_local, axis)
        dx = -solve(g + ATw)
        dv = w - v

        # --- fixed damped step (full line search lives in ops/newton) ----
        ds_C = C @ dx
        # largest sigma keeping local slacks positive, reduced via psum-min
        limit_local = jnp.min(jnp.where(ds_C > 0, s_C / ds_C, jnp.inf))
        limit_bound = jnp.minimum(
            jnp.min(jnp.where(dx > 0, (ub - x) / dx, jnp.inf)),
            jnp.min(jnp.where(dx < 0, (lb - x) / dx, jnp.inf)),
        )
        limit = jnp.minimum(-lax.pmax(-limit_local, axis), limit_bound)
        sigma = jnp.minimum(1.0, 0.99 * limit)
        x_new = x + sigma * dx
        v_new = v + sigma * dv

        # --- KKT residual at the new iterate ------------------------------
        s_C_new = d - C @ x_new
        g_new = lax.psum(C.T @ (1.0 / (s_C_new + SLACK_EPS)), axis)
        g_new = g_new + t * c + 1.0 / (ub - x_new + SLACK_EPS) \
            - 1.0 / (x_new - lb + SLACK_EPS)
        v_new_local = lax.dynamic_slice_in_dim(v_new, idx, m_local)
        r_dual = g_new + lax.psum(A.T @ v_new_local, axis)
        rpri_sq = lax.psum(jnp.sum((A @ x_new - b) ** 2), axis)
        resid = jnp.sqrt(jnp.sum(r_dual**2) + rpri_sq)
        return x_new, v_new, resid

    spec_rows = P(axis, None)
    spec_vec_rows = P(axis)
    rep = P()
    return jax.jit(shard_map(
        highest_precision(step), mesh=mesh,
        in_specs=(rep, spec_rows, spec_vec_rows, spec_rows, spec_vec_rows,
                  rep, rep, rep, rep, rep),
        out_specs=(rep, rep, rep),
        check_vma=False,
    ))


def shard_rows(mesh: Mesh, arr, axis: str = "rows"):
    """Place a constraint matrix/vector with its row axis on ``axis``."""
    spec = P(axis, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def _pad_rows(arr, rows, fill=0.0):
    out = jnp.full((rows,) + arr.shape[1:], fill, arr.dtype)
    return out.at[: arr.shape[0]].set(arr)


def make_factor_tools(axis: str, ndev: int, distributed_factor: bool,
                      chol_block: int):
    """Return a ``_make_solve(M, dtype, f32_factor=False)`` factory for
    SPD solves inside a shard_map program on mesh axis ``axis``.

    The returned factory factors M (replicated Cholesky, or the
    cooperative block-cyclic factor of parallel/chol.py when
    ``distributed_factor``) and yields ``solve(B)`` in the iterate
    dtype.  With ``f32_factor`` the factor/trisolves run f32 on a
    Jacobi-scaled matrix (unit diagonal ⇒ entries in [-1,1], no
    overflow); callers' iterative refinement restores accuracy.
    Shared by the row-sharded LP/QP barrier and the cone-sharded SOCP
    program so the factor strategy stays in one place.
    """
    from .chol import dist_cholesky

    def _chol(M):
        if distributed_factor:
            return dist_cholesky(M, axis, ndev, chol_block)
        # the single-card engines' jitter ladder: a Schur complement that
        # late iterations leave numerically singular must not turn the
        # direction into NaN
        return robust_cholesky(M)

    def _make_solve(M, dtype, f32_factor=False):
        if f32_factor and dtype != jnp.float32:
            dsc = 1.0 / jnp.sqrt(jnp.maximum(
                jnp.diag(M), jnp.asarray(1e-300, dtype)))
            Ms = (dsc[:, None] * M * dsc[None, :]).astype(jnp.float32)
            Lf = _chol(Ms)

            def solve(B):
                vec = B.ndim == 1
                B2 = B[:, None] if vec else B
                Bs = (dsc[:, None] * B2).astype(jnp.float32)
                Y = jax.scipy.linalg.solve_triangular(Lf, Bs, lower=True)
                Z = jax.scipy.linalg.solve_triangular(Lf.T, Y, lower=False)
                out = dsc[:, None] * Z.astype(dtype)
                return out[:, 0] if vec else out
        else:
            Lf = _chol(M)

            def solve(B):
                Y = jax.scipy.linalg.solve_triangular(Lf, B, lower=True)
                return jax.scipy.linalg.solve_triangular(Lf.T, Y,
                                                         lower=False)
        return solve

    return _make_solve


def _row_sharded_barrier(mesh: Mesh, axis: str, *, m_true: int, k_true: int,
                         num_ineq: int, mu: float, eps: float,
                         inner_eps: float, alpha: float, beta: float,
                         J: int, max_inner: int,
                         has_P: bool = False, distributed_factor=False,
                         factor_dtype: str = "float64",
                         chol_block: int = 256, ndev: int = 1):
    """Build the ONE jitted shard_map program for the full distributed LP
    barrier solve: outer t-loop and inner Newton loop are nested
    lax.while_loops with collectives (psum / all_gather / pmax) at the
    reduction points — zero host round-trips per iteration, the same
    single-program structure as the single-chip engine (ops/newton.py).

    Row padding (to make both row counts divide the mesh) is inert by
    construction: padded C rows are zero with slack 1 (no barrier force),
    padded A rows are zero with b = 0 and get +1 on the Schur diagonal so
    S stays SPD with w = 0 on the padding.

    Absent bounds enter as ±inf arrays: every bound term (1/(ub-x),
    1/(ub-x)^2, (ub-x)/dx limits, candidate slacks) evaluates to the
    correct no-op limit in IEEE arithmetic, so one compiled program
    serves all four bound configurations.

    ``has_P`` switches the objective to the QP ½xᵀPx + cᵀx (reference:
    QPSolver.py solves the same KKT system with H += t·P); P enters
    replicated — it joins the replicated factorization, so sharding its
    rows would only add communication.

    ``distributed_factor`` replaces the two replicated Cholesky factors
    (the serial Amdahl core of the iteration, binding scaling efficiency
    at high chip counts) with the cooperative block-cyclic factor of
    ``parallel/chol.py`` — trailing-update FLOPs split 1/ndev per chip.
    ``factor_dtype="float32"`` factors in f32 with Jacobi scaling (the
    mixed-precision strategy of the single-chip path, ops/kkt.py); the KKT
    iterative-refinement rounds against true f64 residuals then restore
    the direction, with one extra round to cover the larger factor
    error.  Both options leave the iterate math (residuals, line
    search, convergence tests) in full precision.
    """
    mixed = factor_dtype == "float32"
    _make_solve = make_factor_tools(axis, ndev, distributed_factor,
                                    chol_block)

    def prog(c, Pm, A, b, C, d, lb, ub, x0, v0, t0v, max_outer):
        # max_outer is a traced operand (not a static), so the chunked
        # checkpoint loop can run exactly the remaining stage budget
        # without recompiling per chunk size.
        dtype = x0.dtype
        sig = jnp.asarray(beta, dtype) ** jnp.arange(J, dtype=dtype)

        def newton_body(t, s):
            x, v, it, resid, done, success = s
            s_C = d - C @ x
            inv_C = 1.0 / (s_C + SLACK_EPS)
            g = lax.psum(C.T @ inv_C, axis)
            grad0 = (Pm @ x + c) if has_P else c   # ∇f0 (replicated)
            g = g + t * grad0 + 1.0 / (ub - x + SLACK_EPS) \
                - 1.0 / (x - lb + SLACK_EPS)

            H = lax.psum(C.T @ (inv_C[:, None] ** 2 * C), axis)
            db = (1.0 / (ub - x + SLACK_EPS) ** 2
                  + 1.0 / (x - lb + SLACK_EPS) ** 2)
            H = H + jnp.diag(db)
            if has_P:
                H = H + t * Pm

            rpri_local = A @ x - b
            m_local = A.shape[0]
            idx = lax.axis_index(axis) * m_local
            gather0 = lambda u: lax.all_gather(u, axis, axis=0, tiled=True)

            def _kkt_apply(dx, w_l):
                """True KKT operator at (dx, w): (H dx + Aᵀw, A dx)."""
                Hdx = lax.psum(C.T @ (inv_C**2 * (C @ dx)), axis) + db * dx
                if has_P:
                    Hdx = Hdx + t * (Pm @ dx)
                return Hdx + lax.psum(A.T @ w_l, axis), A @ dx

            def _direction(f32_factor):
                """Factor H and the Schur complement (replicated or
                cooperative, f64 or Jacobi-scaled f32) and run the block
                elimination + iterative refinement for (dx, w)."""
                solve = _make_solve(H, dtype, f32_factor)
                Y_local = solve(A.T)               # (n, m_local) panel
                Y = lax.all_gather(Y_local, axis, axis=1, tiled=True)
                S_rows = A @ Y                     # (m_local, m) rows
                S = lax.all_gather(S_rows, axis, axis=0, tiled=True)
                S = 0.5 * (S + S.T)
                mg = S.shape[0]
                # +1 diagonal on padded equality rows keeps S SPD (their
                # rhs is 0 so w stays 0 there); the trace-relative jitter
                # keeps the factor finite at deep barrier stages where
                # the A·H^-1·A^T roundoff turns S numerically indefinite
                # (the distributed analogue of ops/kkt.py
                # robust_cholesky).
                pad_diag = (jnp.arange(mg) >= m_true).astype(dtype)
                jit_s = 1e-13 * jnp.max(jnp.diag(S))
                S = S + jnp.diag(pad_diag + jit_s)
                solve_S = _make_solve(S, dtype, f32_factor)

                # block elimination: S w = A H^-1 r1 - r2 at [r1; r2] =
                # [-g; -rpri] (reference:
                # NewtonSolverInfeasibleStart.py:386-511)
                rhs = gather0(rpri_local) - gather0(A @ solve(g))
                w = solve_S(rhs)
                w_local = lax.dynamic_slice_in_dim(w, idx, m_local)
                dx = -solve(g + lax.psum(A.T @ w_local, axis))

                # KKT iterative refinement (factors reused): the ill-
                # conditioned deep-stage H makes one elimination pass
                # drift off the equality manifold; correcting against
                # the TRUE residuals restores it while
                # kappa(H)*eps_factor < 1 (one extra round covers the
                # larger f32 factor error).
                for _ in range(3 if f32_factor else 2):
                    w_l = lax.dynamic_slice_in_dim(w, idx, m_local)
                    dual, Adx = _kkt_apply(dx, w_l)
                    r1 = -g - dual
                    r2_local = -rpri_local - Adx
                    f = solve_S(gather0(A @ solve(r1)) - gather0(r2_local))
                    f_l = lax.dynamic_slice_in_dim(f, idx, m_local)
                    e = solve(r1 - lax.psum(A.T @ f_l, axis))
                    dx = dx + e
                    w = w + f
                return dx, w

            if mixed:
                dx, w = _direction(True)
                # f32-factor stall detection: refinement converges only
                # while kappa(H)*eps32 < 1; at deep barrier stages it
                # diverges and the direction is unusable.  Check the
                # TRUE post-refinement KKT residual (replicated, so the
                # cond predicate is uniform across chips) and redo the
                # step with the exact-f64 factor when it stalled — the
                # distributed analogue of ops/kkt.py's
                # refinement-stall escalation.
                w_l = lax.dynamic_slice_in_dim(w, idx, m_local)
                dual, _ = _kkt_apply(dx, w_l)
                r1n = jnp.sum((g + dual) ** 2)
                r2n = lax.psum(jnp.sum((rpri_local + A @ dx) ** 2), axis)
                scale = (jnp.sum(g**2)
                         + lax.psum(jnp.sum(rpri_local**2), axis)
                         + jnp.asarray(1e-300, dtype))
                ok = (r1n + r2n) < 1e-16 * scale
                dx, w = lax.cond(ok, lambda _: (dx, w),
                                 lambda _: _direction(False), None)
            else:
                dx, w = _direction(False)

            dv = w - v

            # --- residual-backtracking candidate sweep (the distributed
            # form of ops/newton.py newton_infeasible's ls_grads path) ----
            v_local = lax.dynamic_slice_in_dim(v, idx, m_local)
            ATv = lax.psum(A.T @ v_local, axis)
            ATdv = lax.psum(
                A.T @ lax.dynamic_slice_in_dim(dv, idx, m_local), axis)
            Adx_local = A @ dx
            ds_C = C @ dx

            r0 = jnp.sqrt(jnp.sum((g + ATv) ** 2)
                          + lax.psum(jnp.sum(rpri_local**2), axis))

            # domain: largest sigma keeping every slack positive
            umax_local = jnp.max(
                jnp.where(s_C > 0, ds_C / (s_C + SLACK_EPS), jnp.inf))
            umax = lax.pmax(umax_local, axis)
            ub_u = jnp.max(jnp.where(dx > 0, dx / (ub - x + SLACK_EPS),
                                     0.0))
            lb_u = jnp.max(jnp.where(dx < 0, -dx / (x - lb + SLACK_EPS),
                                     0.0))
            umax = jnp.maximum(umax, jnp.maximum(ub_u, lb_u))
            domain = sig * umax < 1.0 - 1e-9

            # candidate dual residuals: barrier part psum-reduced
            cand_inv = 1.0 / (s_C[:, None] - sig[None, :] * ds_C[:, None]
                              + SLACK_EPS)                    # (k_l, J)
            gb_cand = lax.psum(C.T @ cand_inv, axis)           # (n, J)
            xc = x[:, None] + sig[None, :] * dx[:, None]       # (n, J)
            if has_P:
                # ∇f0(xc) = P x + σ P dx + c: one P dx matvec covers all J
                Pdx = Pm @ dx
                grad0_cand = (grad0[:, None] + sig[None, :] * Pdx[:, None])
            else:
                grad0_cand = c[:, None]
            g_cand = (gb_cand + t * grad0_cand
                      + 1.0 / (ub[:, None] - xc + SLACK_EPS)
                      - 1.0 / (xc - lb[:, None] + SLACK_EPS))
            r_dual = g_cand + ATv[:, None] + sig[None, :] * ATdv[:, None]
            pri_sq = lax.psum(jnp.sum(
                (rpri_local[:, None] + sig[None, :] * Adx_local[:, None])
                ** 2, axis=0), axis)
            rn = jnp.sqrt(jnp.sum(r_dual**2, axis=0) + pri_sq)

            accept = domain & (rn <= (1.0 - alpha * sig) * r0)
            any_acc = jnp.any(accept)
            j = jnp.argmax(accept)
            sigma = jnp.where(any_acc, sig[j], jnp.zeros((), dtype))

            # guard against 0 * non-finite dx when every candidate is
            # rejected (a failed factor must stall the stage, not poison
            # the iterate)
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
            # duality gap after centering at t (reference: LPSolver.py:629)
            done = jnp.asarray(num_ineq, dtype) / t < eps
            return (x, v, t * mu, it + 1, total_nt + nt, done)

        def outer_cond(s):
            return (~s[5]) & (s[3] < max_outer)

        out = lax.while_loop(
            outer_cond, outer_body,
            (x0, v0, t0v, jnp.zeros((), jnp.int32),
             jnp.zeros((), jnp.int32), jnp.zeros((), bool)))
        x, v, t_fin, outer_it, total_nt, done = out
        obj = c @ x + (0.5 * x @ (Pm @ x) if has_P else 0.0)
        return x, v, obj, outer_it, total_nt, t_fin, done

    spec_rows = P(axis, None)
    spec_vec_rows = P(axis)
    rep = P()
    return jax.jit(shard_map(
        highest_precision(prog), mesh=mesh,
        in_specs=(rep, rep, spec_rows, spec_vec_rows, spec_rows,
                  spec_vec_rows, rep, rep, rep, rep, rep, rep),
        out_specs=(rep, rep, rep, rep, rep, rep, rep),
        check_vma=False,
    ))


def solve_lp_row_sharded(mesh: Mesh, c, A, b, C, d, lb=None, ub=None, *,
                         x0=None, t0=1.0, mu=15.0, epsilon=1e-8,
                         inner_epsilon=1e-8, alpha=0.2, beta=0.6,
                         max_linesearch_steps=40, max_outer_iters=30,
                         max_inner_iters=60, axis: str = "rows",
                         distributed_factor=False,
                         factor_dtype="float64", chol_block=256,
                         phase1="auto", checkpoint_path=None,
                         checkpoint_every=1, resume=False,
                         algorithm="barrier", pd_max_iters=60):
    """Full distributed LP barrier solve with constraint rows sharded over
    the mesh: min c.x s.t. Ax = b, Cx <= d, lb <= x <= ub.

    ``algorithm="pd"`` dispatches to the distributed Mehrotra
    predictor-corrector (``parallel.pd_dist.solve_pd_row_sharded``):
    15–40 iterations instead of the barrier's Newton-step count, no
    phase one.  The barrier-only knobs (t0, mu, inner tolerances, line
    search, checkpointing) do not apply there.

    The complete IPM (outer t-loop, infeasible-start Newton,
    residual-backtracking candidate line search) runs as ONE jitted
    shard_map program; cross-chip communication is the psum/all_gather/
    pmax reductions marked in ``_row_sharded_barrier``.  Neither row count
    needs to divide the mesh (rows are padded with inert entries) and
    bounds are optional (absent bounds become ±inf, whose IEEE limits
    make every bound term a no-op) — the two restrictions of the
    single-step demo ``row_sharded_lp_newton_step``.

    ``x0`` defaults to the bound midpoint or zeros; with ``phase1="auto"``
    (the default) a start that is not strictly feasible for the
    inequalities triggers the distributed phase one
    (``_row_sharded_phase1`` — the same sharded barrier program on the
    min-s extended LP), which raises ValueError when the problem is
    infeasible.  Returns a dict with x, v (true equality rows),
    objective and iteration counters.

    ``distributed_factor=True`` factors H and S cooperatively across the
    mesh (parallel/chol.py) instead of replicating the Cholesky;
    ``factor_dtype="float32"`` uses the mixed-precision factor path
    (see ``_row_sharded_barrier``).

    ``checkpoint_path`` enables mid-solve checkpointing: the outer loop
    runs in host-stepped chunks of min(``checkpoint_every``, remaining
    stage budget) barrier stages and the full resumable state is
    persisted (atomic .npz, process 0 only on multi-host meshes)
    between chunks; ``resume=True`` continues a killed job from its
    last completed chunk without re-running phase one.  A job killed
    DURING phase one resumes the phase-1 barrier itself from the
    ``checkpoint_path + ".p1"`` sidecar.  Checkpoints are tied to the
    problem data — delete the files when the data changes (resuming
    against perturbed data restarts the barrier schedule from a fresh
    phase-1 point).  Without a checkpoint path the whole solve is ONE
    device program (zero host round-trips).
    """
    if algorithm == "pd":
        if checkpoint_path is not None:
            raise ValueError("algorithm='pd' does not support mid-solve "
                             "checkpointing (solves are 15-40 iterations)")
        from .pd_dist import solve_pd_row_sharded
        return solve_pd_row_sharded(
            mesh, c, A, b, C, d, lb, ub, x0=x0, epsilon=epsilon,
            max_iters=pd_max_iters, axis=axis,
            distributed_factor=distributed_factor,
            factor_dtype=factor_dtype, chol_block=chol_block)
    if algorithm != "barrier":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return _solve_row_sharded(
        mesh, None, c, A, b, C, d, lb, ub, x0=x0, t0=t0, mu=mu,
        epsilon=epsilon, inner_epsilon=inner_epsilon, alpha=alpha,
        beta=beta, max_linesearch_steps=max_linesearch_steps,
        max_outer_iters=max_outer_iters, max_inner_iters=max_inner_iters,
        axis=axis, distributed_factor=distributed_factor,
        factor_dtype=factor_dtype, chol_block=chol_block, phase1=phase1,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume)


def solve_qp_row_sharded(mesh: Mesh, P_obj, c, A, b, C, d, lb=None,
                         ub=None, *, x0=None, t0=1.0, mu=15.0,
                         epsilon=1e-8, inner_epsilon=1e-8, alpha=0.2,
                         beta=0.6, max_linesearch_steps=40,
                         max_outer_iters=30, max_inner_iters=60,
                         axis: str = "rows", distributed_factor=False,
                         factor_dtype="float64", chol_block=256,
                         phase1="auto", checkpoint_path=None,
                         checkpoint_every=1, resume=False,
                         algorithm="barrier", pd_max_iters=60):
    """Distributed QP barrier solve: min ½xᵀPx + cᵀx s.t. Ax = b,
    Cx ≤ d, lb ≤ x ≤ ub, with constraint rows sharded over the mesh.

    Same single-program structure as ``solve_lp_row_sharded``
    (including mid-solve checkpoint/resume and the ``algorithm="pd"``
    Mehrotra dispatch); P (PSD) stays replicated — it feeds the
    replicated H factorization, and each chip's candidate sweep reuses
    one P·dx matvec across all J backtracking candidates.
    (Reference QP semantics: QPSolver.py; the distribution scheme is
    new capability.)
    """
    if algorithm == "pd":
        if checkpoint_path is not None:
            raise ValueError("algorithm='pd' does not support mid-solve "
                             "checkpointing (solves are 15-40 iterations)")
        from .pd_dist import solve_pd_row_sharded
        return solve_pd_row_sharded(
            mesh, c, A, b, C, d, lb, ub, P_obj=P_obj, x0=x0,
            epsilon=epsilon, max_iters=pd_max_iters, axis=axis,
            distributed_factor=distributed_factor,
            factor_dtype=factor_dtype, chol_block=chol_block)
    if algorithm != "barrier":
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return _solve_row_sharded(
        mesh, P_obj, c, A, b, C, d, lb, ub, x0=x0, t0=t0, mu=mu,
        epsilon=epsilon, inner_epsilon=inner_epsilon, alpha=alpha,
        beta=beta, max_linesearch_steps=max_linesearch_steps,
        max_outer_iters=max_outer_iters, max_inner_iters=max_inner_iters,
        axis=axis, distributed_factor=distributed_factor,
        factor_dtype=factor_dtype, chol_block=chol_block, phase1=phase1,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume)


def _row_sharded_phase1(mesh, A, b, C, d, lb_v, ub_v, x0, *, axis,
                        distributed_factor, factor_dtype, chol_block,
                        checkpoint_path=None, checkpoint_every=1,
                        resume=False):
    """Distributed phase one: find a strictly feasible point for
    Cx ≤ d (within the box) by solving the extended LP

        min s   s.t.  Ax = b,  Cx − s·1 ≤ d,  lb ≤ x ≤ ub

    with the SAME row-sharded barrier program (the s column rides along
    replicated; the extended start (x₀ clamped into the box, s₀ =
    max(Cx₀ − d) + 1) is strictly feasible by construction — the
    distributed analogue of models/phase1.py; reference:
    LPSolver.py phase-1 routing).  Returns a strictly feasible x, or
    raises ValueError when the optimum s* ≥ 0 certifies infeasibility.
    """
    import numpy as np

    n = x0.shape[0]
    dtype = x0.dtype
    # interior-of-box start for the x block
    lo = jnp.maximum(lb_v, -1e12)
    hi = jnp.minimum(ub_v, 1e12)
    x0c = jnp.clip(x0, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    s0 = jnp.maximum(jnp.max(C @ x0c - d) + 1.0, 0.0)

    # s is bounded below at -1: min s is otherwise unbounded whenever the
    # feasible region is (s* < 0 is all the certificate needs, and the
    # single-chip engine's early exit on s < -tol, ops/newton.py, has no
    # distributed analogue — the bound plays that terminating role).
    c_ext = jnp.zeros((n + 1,), dtype).at[n].set(1.0)
    A_ext = jnp.concatenate([A, jnp.zeros((A.shape[0], 1), dtype)], axis=1)
    C_ext = jnp.concatenate([C, -jnp.ones((C.shape[0], 1), dtype)], axis=1)
    lb_ext = jnp.concatenate([lb_v, jnp.asarray([-1.0], dtype)])
    ub_ext = jnp.concatenate([ub_v, jnp.asarray([jnp.inf], dtype)])
    z0 = jnp.concatenate([x0c, s0[None]])

    res = _solve_row_sharded(
        mesh, None, c_ext, A_ext, b, C_ext, d, lb_ext, ub_ext, x0=z0,
        t0=1.0, mu=15.0, epsilon=1e-6, inner_epsilon=1e-8, alpha=0.2,
        beta=0.6, max_linesearch_steps=40, max_outer_iters=30,
        max_inner_iters=60, axis=axis,
        distributed_factor=distributed_factor, factor_dtype=factor_dtype,
        chol_block=chol_block, phase1=False,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every, resume=resume)
    z = np.asarray(res["x"])
    if not np.isfinite(z).all() or z[n] >= 0:
        raise ValueError(
            "Phase 1 did not find a strictly feasible point (optimal "
            f"infeasibility s* = {z[n]:.3e} >= 0): problem infeasible")
    x1 = z[:n]
    # re-validate before handing the point to the main solve: s* < 0
    # should imply strict slack positivity, but a stalled deep-barrier
    # stage can still return a boundary-grazing iterate.
    slack_min = min(
        float(np.min(d - C @ x1)) if C.shape[0] else np.inf,
        float(np.min(np.asarray(ub_v) - x1)),
        float(np.min(x1 - np.asarray(lb_v))))
    if not slack_min > 0:
        raise ValueError(
            "Phase 1 terminated with s* < 0 but a non-positive slack "
            f"(min slack {slack_min:.3e}); the problem is feasible but "
            "barely — tighten phase-1 epsilon or supply a feasible x0")
    return jnp.asarray(x1, dtype)


def _solve_row_sharded(mesh, P_obj, c, A, b, C, d, lb, ub, *, x0, t0, mu,
                       epsilon, inner_epsilon, alpha, beta,
                       max_linesearch_steps, max_outer_iters,
                       max_inner_iters, axis, distributed_factor=False,
                       factor_dtype="float64", chol_block=256,
                       phase1="auto", checkpoint_path=None,
                       checkpoint_every=1, resume=False):
    from ..models.base import ensure_x64
    ensure_x64("float64")  # every other public entry point forces x64 too
    ndev = mesh.shape[axis]
    c = jnp.asarray(c, jnp.float64)
    n = c.shape[0]
    dtype = c.dtype
    A = jnp.asarray(A, dtype)
    b = jnp.asarray(b, dtype)
    C = jnp.asarray(C, dtype)
    d = jnp.asarray(d, dtype)
    m_true, k_true = A.shape[0], C.shape[0]
    num_ineq = k_true + (n if lb is not None else 0) \
        + (n if ub is not None else 0)

    # at least one (inert) row per shard: m_true == 0 (no equalities) or
    # k_true == 0 (no inequalities) must not produce zero-size shards —
    # the padding is a no-op by construction, so a whole padded block
    # simply runs the same program with every row inert.
    mp = max(-(-m_true // ndev) * ndev, ndev)
    kp = max(-(-k_true // ndev) * ndev, ndev)
    A_p = _pad_rows(A, mp)
    b_p = _pad_rows(b, mp)
    C_p = _pad_rows(C, kp)
    d_p = _pad_rows(d, kp, fill=1.0)   # padded slack fixed at 1

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

    # resume from a mid-solve checkpoint: the stored iterate replaces x0
    # BEFORE the feasibility gate (it is strictly feasible for the data
    # it was written against, so phase one is skipped rather than re-run
    # on the original infeasible start)
    ck_state = _load_checkpoint(checkpoint_path, resume)
    if ck_state is not None:
        x0 = jnp.asarray(ck_state["x"], dtype)

    # strict-feasibility gate: the barrier needs every slack positive at
    # the start; restore it with the distributed phase one when needed
    # (the single-chip drivers' phase-1 routing, LPSolver.py:514-560).
    # phase1=True is treated as "auto"; only phase1=False skips the gate.
    if phase1 == "auto" or phase1 is True:
        slack_min = float(jnp.min(jnp.concatenate([
            d - C @ x0 if k_true else jnp.asarray([jnp.inf], dtype),
            ub_v - x0, x0 - lb_v])))
        if not slack_min > 0:
            x0 = _row_sharded_phase1(
                mesh, A, b, C, d, lb_v, ub_v, x0, axis=axis,
                distributed_factor=distributed_factor,
                factor_dtype=factor_dtype, chol_block=chol_block,
                # killed-during-phase-1 jobs resume the phase-1 barrier
                # itself from its own sidecar checkpoint
                checkpoint_path=(None if checkpoint_path is None
                                 else checkpoint_path + ".p1"),
                checkpoint_every=checkpoint_every, resume=resume)
            # the gate firing on a RESUMED iterate means the problem
            # data changed since the checkpoint was written: the stored
            # (v, t, counters) no longer describe this barrier
            # trajectory, so restart the schedule from the fresh
            # phase-1 point instead of resuming into an inconsistent
            # state.
            ck_state = None
    v0 = jnp.zeros((mp,), dtype)

    has_P = P_obj is not None
    # the (1, 1) placeholder keeps one positional signature; has_P is
    # static, so the no-P program never touches it
    Pm = (jnp.asarray(P_obj, dtype) if has_P
          else jnp.zeros((1, 1), dtype))

    prog = _row_sharded_barrier(
        mesh, axis, m_true=m_true, k_true=k_true, num_ineq=num_ineq,
        mu=float(mu), eps=float(epsilon),
        inner_eps=float(inner_epsilon), alpha=float(alpha),
        beta=float(beta), J=int(max_linesearch_steps),
        max_inner=int(max_inner_iters),
        has_P=has_P, distributed_factor=bool(distributed_factor),
        factor_dtype=factor_dtype, chol_block=int(chol_block), ndev=ndev)

    operands = (c, Pm, shard_rows(mesh, A_p, axis),
                shard_rows(mesh, b_p, axis), shard_rows(mesh, C_p, axis),
                shard_rows(mesh, d_p, axis), lb_v, ub_v)
    prog_call = lambda x, v, tv, mo: prog(
        *operands, x, v, tv, jnp.asarray(mo, jnp.int32))

    x, v, obj, outer_it, total_nt = _dispatch_barrier(
        prog_call, x0, v0, float(t0), dtype, int(max_outer_iters),
        checkpoint_path, int(checkpoint_every), ck_state)
    return dict(x=x, v=v[:m_true], objective=obj,
                outer_iters=outer_it, newton_iters=total_nt)


def _load_checkpoint(path, resume):
    """Load a mid-solve checkpoint dict, or None when not resuming /
    absent.  Checkpoints are tied to the problem data they were written
    against — delete the file (and its .p1 sidecar) when the data
    changes."""
    if path is None or not resume or not os.path.exists(path):
        return None
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _dispatch_barrier(prog_call, x0, v0, t0, dtype, max_outer,
                      path, checkpoint_every, ck_state):
    """Run the distributed barrier program, either as ONE device call
    (no checkpoint path) or as a host-chunked outer loop with atomic
    .npz checkpoints between chunks (the distributed analogue of the
    staged-dispatch mid-solve resume, utils/checkpoint.py).

    Each chunk runs exactly ``min(checkpoint_every, remaining budget)``
    barrier stages — ``max_outer_iters`` is never overshot — and the
    full resumable state (x, v, t, counters, objective, converged) is
    persisted between chunks; a killed job continues from its last
    completed chunk via ``resume=True``.  On multi-host meshes only
    process 0 writes (every process executes the same device program,
    so the state is identical); resume expects the file visible to all
    processes (shared filesystem) or an identical copy per host.

    Shared by the row-sharded LP/QP and cone-sharded SOCP solvers."""
    import numpy as np

    from ..utils.checkpoint import _atomic_savez

    if path is None:
        x, v, obj, outer_it, total_nt, _, _ = prog_call(
            x0, v0, jnp.asarray(t0, dtype), max_outer)
        return x, v, obj, int(outer_it), int(total_nt)

    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    outer_it, total_nt = 0, 0
    t_cur = t0
    obj, done = None, False
    if ck_state is not None:
        x0 = jnp.asarray(ck_state["x"])
        v0 = jnp.asarray(ck_state["v"])
        t_cur = float(ck_state["t"])
        outer_it = int(ck_state["outer_iters"])
        total_nt = int(ck_state["newton_iters"])
        obj = float(ck_state["objective"])
        done = bool(ck_state["done"])
    x, v = x0, v0
    is_writer = jax.process_index() == 0
    while not done and outer_it < max_outer:
        stages = min(checkpoint_every, max_outer - outer_it)
        x, v, obj, oit, nt, t_fin, dflag = prog_call(
            x, v, jnp.asarray(t_cur, dtype), stages)
        outer_it += int(oit)
        total_nt += int(nt)
        t_cur = float(t_fin)
        done = bool(dflag)
        if is_writer:
            _atomic_savez(path, dict(
                x=np.asarray(x), v=np.asarray(v), t=np.asarray(t_cur),
                outer_iters=np.asarray(outer_it),
                newton_iters=np.asarray(total_nt),
                objective=np.asarray(float(obj)), done=np.asarray(done)))
    if obj is None:
        # loop never ran (max_outer_iters=0 with no prior checkpoint):
        # fetch the device-computed objective of the start iterate with
        # a zero-stage call, matching the non-checkpointed path.
        x, v, obj, _, _, _, _ = prog_call(x, v, jnp.asarray(t_cur, dtype), 0)
    return x, v, obj, outer_it, total_nt
