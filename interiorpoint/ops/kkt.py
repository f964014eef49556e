"""KKT linear-solve strategies for the Newton engines.

The reference implements a zoo of 16+ Newton subclasses, one per
(linear-solve method × diagonal-Hessian × equality-constrained) combination
(reference: LPSolver.py:371-469, NewtonSolver.py:212-420,
NewtonSolverInfeasibleStart.py:279-956).  Here the zoo collapses to a single
``solve_kkt_eq``/``solve_newton_step`` pair with a trace-time strategy
string; the equality block is handled by the same Schur-complement block
elimination the reference uses
(reference: NewtonSolverInfeasibleStart.py:356-538):

    [[H  Aᵀ] [dx]     [g      ]          H·Y = [Aᵀ | g]
     [A  0 ]][w ] = − [Ax − b ]   ⇒      S = A·H⁻¹Aᵀ,  S·w = (Ax−b) − A·H⁻¹g
                                          dx = −H⁻¹(g + Aᵀw)

Failure handling (SURVEY.md §7 hard part (b)): the reference catches
``LinAlgError`` from a failed Cholesky and flips to a dense LU/lstsq backup
for the rest of the solve (reference: NewtonSolverInfeasibleStart.py:392-538).
Under ``jit`` there are no exceptions, so the 'cholesky' strategy instead
detects a non-finite factor and retries with escalating diagonal
regularization (jitter ladder) inside a while_loop: same
recovery intent, no host round trip, pure Cholesky all the way down, and
well-defined under vmap.  If every ladder rung fails, NaNs propagate and the
line search rejects all candidates — reproducing the reference's
"LinAlgError → success_flag=False" behaviour
(reference: NewtonSolverInfeasibleStart.py:161-168) without exceptions.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

# Jitter ladder, as multiples of mean(diag(H)): first rung 0 is the plain
# factorization; later rungs regularize progressively harder.
_JITTERS = (0.0, 1e-14, 1e-11, 1e-8, 1e-5, 1e-2)


def robust_cholesky(H):
    """Cholesky with an escalating-jitter retry ladder.

    Returns the factor of H + δ·mean(diag H)·I for the smallest ladder δ
    that yields a finite factor (δ=0 first).  All-NaN if every rung fails.
    """
    n = H.shape[0]
    scale = jnp.mean(jnp.diag(H))
    eye = jnp.eye(n, dtype=H.dtype)
    jitters = jnp.asarray(_JITTERS, dtype=H.dtype)

    L0 = jnp.linalg.cholesky(H)

    def cond(carry):
        i, L = carry
        return (~jnp.all(jnp.isfinite(L))) & (i < len(_JITTERS))

    def body(carry):
        i, _ = carry
        L = jnp.linalg.cholesky(H + (jitters[i] * scale) * eye)
        return i + 1, L

    _, L = lax.while_loop(cond, body, (jnp.ones((), jnp.int32), L0))
    return L


def chol_solve(L, B):
    """Solve (L Lᵀ) X = B via two triangular solves
    (reference: NewtonSolverInfeasibleStart.py:399-452 does the same with
    cupyx solve_triangular)."""
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    Y = jax.scipy.linalg.solve_triangular(L, B, lower=True)
    X = jax.scipy.linalg.solve_triangular(L.T, Y, lower=False)
    return X[:, 0] if vec else X


def _refine(solve_fn, H, B, X, steps: int):
    """Iterative refinement: X += M⁻¹(B − H X), recovering accuracy lost in
    a low-precision factorization.  New capability (no reference analogue);
    enabled via SolverConfig.refine_steps."""
    for _ in range(steps):
        R = B - H @ X
        X = X + solve_fn(R)
    return X


# ---------------------------------------------------------------------------
# Mixed-precision positive-definite solve (SolverConfig.mixed_precision, the
# default for float64 solves).
#
# Classical mixed-precision iterative refinement on a Jacobi-scaled system:
# with D = diag(H)^(-1/2), the scaled Hs = D·H·D is PSD with unit diagonal,
# so every entry lies in [-1, 1] — no float32 overflow regardless of how
# ill-scaled the barrier terms get — and the barrier Hessian's dominant
# (diagonal) ill-conditioning is removed before the float32 factorization
# sees it.  Refinement residuals are computed in float64 against the
# float64 Hs, restoring ~f64 solution accuracy in a few matmul-cheap
# iterations; a native f64 factorization takes over when refinement
# stalls (κ(Hs)·eps32 ≳ 1).  Whether this beats a plain f64 Cholesky on a
# given device is a benchmark question, not an assumption.
#
# The float32 work here is a Cholesky and triangular solves — no
# dot_general — and every product against H runs in float64, so the
# solution's accuracy does not depend on the device's float32 matmul
# precision (tests/test_utils.py checks it across condition numbers).
# ---------------------------------------------------------------------------

_MIXED_MAX_REFINE = 20
_MIXED_RTOL = 1e-13


def mixed_posdef_prepare(H):
    """Factor H (f64) once for repeated right-hand sides: Jacobi scale +
    f32 Cholesky of the scaled system.  Returns ``(d, Hs, L32)``
    consumed by ``mixed_posdef_factor_solve`` — the factor-reuse form of
    ``mixed_posdef_solve`` (used by the primal-dual engine, ops/pd.py,
    whose predictor and corrector share one factorization per iteration)."""
    dtype = H.dtype
    dg = jnp.diagonal(H)
    d = 1.0 / jnp.sqrt(jnp.maximum(dg, jnp.finfo(dtype).tiny))
    Hs = H * d[:, None] * d[None, :]
    L32 = robust_cholesky(Hs.astype(jnp.float32))
    return d, Hs, L32


def mixed_posdef_factor_solve(fac, B, extra_refine: int = 0,
                              exact_fallback: bool = True):
    """Solve H X = B given ``fac = mixed_posdef_prepare(H)``: adaptive f64
    iterative refinement against the scaled f64 system, with the exact-f64
    refactorization fallback when refinement stalls (κ(Hs)·eps32 ≳ 1).

    ``exact_fallback=False`` skips that fallback and returns the refined
    iterate as-is (relative residual typically ~κ·eps32² on a stall)."""
    d, Hs, L32 = fac
    dtype = Hs.dtype

    vec = B.ndim == 1
    Bs = (d * B) if vec else (d[:, None] * B)

    def solve32(R):
        return chol_solve(L32, R.astype(jnp.float32)).astype(dtype)

    bnorm = jnp.linalg.norm(Bs)
    max_steps = _MIXED_MAX_REFINE + extra_refine

    X0 = solve32(Bs)
    R0 = Bs - Hs @ X0
    rn0 = jnp.linalg.norm(R0)

    def cond(c):
        i, X, R, rn = c
        return (rn > _MIXED_RTOL * bnorm) & (i < max_steps) & jnp.isfinite(rn)

    def body(c):
        i, X, R, _ = c
        X = X + solve32(R)
        R = Bs - Hs @ X
        return i + 1, X, R, jnp.linalg.norm(R)

    _, X, _, rn = lax.while_loop(cond, body,
                                 (jnp.zeros((), jnp.int32), X0, R0, rn0))

    # Refinement stalls once κ(Hs)·eps32 ≳ 1 (deep barrier iterations with
    # huge t).  Fall back to the exact f64 factorization only then — the
    # slow path runs for a handful of final Newton steps instead of all of
    # them.  (Under vmap this cond lowers to a select and both branches
    # execute; batched solves trade that cost for correctness.)
    def exact(_):
        L = robust_cholesky(Hs)
        return chol_solve(L, Bs)

    # A float32 solve at κ(Hs)·eps32 ≫ 1 can overflow, leaving rn NaN:
    # that too must take the fallback, so the test is "not converged".
    if exact_fallback:
        X = lax.cond(~(rn <= 1e-10 * bnorm), exact, lambda _: X, None)
    return (d * X) if vec else (d[:, None] * X)


def mixed_posdef_solve(H, B, extra_refine: int = 0):
    """Solve H X = B (f64) via Jacobi-scaled f32 Cholesky + adaptive f64
    iterative refinement (runs until the f64 residual stops improving past
    _MIXED_RTOL relative, capped at _MIXED_MAX_REFINE + extra_refine)."""
    return mixed_posdef_factor_solve(mixed_posdef_prepare(H), B,
                                     extra_refine)


def posdef_solver(H, mixed: bool, exact_fallback: bool = True):
    """Factor H once and return a ``solve(rhs)`` closure: the mixed
    Jacobi-scaled f32 + f64-refinement path when ``mixed`` and H is f64,
    else a robust (jitter-ladder) native Cholesky.  The shared factor
    dispatch of the primal-dual engines (ops/pd.py, ops/socp_pd.py);
    see ``mixed_posdef_factor_solve`` for ``exact_fallback``."""
    if mixed and H.dtype == jnp.float64:
        fac = mixed_posdef_prepare(H)
        return lambda rhs: mixed_posdef_factor_solve(
            fac, rhs, exact_fallback=exact_fallback)
    L = robust_cholesky(H)
    return lambda rhs: chol_solve(L, rhs)


def matrix_free_prepare(H_pre, dtype):
    """Factor the preconditioner-grade assembly once for repeated
    ``matrix_free_prepared_solve`` calls: Jacobi scaling, f32 factor of
    the scaled system, and the diagonally-shifted backup factor the
    second PCG escalation uses.  ``dtype`` is the f64 working dtype of
    the right-hand sides."""
    dg = jnp.diagonal(H_pre).astype(dtype)
    dsc = 1.0 / jnp.sqrt(jnp.maximum(dg, jnp.finfo(dtype).tiny))
    dsc32 = dsc.astype(jnp.float32)
    Hs32 = H_pre.astype(jnp.float32) * dsc32[:, None] * dsc32[None, :]
    L32 = robust_cholesky(Hs32)
    eye32 = jnp.eye(Hs32.shape[0], dtype=jnp.float32)
    Lsh = robust_cholesky(Hs32 + jnp.float32(1e-6) * eye32)
    return dsc, L32, Lsh


def matrix_free_prepared_solve(fac, apply_h, b, *, pcg_iters: int = 48,
                               pcg_rounds: int = 3, rtol: float = 1e-10):
    """Solve H x = b given ``fac = matrix_free_prepare(H_pre)`` — a
    factor of a preconditioner-grade assembly (any float dtype; may be
    f32-accurate or slightly indefinite) — and ``apply_h``, the TRUE
    operator applied matrix-free in f64.

    The f32 factor of the Jacobi-scaled system is only a preconditioner:
    accuracy comes entirely from f64 refinement residuals against
    ``apply_h``.  When plain refinement stalls (kappa·eps32 > 1),
    preconditioned CG takes over; there is NO exact-f64 fallback (the
    accurate H is never factored).  The factor is reused across the many
    solves one Mehrotra direction needs (ops/socp_pd.py with
    ``exact_fallback=False``).  ``rtol``: scaled-residual target the
    escalations chase.

    Returns ``(x, rel_resid)``.
    """
    dtype = b.dtype
    dsc, L32, Lsh = fac

    def prec(r):
        """Scaled-space preconditioner solve of a f64 residual."""
        y = chol_solve(L32, (r * dsc).astype(jnp.float32)).astype(dtype)
        return y * dsc

    bnorm = jnp.linalg.norm(b * dsc)
    x0 = prec(b)
    r0 = b - apply_h(x0)
    rn0 = jnp.linalg.norm(r0 * dsc)

    # Refinement diverges outright once kappa(Hs)·eps32 > 1 (each sweep
    # multiplies the error by ~kappa·eps32), so each sweep is accepted
    # only if it reduced the scaled residual; on the first non-improving
    # sweep we stop with the best iterate and let PCG take over.
    def cond(c):
        i, x, r, rn, go = c
        return go & (rn > _MIXED_RTOL * bnorm) & (i < _MIXED_MAX_REFINE) \
            & jnp.isfinite(rn)

    def body(c):
        i, x, r, rn, _ = c
        x2 = x + prec(r)
        r2 = b - apply_h(x2)
        rn2 = jnp.linalg.norm(r2 * dsc)
        better = jnp.isfinite(rn2) & (rn2 < rn)
        x = jnp.where(better, x2, x)
        r = jnp.where(better, r2, r)
        rn_keep = jnp.where(better, rn2, rn)
        return i + 1, x, r, rn_keep, better

    _, x, r, rn, _ = lax.while_loop(
        cond, body,
        (jnp.zeros((), jnp.int32), x0, r0, rn0, jnp.ones((), bool)))

    # Stall escalation: preconditioned CG on the scaled f32 operator
    # (convergence ~ sqrt(kappa·eps32) instead of kappa·eps32), residuals
    # re-measured against the true operator after each round.
    def _pcg(r_vec, Lp, iters):
        """PCG on the TRUE operator in f64 (scaled space), f32 factor as
        the preconditioner.  Crucial detail: at kappa(Hs)·eps32 ≳ 1 the
        f32-rounded Hs itself is indefinite, so CG must iterate on the
        f64 matrix-free operator — only the preconditioner solve is f32."""
        rs = r_vec * dsc

        def As(v):
            return dsc * apply_h(dsc * v)

        def psolve(v):
            return chol_solve(Lp, v.astype(jnp.float32)).astype(dtype)

        z0 = psolve(rs)

        def pbody(_, c):
            xx, rr, z, p, rz = c
            Hp = As(p)
            denom = jnp.sum(p * Hp)
            a = rz / jnp.where(jnp.abs(denom) > 1e-300, denom, 1e-300)
            xx = xx + a * p
            rr = rr - a * Hp
            z = psolve(rr)
            rz2 = jnp.sum(rr * z)
            beta = rz2 / jnp.where(jnp.abs(rz) > 1e-300, rz, 1e-300)
            return xx, rr, z, p * beta + z, rz2

        out = lax.fori_loop(0, iters, pbody,
                            (jnp.zeros_like(rs), rs, z0, z0,
                             jnp.sum(rs * z0)))
        return dsc * out[0]

    def _pcg_update(c, Lp, iters):
        x, r, rn = c
        x2 = x + _pcg(r, Lp, iters)
        r2 = b - apply_h(x2)
        rn2 = jnp.linalg.norm(r2 * dsc)
        better = jnp.isfinite(rn2) & (rn2 < rn)
        return (jnp.where(better, x2, x), jnp.where(better, r2, r),
                jnp.where(better, rn2, rn))

    # Flat control flow: nesting these escalations in lax.cond branches
    # duplicates the big-matvec subgraphs in the program.  Instead the
    # PCG runs always exist once in the graph with a DYNAMIC trip count —
    # zero iterations when the refinement already converged.
    stalled = rn > rtol * bnorm
    x, r, rn = _pcg_update((x, r, rn), L32,
                           jnp.where(stalled, pcg_iters, 0))

    # Second escalation with the diagonally-shifted factor (computed in
    # matrix_free_prepare, just above the f32 rounding perturbation
    # ~eps32·‖Hs‖): the shifted M majorizes Hs despite rounding (a
    # merely-rounded factor can fail to), at the price of
    # κ_eff ≈ δ/λmin — recovered by a longer PCG run.
    still = rn > 10.0 * rtol * bnorm
    x, r, rn = _pcg_update((x, r, rn), Lsh,
                           jnp.where(still, pcg_rounds * pcg_iters, 0))

    rel = rn / jnp.maximum(bnorm, jnp.finfo(dtype).tiny)
    return x, rel


def add_psd_conditioning(H):
    """+1e-9 on the diagonal (reference: NewtonSolver.py:269-275)."""
    return H + 1e-9 * jnp.eye(H.shape[0], dtype=H.dtype)


def _solve_posdef(H, B, strategy: str, refine_steps: int = 0,
                  mixed: bool = False):
    """Solve H X = B for (symmetric) positive definite H."""
    if strategy == "cholesky":
        if mixed and H.dtype == jnp.float64:
            return mixed_posdef_solve(H, B, refine_steps)
        L = robust_cholesky(H)
        X = chol_solve(L, B)
        return _refine(partial(chol_solve, L), H, B, X, refine_steps)
    # The remaining strategies use LU/SVD factorizations; they exist for
    # API parity with the reference's np_solve / np_lstsq / direct methods.
    if strategy == "solve":
        return jnp.linalg.solve(H, B)
    if strategy == "lstsq":
        return jnp.linalg.lstsq(H, B)[0]
    if strategy == "inverse":
        return jnp.linalg.inv(H) @ B
    raise ValueError(f"unsupported posdef strategy {strategy!r}")


def solve_kkt_eq(H, A, g, rpri, strategy: str, *, use_psd_condition=False,
                 refine_steps: int = 0, diag: bool = False,
                 mixed: bool = False):
    """Equality-constrained Newton step via block elimination.

    Args:
      H: (n, n) Hessian, or (n,) diagonal when ``diag=True``.
      A: (m, n) equality constraint matrix.
      g: (n,) gradient of the barrier-scaled objective.
      rpri: (m,) primal residual A x − b.
      strategy: canonical strategy name (see utils/config.py).

    Returns:
      (dx, w): Newton step and the *new* dual iterate; the engine computes
      vstep = w − v (reference: NewtonSolverInfeasibleStart.py:315,509).
    """
    if diag:
        # Diagonal-H variants factor only the Schur complement
        # (reference: NewtonSolverInfeasibleStart.py:692-809).
        hinv = 1.0 / H
        Hinv_AT = hinv[:, None] * A.T
        Hinv_g = hinv * g
        S = A @ Hinv_AT
        rhs = rpri - A @ Hinv_g
        strat = "cholesky" if strategy in ("cholesky", "diagonal") else strategy
        w = _solve_posdef(S, rhs, strat, refine_steps, mixed)
        dx = -hinv * (g + A.T @ w)
        return dx, w

    if use_psd_condition:
        H = add_psd_conditioning(H)

    if strategy == "full_kkt":
        # Debug path: assemble the full KKT system
        # (reference: NewtonSolverKKTNPSolveInfeasibleStart, :663-689).
        n, m = H.shape[0], A.shape[0]
        Z = jnp.zeros((m, m), dtype=H.dtype)
        M = jnp.block([[H, A.T], [A, Z]])
        rhs = -jnp.concatenate([g, rpri])
        sol = jnp.linalg.solve(M, rhs)
        return sol[:n], sol[n:]

    if strategy == "cg":
        # The reference disables CG for infeasible-start problems
        # (NewtonSolverInfeasibleStart.py:604 raises NotImplementedError).
        raise NotImplementedError(
            "cg is not supported for equality-constrained (infeasible-start) "
            "solves; matches reference NewtonSolverInfeasibleStart.py:571-660"
        )

    if strategy == "cholesky":
        # One factorization of H serves both right-hand sides; then factor
        # the Schur complement (reference: two factorizations per step,
        # NewtonSolverInfeasibleStart.py:396-490).
        B = jnp.concatenate([A.T, g[:, None]], axis=1)
        if mixed and H.dtype == jnp.float64:
            Y = mixed_posdef_solve(H, B, refine_steps)
            Hinv_AT, Hinv_g = Y[:, :-1], Y[:, -1]
            S = A @ Hinv_AT
            S = 0.5 * (S + S.T)
            w = mixed_posdef_solve(S, rpri - A @ Hinv_g, refine_steps)
            dx = -mixed_posdef_solve(H, g + A.T @ w, refine_steps)
            return dx, w
        L1 = robust_cholesky(H)
        Y = chol_solve(L1, B)
        Y = _refine(partial(chol_solve, L1), H, B, Y, refine_steps)
        Hinv_AT, Hinv_g = Y[:, :-1], Y[:, -1]
        S = A @ Hinv_AT
        S = 0.5 * (S + S.T)
        w = _solve_posdef(S, rpri - A @ Hinv_g, "cholesky", refine_steps)
        dxrhs = g + A.T @ w
        dx = chol_solve(L1, dxrhs)
        dx = _refine(partial(chol_solve, L1), H, dxrhs, dx, refine_steps)
        return -dx, w

    # lstsq / solve / inverse block elimination
    # (reference: NewtonSolverNPLstSqInfeasibleStart :279-316,
    #  NewtonSolverNPSolveInfeasibleStart :319-353,
    #  NewtonSolverDirectInfeasibleStart :541-568).
    Hinv_AT = _solve_posdef(H, A.T, strategy)
    Hinv_g = _solve_posdef(H, g, strategy)
    S = A @ Hinv_AT
    w = _solve_posdef(S, rpri - A @ Hinv_g, strategy)
    dx = -_solve_posdef(H, g + A.T @ w, strategy)
    return dx, w


def solve_newton_step(H, g, x, strategy: str, *, use_psd_condition=False,
                      refine_steps: int = 0, diag: bool = False,
                      max_cg_iters: int = 50, mixed: bool = False):
    """Unconstrained Newton step H dx = −g (feasible-start engine;
    reference: NewtonSolver.py:212-420)."""
    if diag:
        # (reference: NewtonSolverDiagonal, NewtonSolver.py:403-420)
        return -g / H
    if strategy == "cg":
        # Warm start heuristic from the reference (NewtonSolver.py:379-383).
        # Deviation: the reference passes −H to CG (NewtonSolver.py:386-398),
        # i.e. a negative-definite system, which CG handles poorly; we solve
        # the equivalent positive-definite system H dx = −g.
        descent_check = x @ g
        x0 = jnp.where(
            descent_check < 0, -descent_check * x / (x @ (H @ x)),
            jnp.zeros_like(x),
        )
        dx, _ = jax.scipy.sparse.linalg.cg(H, -g, x0=x0, maxiter=max_cg_iters)
        return dx
    if use_psd_condition:
        H = add_psd_conditioning(H)
    if strategy == "full_kkt":
        raise ValueError(
            "full_kkt requires equality constraints "
            "(reference: LPSolver.py:427-430)"
        )
    return _solve_posdef(H, -g, strategy, refine_steps, mixed)
