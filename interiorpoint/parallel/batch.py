"""Instance-parallel solves: vmap over problem batches, sharded across a
device mesh.

Replacement for the reference's *sequential* chunked batching
(reference: LassoSolver.py:339-485 solves chunks one after another on one
GPU; SURVEY.md §2.2): here a batch of problem instances is a leading array
axis, vmapped into one XLA program and sharded across chips, so the fleet
solves all instances simultaneously and stopping criteria are evaluated
per-instance on device.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..models.problem import LPProblem, QPProblem, SOCPProblem
from ..ops.barrier import make_phase1_linear_oracle, make_qp_oracle
from ..ops.ipm import barrier_solve
from ..ops.admm import admm_core
from ..ops.socp import make_phase1_socp_oracle, make_socp_oracle
from .mesh import batch_sharding, replicated
from ..utils.precision import highest_precision


def _single_lp(prob, x0, t0, cfg, num_constraints, eq_gate, use_phase1):
    oracle = make_qp_oracle(prob, try_diag=cfg.try_diag)
    p1 = make_phase1_linear_oracle(prob) if use_phase1 else None
    return barrier_solve(oracle, prob.A, prob.b, x0, cfg,
                         num_constraints=num_constraints, eq_gate=eq_gate,
                         t0=t0, p1_oracle=p1)


def _single_qp(prob, x0, t0, cfg, num_constraints, eq_gate, use_phase1):
    oracle = make_qp_oracle(prob)
    p1 = make_phase1_linear_oracle(prob) if use_phase1 else None
    return barrier_solve(oracle, prob.A, prob.b, x0, cfg,
                         num_constraints=num_constraints, eq_gate=eq_gate,
                         t0=t0, p1_oracle=p1)


def _single_socp(prob, x0, t0, cfg, num_constraints, eq_gate, use_phase1):
    # the equality pair rides in the (A, b) slots exactly as the
    # single-chip driver passes (F, g) (reference: SOCPSolver.py:535-553)
    oracle = make_socp_oracle(prob)
    p1 = make_phase1_socp_oracle(prob) if use_phase1 else None
    return barrier_solve(oracle, prob.F, prob.g, x0, cfg,
                         num_constraints=num_constraints, eq_gate=eq_gate,
                         t0=t0, p1_oracle=p1)




def _single_pd(prob, x0, cfg, kind):
    """Per-instance primal-dual Mehrotra solve in full space: LP/QP via
    ops/pd.py (bounds stacked into the inequality block, equalities via
    the Schur elimination inside pd_solve), SOCP via the NT-scaled conic
    engine (ops/socp_pd.py).  No phase one needed."""
    del kind
    if isinstance(prob, SOCPProblem):
        from ..ops.socp_pd import cone_operator, socp_pd_solve

        G, h, q = cone_operator(prob)
        return socp_pd_solve(G, h, q, x0, cfg, P=prob.P, F=prob.F,
                             g=prob.g, lb=prob.lb, ub=prob.ub)

    from ..models.reduced import full_space_pd_problem
    from ..ops.pd import pd_solve

    return pd_solve(full_space_pd_problem(prob, x0.dtype), x0, cfg,
                    A=prob.A, b=prob.b)


@partial(jax.jit, static_argnames=("cfg", "num_constraints", "eq_gate",
                                   "use_phase1", "kind", "algorithm"))
@highest_precision
def _batch_core(prob_batch, x0_batch, t0, cfg, num_constraints, eq_gate,
                use_phase1, kind, algorithm="barrier"):
    if algorithm == "pd":
        fn = lambda p, x: _single_pd(p, x, cfg, kind)
        return jax.vmap(fn)(prob_batch, x0_batch)
    single = {"lp": _single_lp, "qp": _single_qp,
              "socp": _single_socp}[kind]
    fn = lambda p, x: single(p, x, t0, cfg, num_constraints, eq_gate,
                             use_phase1)
    return jax.vmap(fn)(prob_batch, x0_batch)


def solve_batch(prob_batch, x0_batch, cfg, mesh=None, axis="batch",
                algorithm="barrier"):
    """Solve a batch of same-shaped LP/QP/SOCP instances in parallel.

    Args:
      prob_batch: LPProblem/QPProblem/SOCPProblem pytree whose array
        leaves carry a leading batch dimension (stack instances with
        ``stack_problems``; SOCP cone tensors become (B, K, M, n)).
      x0_batch: (B, n) starting points (strictly interior for the
        barrier; ``algorithm="pd"`` accepts infeasible starts).
      mesh: optional Mesh; the batch axis is sharded across ``axis`` so
        each chip solves its shard of instances (dp over problems).
      algorithm: "barrier" (default) or "pd" — the primal-dual Mehrotra
        engines (ops/pd.py for LP/QP, ops/socp_pd.py for SOCP; LP/QP
        bounds must be finite, no phase one runs).

    Returns an IPMResult pytree with a leading batch dimension
    ("barrier"), or a PDResult / SOCPPDResult pytree ("pd").
    """
    if isinstance(prob_batch, SOCPProblem):
        kind = "socp"
    elif isinstance(prob_batch, QPProblem):
        kind = "qp"
    else:
        kind = "lp"
    if algorithm not in ("barrier", "pd"):
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if algorithm == "pd" and kind in ("lp", "qp"):
        # the vmapped pd path cannot drop ±inf (vacuous) bound rows
        # per-instance (static shapes); reject them up front instead of
        # letting them poison the slack/multiplier initialization (the
        # single-instance driver filters them host-side)
        import numpy as _np
        for bname in ("lb", "ub"):
            bv = getattr(prob_batch, bname, None)
            if bv is not None and not bool(_np.isfinite(
                    _np.asarray(bv)).all()):
                raise ValueError(
                    "solve_batch(algorithm='pd') requires finite bounds "
                    f"(±inf entries in {bname}); omit the bound instead")
    dtype = x0_batch.dtype
    if mesh is not None:
        shard = lambda x: jax.device_put(
            x, batch_sharding(mesh, axis, x.ndim))
        prob_batch = jax.tree.map(shard, prob_batch)
        x0_batch = shard(x0_batch)
    use_phase1 = (True if kind == "socp"
                  else prob_batch.C is not None)
    n = x0_batch.shape[-1]
    num_constraints = prob_batch.num_ineq_constraints
    eq_gate = (cfg.eq_gate if cfg.eq_gate is not None
               else (1e-4 * n if kind == "lp" else 1e-3))
    return _batch_core(prob_batch, x0_batch,
                       jnp.asarray(cfg.t0, dtype=dtype), cfg,
                       int(num_constraints), float(eq_gate),
                       bool(use_phase1), kind, algorithm)


def solve_lasso_sharded(A, b, reg, cfg, mesh, axis="batch"):
    """Batched LASSO with the sample axis sharded across the mesh.

    A is replicated; b's columns and the per-problem λ vector are sharded.
    The global stopping norms (reference: LassoSolver.py:273-298) become
    XLA all-reduces over the mesh — inserted automatically by the
    partitioner from the sharding annotations.
    """
    dt = cfg.jnp_dtype
    A = jax.device_put(jnp.asarray(A, dtype=dt), replicated(mesh))
    b = jnp.asarray(b, dtype=dt)
    if b.ndim < 2:
        b = b[:, None]
    reg = jnp.atleast_1d(jnp.asarray(reg, dtype=dt))
    num_samples = max(b.shape[1], reg.shape[0])
    if b.shape[1] == num_samples:
        b = jax.device_put(b, batch_sharding(mesh, axis, 2, batch_dim=1))
    if reg.shape[0] == num_samples:
        reg = jax.device_put(reg, batch_sharding(mesh, axis, 1))
    return admm_core(A, b, reg, cfg, num_samples)


def stack_problems(problems):
    """Stack same-structure problem pytrees into one batched pytree."""
    return jax.tree.map(lambda *xs: jnp.stack(xs), *problems)
