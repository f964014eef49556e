"""Distributed blocked Cholesky for shard_map programs.

The row-sharded barrier solve (``parallel/distributed.py``) replicates
its two factorizations — chol(H) at n×n and chol(S) at m×m — on every
chip, a replicated serial core that bounds strong scaling at high chip
counts.  This module distributes the factor itself.

Design (1-D mesh axis, block-cyclic column ownership — the shard_map
analogue of a ScaLAPACK 1-D right-looking factor):

* block-columns of the (replicated) input are owned cyclically:
  chip p owns global block j when ``j % ndev == p`` — cyclic, so the
  shrinking trailing matrix stays balanced across chips;
* at step j the owner's current panel is broadcast with one masked
  ``psum`` (everyone else contributes zeros), every chip factors the
  tiny bs×bs diagonal block redundantly (cheaper than a second
  collective) and triangular-solves the panel;
* the O(n³) trailing update — the FLOP bulk of the factorization — is
  applied by each chip ONLY to its owned block-columns, so it splits
  1/ndev per chip;
* the factor is reassembled with one ``all_gather`` (n² words, the
  same order as the H ``psum`` the caller already pays per iteration).

Per-chip cost: n³/ndev trailing-update FLOPs (the lazy full-height
update trades the triangular factor-of-~3 for static shapes — still a
2.7× serial-term win at 8 chips, and the updates are matmuls rather
than a sequential Cholesky), plus O(n²·bs) replicated panel solves and
O(n²) collective words.

dtype-generic: callers pass f64 (reference precision) or f32 (the
mixed-precision factor path; see ``_row_sharded_barrier``'s
``factor_dtype``).

New capability — the reference is single-device
(SURVEY.md §2.2); its factorizations are one-GPU `cholesky` calls
(NewtonSolverInfeasibleStart.py:431-451).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_HIGHEST = jax.lax.Precision.HIGHEST


def dist_cholesky(H, axis: str, ndev: int, block: int = 256):
    """Lower-Cholesky factor of replicated SPD ``H`` computed
    cooperatively across mesh axis ``axis`` (``ndev`` chips); must be
    called inside a shard_map program over that axis.  Returns the
    replicated (n, n) lower-triangular L with H = L·Lᵀ.

    ``block`` is the panel width: larger blocks amortize collective
    latency, smaller blocks cut the replicated panel-solve term — the
    default suits n in the thousands.
    """
    n = H.shape[0]
    dtype = H.dtype
    bs = min(block, n)
    nb = -(-n // bs)                 # block-columns in the true matrix
    nbl = -(-nb // ndev)             # owned block-columns per chip
    nbp = nbl * ndev                 # padded block count (cyclic-even)
    npad = nbp * bs

    # Pad to npad with an identity diagonal: the padding factors to the
    # identity and is sliced away at the end.
    Hp = jnp.zeros((npad, npad), dtype).at[:n, :n].set(H)
    pad_idx = jnp.arange(n, npad)
    Hp = Hp.at[pad_idx, pad_idx].set(jnp.ones((npad - n,), dtype))

    p = lax.axis_index(axis)
    mine = p + ndev * jnp.arange(nbl)        # owned global block indices
    # owned block-columns, stacked: (nbl, npad, bs)
    cols = Hp.reshape(npad, nbp, bs).transpose(1, 0, 2)
    Hl = jnp.take(cols, mine, axis=0)

    rows = jnp.arange(npad)

    def step(j, Hl):
        owner = j % ndev
        jl = j // ndev
        cand = lax.dynamic_index_in_dim(Hl, jl, axis=0, keepdims=False)
        # broadcast the owner's panel: one masked all-reduce
        panel = lax.psum(
            jnp.where(p == owner, cand, jnp.zeros_like(cand)), axis)
        D = lax.dynamic_slice_in_dim(panel, j * bs, bs, axis=0)
        Ljj = jnp.linalg.cholesky(D)          # bs×bs, replicated (tiny)
        # X = panel · Ljj⁻ᵀ over all rows (rows above the diagonal are
        # masked to zero; the diagonal block is embedded exactly as Ljj)
        X = jax.scipy.linalg.solve_triangular(Ljj, panel.T, lower=True).T
        below = rows >= (j + 1) * bs
        pcol = jnp.where(below[:, None], X, jnp.zeros_like(X))
        pcol = lax.dynamic_update_slice_in_dim(pcol, Ljj, j * bs, axis=0)
        # owner stores the factored panel in place
        Hl = jnp.where(
            p == owner,
            lax.dynamic_update_index_in_dim(Hl, pcol, jl, axis=0), Hl)
        # trailing update, owned columns only: the 1/ndev FLOP bulk
        U = jnp.take(pcol.reshape(nbp, bs, bs), mine, axis=0)
        upd = jnp.einsum("rc,ibc->irb", pcol, U, precision=_HIGHEST)
        Hl = Hl - jnp.where((mine > j)[:, None, None], upd,
                            jnp.zeros_like(upd))
        return Hl

    Hl = lax.fori_loop(0, nbp, step, Hl)

    # reassemble: gathered (ndev, nbl, npad, bs) → cyclic order
    # j = i·ndev + p → (i, p) fastest-p, then rows-major columns
    allc = lax.all_gather(Hl, axis, axis=0, tiled=False)
    allc = allc.transpose(1, 0, 2, 3).reshape(nbp, npad, bs)
    Lfull = allc.transpose(1, 0, 2).reshape(npad, npad)
    return jnp.tril(Lfull[:n, :n])
