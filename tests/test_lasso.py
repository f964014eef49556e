"""Batched ADMM LASSO tests.  Ground truth: subgradient-optimality
certificates (A^T(Ax−b)/m ∈ −λ·∂‖x‖₁) and an independent FISTA solver
(utils/oracle.py) — CVXPY-free analogues of the reference's per-sample
oracle (reference: LassoSolver.py:545-581)."""

import numpy as np
import pytest

from interiorpoint.models.lasso import LassoSolver, solve_lasso
from interiorpoint.utils import oracle as oracle_check


def _gen_lasso(n=40, m=120, B=6, seed=0):
    """(reference recipe: testSolver.py:1096-1105)"""
    rng = np.random.default_rng(seed)
    A = rng.random((m, n))
    x_true = np.zeros((n, B))
    nnz = n * B // 4
    idx = rng.integers(0, n * B, nnz)
    x_true.flat[idx] = rng.uniform(0, 50, nnz)
    reg = 0.05 + 0.01 * rng.standard_normal(B)
    b = A @ x_true + rng.standard_normal((m, B))
    return A, b, np.abs(reg)


def _subgradient_residual(A, b, reg, X):
    """max over entries of the distance of A^T(AX−b)/m from −reg·∂‖X‖₁."""
    m = A.shape[0]
    G = A.T @ (A @ X - b) / m            # (n, B)
    res = np.zeros_like(G)
    for j in range(X.shape[1]):
        r = reg[min(j, len(reg) - 1)]
        g = G[:, j]
        x = X[:, j]
        on = np.abs(x) > 1e-9
        res[on, j] = g[on] + r * np.sign(x[on])
        res[~on, j] = np.maximum(np.abs(g[~on]) - r, 0.0)
    return np.abs(res).max()


def test_lasso_batched_vs_fista():
    A, b, reg = _gen_lasso()
    ls = LassoSolver(A, b, reg=reg, rho=0.4, max_iters=5000, check_stop=10,
                     eps_abs=1e-7, eps_rel=1e-7, check_cvxpy=False)
    X, sols, gaps, iters = ls.solve()
    _, ref_vals, _ = oracle_check.check_lasso(A, b, reg)
    np.testing.assert_allclose(sols, ref_vals, rtol=1e-5)
    assert _subgradient_residual(A, b, reg, X) < 1e-4


def test_lasso_shared_b_many_lambdas():
    """Regularization sweep: one b column, many λ
    (reference demo: 50-λ sweep, demo.ipynb; broadcast at
    LassoSolver.py:109-111)."""
    A, b, _ = _gen_lasso(B=1, seed=1)
    regs = np.linspace(0.01, 1.0, 8)
    ls = LassoSolver(A, b[:, 0], reg=regs, rho=0.4, max_iters=5000,
                     eps_abs=1e-7, eps_rel=1e-7, check_cvxpy=False)
    X, sols, gaps, iters = ls.solve()
    assert X.shape == (40, 8)
    # stronger regularization → sparser solutions
    nnz = (np.abs(X) > 1e-6).sum(axis=0)
    assert nnz[-1] <= nnz[0]
    assert _subgradient_residual(A, np.broadcast_to(b, (120, 8)), regs,
                                 X) < 1e-4


def test_lasso_add_bias():
    """Bias column is prepended and unregularized
    (reference: LassoSolver.py:122-130,540-541).  Also covers the
    reference's AtA_cache crash when add_bias=False (we fix it; this test
    plus test_lasso_batched_vs_fista exercises both paths)."""
    A, b, reg = _gen_lasso(seed=2)
    b = b + 100.0  # large offset the bias term must absorb
    ls = LassoSolver(A, b, reg=reg, rho=0.4, max_iters=5000, add_bias=True,
                     eps_abs=1e-7, eps_rel=1e-7, check_cvxpy=False)
    X, sols, gaps, iters = ls.solve()
    assert X.shape[0] == 41
    assert np.abs(X[0]).min() > 1.0  # bias absorbed the offset
    A_aug = np.hstack([np.ones((120, 1)), A])
    m = 120
    G = A_aug.T @ (A_aug @ X - b) / m
    # unregularized bias row must have (near) zero gradient
    assert np.abs(G[0]).max() < 1e-4


def test_lasso_positive():
    A, b, reg = _gen_lasso(seed=3)
    b = -b  # force the unconstrained solution negative somewhere
    ls = LassoSolver(A, b, reg=reg, rho=0.4, max_iters=3000, positive=True,
                     eps_abs=1e-6, eps_rel=1e-6, check_cvxpy=False)
    X, *_ = ls.solve()
    assert X.min() >= 0.0


def test_lasso_chunked_matches_single():
    A, b, reg = _gen_lasso(B=6, seed=4)
    kw = dict(reg=reg, rho=0.4, max_iters=5000, eps_abs=1e-8, eps_rel=1e-8,
              check_cvxpy=False)
    X1, s1, *_ = LassoSolver(A, b, **kw).solve()
    X2, s2, *_ = LassoSolver(A, b, num_chunks=3, **kw).solve()
    np.testing.assert_allclose(s1, s2, rtol=1e-6)
    np.testing.assert_allclose(X1, X2, atol=1e-5)


def test_lasso_compute_loss_gaps():
    A, b, reg = _gen_lasso(B=3, seed=5)
    ls = LassoSolver(A, b, reg=reg, max_iters=500, compute_loss=True,
                     eps_abs=1e-6, eps_rel=1e-6, check_cvxpy=False)
    X, sols, gaps, iters = ls.solve()
    assert gaps.shape[0] == iters and gaps.shape[1] == 3
    # objective trace decreases overall
    assert gaps[-1].sum() <= gaps[0].sum()


def test_lasso_normalize_A():
    A, b, reg = _gen_lasso(seed=6)
    ls = LassoSolver(A, b, reg=reg, normalize_A=True, max_iters=2000,
                     check_cvxpy=False)
    X, sols, *_ = ls.solve()
    assert np.all(np.isfinite(sols))


def test_solve_lasso_functional():
    A, b, reg = _gen_lasso(seed=7)
    res = solve_lasso(A, b, reg, max_iters=5000, eps_abs=1e-7, eps_rel=1e-7,
                      dtype="float64")
    assert _subgradient_residual(A, b, reg, np.asarray(res.X)) < 1e-4


def test_lasso_example_data():
    """Regression on the committed example dataset (X_train 5331×18),
    stored in-repo at tests/data/lasso_example.npz (converted from the
    reference's example_data/ CSVs, used in demo.ipynb)."""
    import os
    path = os.path.join(os.path.dirname(__file__), "data",
                        "lasso_example.npz")
    data = np.load(path)
    A, y = data["X"], data["y"]
    A = A[~np.isnan(A).any(axis=1)]
    y = y[: A.shape[0]]
    ls = LassoSolver(A, y, reg=np.array([0.1]), add_bias=True,
                     normalize_A=True, max_iters=3000, eps_abs=1e-6,
                     eps_rel=1e-6, check_cvxpy=False)
    X, sols, *_ = ls.solve()
    assert np.isfinite(sols).all()
    A_aug = np.hstack([np.ones((A.shape[0], 1)), A / A.std(axis=0)])
    m = A.shape[0]
    G = A_aug.T @ (A_aug @ X - y[:, None]) / m
    # unregularized bias row: plain stationarity
    assert np.abs(G[0]).max() < 1e-2
    # regularized rows: subgradient optimality
    assert _subgradient_residual(A_aug[:, 1:], y[:, None] - A_aug[:, :1]
                                 @ X[:1], np.array([0.1]), X[1:]) < 1e-2


def test_lasso_adaptive_rho_matches_plain():
    """The ρ-ladder + over-relaxation defaults (ops/admm.py) must reach
    the same optimum as the reference-parity fixed-ρ iteration, in fewer
    iterations."""
    A, b, reg = _gen_lasso(n=60, m=180, B=5, seed=3)
    kw = dict(reg=reg, rho=0.4, max_iters=8000, check_stop=10,
              eps_abs=1e-6, eps_rel=1e-6, check_cvxpy=False)
    fast = LassoSolver(A, b, **kw)                       # defaults on
    Xf, sf, _, itf = fast.solve()
    plain = LassoSolver(A, b, adaptive_rho=False, relax=1.0, **kw)
    Xp, sp, _, itp = plain.solve()
    np.testing.assert_allclose(sf, sp, rtol=1e-6)
    assert _subgradient_residual(A, b, reg, Xf) < 1e-4
    assert sum(np.atleast_1d(itf)) <= sum(np.atleast_1d(itp))


def test_lasso_adaptive_rho_chunked_matches_single():
    """Chunked dispatch shares the prepared factor ladder; per-chunk
    solves must match the unchunked batch."""
    A, b, reg = _gen_lasso(n=50, m=150, B=6, seed=4)
    kw = dict(reg=reg, rho=0.4, max_iters=8000, check_stop=10,
              eps_abs=1e-7, eps_rel=1e-7, check_cvxpy=False)
    single = LassoSolver(A, b, **kw)
    Xs, ss, _, _ = single.solve()
    chunked = LassoSolver(A, b, num_chunks=3, **kw)
    Xc, sc, _, _ = chunked.solve()
    np.testing.assert_allclose(sc, ss, rtol=1e-6)
    np.testing.assert_allclose(Xc, Xs, atol=1e-4)


@pytest.mark.parametrize("bytes_limit,chunks", [(2**40, 1), (2**14, 5)])
def test_lasso_chunks_follow_the_device_memory_limit(monkeypatch,
                                                     bytes_limit, chunks):
    """The sample chunking budget is a share of the device's reported
    memory limit (utils/memory.py), not a fixed size."""
    from interiorpoint import LassoSolver
    from interiorpoint.utils import memory

    monkeypatch.setattr(memory, "device_bytes_limit", lambda: bytes_limit)
    rng = np.random.default_rng(0)
    A = rng.random((60, 20))
    b = rng.random((60, 24))
    s = LassoSolver(A, b, reg=np.full(24, 0.05), max_iters=400,
                    check_cvxpy=False, dtype="float64")
    itemsize = 8
    need = (3 * 21 * 24 + b.size + 60 * 21 + 21 ** 2) * itemsize
    assert s.num_chunks == int(need // (bytes_limit / 2)) + 1 == chunks
    s.solve()
    ref = LassoSolver(A, b, reg=np.full(24, 0.05), max_iters=400,
                      check_cvxpy=False, dtype="float64", num_chunks=1)
    ref.solve()
    np.testing.assert_allclose(s.solutions, ref.solutions, rtol=1e-5)
