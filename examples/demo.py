"""Usage walkthrough: LP with phase one, QP, SOCP, and batched LASSO.

Script equivalent of the reference's demo.ipynb (64 cells) — each section
builds a problem, solves it, and verifies the optimum against an
independent oracle.  Run: python examples/demo.py [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    from interiorpoint import (LassoSolver, LPSolver, QPSolver,
                                   SOCPSolver)

    rng = np.random.default_rng(1)

    # ------------------------------------------------------------------
    # 1. LP with an infeasible default start (phase one runs automatically)
    # ------------------------------------------------------------------
    print("=== LP ===")
    n, m, k = 200, 160, 40
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    x_feas = rng.uniform(-2, 2, n)
    c = rng.uniform(-2, 2, n)
    lp = LPSolver(c=c, A=A, b=A @ x_feas, C=C, d=C @ x_feas,
                  lower_bound=-3, upper_bound=3, suppress_print=True,
                  check_cvxpy=True, epsilon=1e-8, get_dual_variables=True)
    val = lp.solve()
    print(f"optimal value  {val:.6f}")
    if lp.cvxpy_val is not None:
        print(f"oracle value   {lp.cvxpy_val:.6f}  "
              f"(|diff| {abs(val - lp.cvxpy_val):.2e})")
    print(f"duality gap    {lp.optimality_gap:.2e}")
    print(f"outer iters    {lp.outer_iters}, newton per center: "
          f"{lp.inner_iters}")
    print(f"min dual       {lp.lam_star.min():.2e} (>= 0)")
    from interiorpoint import certify
    cert = certify(lp)   # in-framework KKT certificate (no oracle solve)
    print(f"KKT certified  stationarity {cert.stationarity:.2e}, "
          f"complementarity {cert.complementarity:.2e}, "
          f"ok(1e-6)={cert.ok(1e-6)}")

    # ------------------------------------------------------------------
    # 2. QP
    # ------------------------------------------------------------------
    print("\n=== QP ===")
    Pp = rng.uniform(-2, 2, (m, n))
    P = Pp.T @ Pp + np.eye(n)
    q = rng.uniform(-2, 2, n)
    qp = QPSolver(P=P, q=q, A=A, b=A @ x_feas, C=C, d=C @ x_feas,
                  lower_bound=-3, upper_bound=3, suppress_print=True,
                  check_cvxpy=False, epsilon=1e-8, t0=0.01,
                  max_inner_iters=100)
    print(f"optimal value  {qp.solve():.6f}")
    print(f"eq residual    "
          f"{np.linalg.norm(A @ np.asarray(qp.xstar) - A @ x_feas):.2e}")

    # ------------------------------------------------------------------
    # 3. SOCP: projection onto an ellipsoid intersected with a hyperplane
    # ------------------------------------------------------------------
    print("\n=== SOCP ===")
    n2 = 50
    target = rng.normal(size=n2) * 2
    scale = np.linspace(1, 2, n2)
    F = np.ones((1, n2))
    socp = SOCPSolver(
        P=np.eye(n2), q=-target,
        A=[np.diag(scale)], b=[np.zeros(n2)], c=[np.zeros(n2)], d=[3.0],
        F=F, g=np.array([1.0]), lower_bound=None, upper_bound=None,
        suppress_print=True, check_cvxpy=False, epsilon=1e-9,
        max_inner_iters=100, x0=np.zeros(n2))
    print(f"optimal value  {socp.solve():.6f}")
    x = np.asarray(socp.xstar)
    print(f"||diag(s)x||   {np.linalg.norm(scale * x):.6f} (<= 3)")
    print(f"sum(x)         {x.sum():.6f} (= 1)")

    # ------------------------------------------------------------------
    # 3b. Same LP with the primal-dual Mehrotra engine (algorithm="pd"):
    #     a fraction of the barrier's factorizations, no phase one,
    #     stationarity-exact duals (new capability — the reference is
    #     barrier-only)
    # ------------------------------------------------------------------
    print("\n=== LP, primal-dual Mehrotra (algorithm='pd') ===")
    lp_pd = LPSolver(c=c, A=A, b=A @ x_feas, C=C, d=C @ x_feas,
                     lower_bound=-3, upper_bound=3, suppress_print=True,
                     check_cvxpy=False, epsilon=1e-8, algorithm="pd")
    val_pd = lp_pd.solve()
    print(f"optimal value  {val_pd:.6f}  (|diff vs barrier| "
          f"{abs(val_pd - val):.2e})")
    print(f"factorizations {lp_pd.outer_iters} "
          f"(barrier used {sum(lp.inner_iters)})")

    # ------------------------------------------------------------------
    # 4. Batched LASSO: a 50-point regularization sweep in one solve
    #    (reference demo's 50-λ sweep)
    # ------------------------------------------------------------------
    print("\n=== LASSO regularization sweep ===")
    mrows, nf = 300, 60
    Al = rng.random((mrows, nf))
    x_true = np.zeros(nf)
    x_true[rng.integers(0, nf, nf // 5)] = rng.uniform(0, 10, nf // 5)
    bl = Al @ x_true + rng.standard_normal(mrows)
    lambdas = np.logspace(-3, 0.5, 50)
    lasso = LassoSolver(Al, bl, reg=lambdas, rho=0.4, max_iters=5000,
                        eps_abs=1e-7, eps_rel=1e-7, check_cvxpy=False)
    X, sols, gaps, iters = lasso.solve()
    nnz = (np.abs(X) > 1e-6).sum(axis=0)
    print(f"solved {len(lambdas)} lambdas in {iters} ADMM iterations "
          "(one batched solve)")
    print(f"sparsity path: nnz {nnz[0]} at λ={lambdas[0]:.3g}  →  "
          f"nnz {nnz[-1]} at λ={lambdas[-1]:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
