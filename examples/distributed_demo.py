"""Multi-device walkthrough: every parallel surface on one mesh.

Demonstrates the four distribution schemes (SURVEY.md §2.2 — all new
capability; the reference is single-GPU):

  1. dp     — a batch of LP instances vmapped + sharded over devices
  2. tp     — ONE huge LP with constraint rows sharded (psum/all_gather)
  3. ep     — ONE SOCP with the stacked cone tensors sharded
  4. sample — batched-ADMM LASSO with the sample axis sharded

The mesh spans every device JAX finds: the GPUs of the host, or with
``--cpu`` a virtual 8-device CPU mesh (the same programs, the same
collectives).  Run: python examples/distributed_demo.py [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true",
                   help="force a virtual 8-device CPU mesh")
    args = p.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    from scipy.optimize import linprog

    from interiorpoint.models.problem import make_lp
    from interiorpoint.parallel import (
        make_mesh, solve_batch, solve_lasso_sharded,
        solve_lp_row_sharded, solve_socp_cone_sharded, stack_problems)
    from interiorpoint.utils.config import AdmmConfig, SolverConfig

    ndev = len(jax.devices())
    rng = np.random.default_rng(0)
    print(f"devices: {ndev} × {jax.devices()[0].platform}")

    # ------------------------------------------------------------------
    # 1. dp: a batch of LP instances, one per device
    # ------------------------------------------------------------------
    print("\n[1] instance-parallel LP batch (dp)")
    mesh = make_mesh(ndev, ("batch",))
    n = 40
    probs, starts, refs = [], [], []
    for _ in range(ndev):
        A = rng.uniform(-2, 2, (10, n))
        C = rng.uniform(-2, 2, (16, n))
        xf = rng.uniform(-1, 1, n)
        c = rng.uniform(-2, 2, n)
        probs.append(make_lp(c, A, A @ xf, C, C @ xf + 0.5, -3.0, 3.0,
                             dtype=jnp.float64))
        starts.append(xf)
        refs.append(linprog(c, A_ub=C, b_ub=C @ xf + 0.5, A_eq=A,
                            b_eq=A @ xf, bounds=[(-3, 3)] * n,
                            method="highs").fun)
    res = solve_batch(stack_problems(probs),
                      jnp.asarray(np.stack(starts)),
                      SolverConfig(epsilon=1e-6, dtype="float64"),
                      mesh=mesh)
    err = float(np.max(np.abs(np.asarray(res.value) - np.asarray(refs))))
    print(f"    {ndev} instances solved in one program; "
          f"max |obj - HiGHS| = {err:.2e}")

    # ------------------------------------------------------------------
    # 2. tp-analog: one LP with its constraint rows sharded
    # ------------------------------------------------------------------
    print("\n[2] row-sharded single LP (tp analog)")
    mesh = make_mesh(ndev, ("rows",))
    n, m, k = 96, 60, 200
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    out = solve_lp_row_sharded(mesh, c, A, A @ xf, C, C @ xf + 0.5,
                               lb=-3.0, ub=3.0, epsilon=1e-8,
                               factor_dtype="float32")
    ref = linprog(c, A_ub=C, b_ub=C @ xf + 0.5, A_eq=A, b_eq=A @ xf,
                  bounds=[(-3, 3)] * n, method="highs").fun
    print(f"    {k} inequality + {m} equality rows sharded over {ndev} "
          f"devices (mixed-precision factors);")
    print(f"    objective {float(out['objective']):.6f} vs HiGHS "
          f"{ref:.6f}  ({out['newton_iters']} Newton iters)")

    # ------------------------------------------------------------------
    # 3. ep-analog: one SOCP with its cone axis sharded
    # ------------------------------------------------------------------
    print("\n[3] cone-sharded single SOCP (ep analog)")
    mesh = make_mesh(ndev, ("cones",))
    n, K, M, meq = 48, 2 * ndev + 1, 12, 6   # K deliberately non-divisible
    Pp = rng.uniform(-1, 1, (n, n))
    P = Pp.T @ Pp + np.eye(n)
    q = rng.uniform(-1, 1, n)
    x0 = 0.1 * rng.standard_normal(n)
    As = rng.standard_normal((K, M, n))
    bs = rng.standard_normal((K, M))
    cs = rng.standard_normal((K, n))
    ds = np.array([np.linalg.norm(As[j] @ x0 + bs[j]) - cs[j] @ x0 + 1.0
                   for j in range(K)])
    F = rng.standard_normal((meq, n))
    out = solve_socp_cone_sharded(mesh, As, bs, cs, ds, P, q, F, F @ x0,
                                  -3.0, 3.0, x0=x0, epsilon=1e-9)
    x = np.asarray(out["x"])
    worst = max(np.linalg.norm(As[j] @ x + bs[j]) - cs[j] @ x - ds[j]
                for j in range(K))
    print(f"    {K} cones sharded over {ndev} devices (inert padding); "
          f"objective {float(out['objective']):.6f}")
    print(f"    worst cone violation {worst:.2e}, equality residual "
          f"{np.linalg.norm(F @ x - F @ x0):.2e}")

    # ------------------------------------------------------------------
    # 3b. the same sharded solves with the Mehrotra engines: 3-5x fewer
    #     iterations, no phase one (algorithm="pd")
    # ------------------------------------------------------------------
    print("\n[3b] distributed Mehrotra (algorithm='pd') on both shardings")
    mesh = make_mesh(ndev, ("rows",))
    out_pd = solve_lp_row_sharded(mesh, c, A, A @ xf, C, C @ xf + 0.5,
                                  lb=-3.0, ub=3.0, epsilon=1e-8,
                                  algorithm="pd")
    print(f"    row-sharded LP: objective "
          f"{float(out_pd['objective']):.6f} vs HiGHS {ref:.6f} in "
          f"{out_pd['iterations']} pd iterations")
    mesh = make_mesh(ndev, ("cones",))
    out_spd = solve_socp_cone_sharded(mesh, As, bs, cs, ds, P, q, F,
                                      F @ x0, -3.0, 3.0, x0=x0,
                                      epsilon=1e-9, algorithm="pd")
    print(f"    cone-sharded SOCP: objective "
          f"{float(out_spd['objective']):.6f} in "
          f"{out_spd['iterations']} pd iterations")

    # ------------------------------------------------------------------
    # 4. sample-sharded batched-ADMM LASSO
    # ------------------------------------------------------------------
    print("\n[4] sample-sharded LASSO (batched ADMM)")
    mesh = make_mesh(ndev, ("batch",))
    Al = rng.random((64, 12))
    bl = rng.random((64, ndev))
    reg = np.full(ndev, 0.1)
    lres = solve_lasso_sharded(Al, bl, reg, AdmmConfig(dtype="float64"),
                               mesh)
    print(f"    {ndev} targets sharded; mean objective "
          f"{float(np.mean(np.asarray(lres.solutions))):.6f}")

    # ------------------------------------------------------------------
    # 5. mid-solve checkpoint/resume on the distributed solve
    # ------------------------------------------------------------------
    print("\n[5] checkpoint/resume (simulated preemption)")
    import tempfile
    mesh = make_mesh(ndev, ("rows",))
    ckpt = os.path.join(tempfile.mkdtemp(), "lp.npz")
    # "job killed" after 3 barrier stages...
    part = solve_lp_row_sharded(mesh, c, A, A @ xf, C, C @ xf + 0.5,
                                lb=-3.0, ub=3.0, epsilon=1e-8,
                                max_outer_iters=3, checkpoint_path=ckpt)
    # ...a fresh process picks up from the last completed chunk
    out2 = solve_lp_row_sharded(mesh, c, A, A @ xf, C, C @ xf + 0.5,
                                lb=-3.0, ub=3.0, epsilon=1e-8,
                                checkpoint_path=ckpt, resume=True)
    print(f"    killed after {part['outer_iters']} stages, resumed to "
          f"{out2['outer_iters']} total; objective "
          f"{float(out2['objective']):.6f} vs HiGHS {ref:.6f}")

    print("\nall five schemes ran on the same mesh API.")


if __name__ == "__main__":
    main()
