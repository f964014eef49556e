"""Cone-sharded distributed SOCP solve: iterations/s scaling table.

Measures the full distributed SOCP barrier solve
(parallel/socp_dist.py solve_socp_cone_sharded) at 1/2/4/8 mesh devices
on ONE fixed cone-heavy instance and reports Newton iterations/s and
parallel efficiency vs the 1-device run — the same methodology as
scripts/scaling_table.py for the row-sharded LP.  The mesh is the
virtual CPU mesh: numbers
validate the harness, the collective layout and iterate equivalence,
not the scaling of real cards.

Usage: python scripts/scaling_table_socp.py [K] [out.csv]
"""
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from interiorpoint.parallel.mesh import make_mesh  # noqa: E402
from interiorpoint.parallel.socp_dist import (  # noqa: E402
    solve_socp_cone_sharded)

K = int(sys.argv[1]) if len(sys.argv) > 1 else 64
out_csv = sys.argv[2] if len(sys.argv) > 2 else None
n, M, m_eq = 96, 24, 16

rng = np.random.default_rng(7)
Pp = rng.uniform(-1, 1, (n, n))
P = Pp.T @ Pp + np.eye(n)
q = rng.uniform(-1, 1, n)
x0 = 0.1 * rng.standard_normal(n)
A = rng.standard_normal((K, M, n))
b = rng.standard_normal((K, M))
c = rng.standard_normal((K, n))
d = np.array([np.linalg.norm(A[j] @ x0 + b[j]) - c[j] @ x0 + 1.0
              for j in range(K)])
F = rng.standard_normal((m_eq, n))
g = F @ x0

CONFIGS = (
    ("f64-repl", dict()),
    ("f32-repl", dict(factor_dtype="float32")),
)

rows = []
for name, fkw in CONFIGS:
    base_rate = None
    for ndev in (1, 2, 4, 8):
        mesh = make_mesh(ndev, ("cones",))
        kwargs = dict(x0=x0, epsilon=1e-8, max_outer_iters=12,
                      max_inner_iters=40, **fkw)
        res = solve_socp_cone_sharded(mesh, A, b, c, d, P, q, F, g,
                                      -3.0, 3.0, **kwargs)  # compile+run
        t0 = time.time()
        reps = 3
        for _ in range(reps):
            res = solve_socp_cone_sharded(mesh, A, b, c, d, P, q, F, g,
                                          -3.0, 3.0, **kwargs)
        dt = (time.time() - t0) / reps
        nt = res["newton_iters"]
        rate = nt / dt
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * ndev)
        rows.append((name, ndev, nt, dt, rate, eff,
                     float(res["objective"])))
        print(f"{name}  ndev={ndev}  newton_iters={nt}  solve_s={dt:.3f}"
              f"  iters/s={rate:.1f}  efficiency={eff:.2f}  "
              f"obj={res['objective']:.9f}", flush=True)

objs = {r[6] for r in rows}
print("objective spread across meshes and factor configs:",
      max(objs) - min(objs), flush=True)

if out_csv:
    with open(out_csv, "w") as f:
        f.write("config,ndev,newton_iters,solve_s,iters_per_s,"
                "efficiency,objective\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
    print("wrote", out_csv)
