"""Row-sharded distributed LP solve: iterations/s scaling table.

Measures the full distributed barrier solve (parallel/distributed.py
solve_lp_row_sharded) at 1/2/4/8 mesh devices on ONE fixed instance and
reports Newton iterations/s and parallel efficiency vs the 1-device run
.

The mesh is the virtual CPU mesh (xla_force_host_platform_device_count),
whose "devices" share the same host cores: efficiency numbers here
validate the measurement harness and the collective layout, not the
scaling of real cards.

Usage: python scripts/scaling_table.py [n] [out.csv]
"""
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from interiorpoint.parallel.distributed import solve_lp_row_sharded  # noqa: E402
from interiorpoint.parallel.mesh import make_mesh  # noqa: E402

n = int(sys.argv[1]) if len(sys.argv) > 1 else 320
out_csv = sys.argv[2] if len(sys.argv) > 2 else None

rng = np.random.default_rng(5)
m, k = int(0.8 * n), int(3.0 * n)     # row-heavy: the sharded dimension
A = rng.uniform(-2, 2, (m, n))
C = rng.uniform(-2, 2, (k, n))
x_feas = rng.uniform(-1, 1, n)
c = rng.uniform(-2, 2, n)
b = A @ x_feas
d = C @ x_feas + 0.5

CONFIGS = (
    ("f64-repl", dict()),
    ("f32-repl", dict(factor_dtype="float32")),
    ("f32-dist", dict(factor_dtype="float32", distributed_factor=True,
                      chol_block=64)),
    # the distributed Mehrotra engine: same collective layout, 3-5x
    # fewer iterations (pd "newton_iters" = pd iterations)
    ("pd-f64", dict(algorithm="pd")),
    ("pd-f32", dict(algorithm="pd", factor_dtype="float32")),
)

rows = []
for name, fkw in CONFIGS:
    base_rate = None
    for ndev in (1, 2, 4, 8):
        mesh = make_mesh(ndev, ("rows",))
        kwargs = dict(lb=-3.0, ub=3.0, x0=x_feas, epsilon=1e-6,
                      max_outer_iters=12, max_inner_iters=40, **fkw)
        res = solve_lp_row_sharded(mesh, c, A, b, C, d, **kwargs)
        t0 = time.time()
        reps = 3
        for _ in range(reps):
            res = solve_lp_row_sharded(mesh, c, A, b, C, d, **kwargs)
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
