"""Worker process for tests/test_multihost.py (not collected by pytest).

Each process initializes jax.distributed against the shared coordinator,
joins the global 2-process CPU mesh (gloo collectives across process
boundaries — the DCN analogue this framework targets on pods), runs the
row-sharded LP and cone-sharded SOCP solves, and prints one parseable
result line per solve."""
import sys

import jax

jax.config.update("jax_platforms", "cpu")

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

from interiorpoint.parallel.distributed import initialize  # noqa: E402

initialize(coordinator_address=f"localhost:{port}", num_processes=nproc,
           process_id=pid)
jax.config.update("jax_enable_x64", True)
assert jax.device_count() == nproc * jax.local_device_count()

import numpy as np  # noqa: E402

from interiorpoint.parallel.distributed import (  # noqa: E402
    solve_lp_row_sharded)
from interiorpoint.parallel.mesh import make_mesh  # noqa: E402
from interiorpoint.parallel.socp_dist import (  # noqa: E402
    solve_socp_cone_sharded)

rng = np.random.default_rng(17)
n, m, k = 24, 12, 10
A = rng.uniform(-2, 2, (m, n))
C = rng.uniform(-2, 2, (k, n))
xf = rng.uniform(-1, 1, n)
c = rng.uniform(-2, 2, n)
mesh = make_mesh(jax.device_count(), ("rows",))
res = solve_lp_row_sharded(mesh, c, A, A @ xf, C, C @ xf + 0.5,
                           lb=-3.0, ub=3.0, x0=xf, epsilon=1e-8)
print(f"RESULT lp {pid} {float(res['objective']):.12f}", flush=True)

# the distributed Mehrotra engine over the same 2-process mesh
res_pd = solve_lp_row_sharded(mesh, c, A, A @ xf, C, C @ xf + 0.5,
                              lb=-3.0, ub=3.0, x0=xf, epsilon=1e-8,
                              algorithm="pd")
print(f"RESULT lppd {pid} {float(res_pd['objective']):.12f}", flush=True)

rng = np.random.default_rng(23)
K, M, ns = 4, 3, 10
As = rng.standard_normal((K, M, ns))
bs = rng.standard_normal((K, M))
cs = rng.standard_normal((K, ns))
x0 = rng.standard_normal(ns) * 0.1
ds = np.array([np.linalg.norm(As[j] @ x0 + bs[j]) - cs[j] @ x0 + 1.0
               for j in range(K)])
q = rng.uniform(-1, 1, ns)
mesh = make_mesh(jax.device_count(), ("cones",))
res = solve_socp_cone_sharded(mesh, As, bs, cs, ds, q=q, lb=-3.0, ub=3.0,
                              x0=x0, epsilon=1e-8)
print(f"RESULT socp {pid} {float(res['objective']):.12f}", flush=True)
