"""Generate a committed structured-LP regression fixture.

The upstream MIPLIB blobs (30n20b8.npy / aflow40b.npy — absent from the
reference too, .MISSING_LARGE_BLOBS) cannot be fetched in this build
environment (zero egress), so this script synthesizes an instance of the
same FAMILY as aflow40b: the LP relaxation of a fixed-charge network-flow
problem (reference loader format: testSolver.py:292-301).

Structure (what makes it a real regression target, unlike the dense
uniform benchmark generators in utils/generators.py):
  - variables  x = [f (arc flows), y (arc activations, relaxed to [0,1])]
  - equalities A x = b: node flow-conservation rows — a sparse ±1
    incidence matrix (one node dropped so A has full row rank)
  - inequalities C x ≤ d: capacity coupling f_e − cap_e · y_e ≤ 0
  - bounds 0 ≤ f_e ≤ cap_e, 0 ≤ y_e ≤ 1 (per-variable vectors)
  - objective: per-unit flow cost on f + fixed charge on y

Feasible by construction (interior point: f = frac·cap, y = 0.8) and
highly degenerate at the optimum (many zero flows), exercising the
solver on sparse structured data.

Usage: python scripts/make_flow_instance.py [out.npy]
"""
import os
import sys

import numpy as np


def make_flow_lp(n_nodes=40, n_arcs=120, seed=7):
    rng = np.random.default_rng(seed)
    # connected digraph: a random spanning path + random extra arcs
    order = rng.permutation(n_nodes)
    arcs = [(order[i], order[i + 1]) for i in range(n_nodes - 1)]
    seen = set(arcs)
    while len(arcs) < n_arcs:
        u, v = rng.integers(0, n_nodes, 2)
        if u != v and (u, v) not in seen:
            arcs.append((u, v))
            seen.add((u, v))
    E, N = len(arcs), n_nodes

    cap = rng.uniform(2.0, 10.0, E)
    # strictly interior feasible flow, activations clear of both bounds
    f_feas = rng.uniform(0.2, 0.6, E) * cap
    y_feas = np.full(E, 0.8)

    # node-arc incidence on the flow block (out = +1, in = -1)
    inc = np.zeros((N, E))
    for e, (u, v) in enumerate(arcs):
        inc[u, e] += 1.0
        inc[v, e] -= 1.0
    A = np.concatenate([inc, np.zeros((N, E))], axis=1)[:-1]  # full rank
    b = A @ np.concatenate([f_feas, y_feas])

    # capacity coupling rows f_e - cap_e * y_e <= 0
    C = np.concatenate([np.eye(E), -np.diag(cap)], axis=1)
    d = np.zeros(E)

    c = np.concatenate([rng.uniform(1.0, 5.0, E),      # flow cost
                        rng.uniform(5.0, 20.0, E)])    # fixed charge
    ub = np.concatenate([cap, np.ones(E)])
    lb = np.zeros(2 * E)
    return c, A, b, C, d, ub, lb


def main():
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from interiorpoint.utils import miplib

    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "tests", "data", "miplib",
        "flow40.npy")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    parts = make_flow_lp()
    miplib.save_lp_npy(out, *parts)
    c, A, b, C, d, ub, lb = parts
    print(f"wrote {out}: n={c.size} vars, {A.shape[0]} eq, "
          f"{C.shape[0]} ineq, {os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
