"""Phase-one feasibility walkthrough (reference: PhaseOneDemo.ipynb).

Finds interior points of polyhedra, certifies emptiness, and shows the
solver pipeline LP → phase one → barrier.  Run:
python examples/phase_one_demo.py [--cpu]
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

    from interiorpoint.models.phase1 import PhaseOne, PhaseOneSolver

    print("=== Feasible polyhedron (triangle with slack) ===")
    G = np.array([[1.0, 3], [1, 1], [-1, 0], [0, -1]])
    h = np.array([9.0, 5, 0, 0])
    x, s, warn = PhaseOne(G, h, mu=15).solve()
    print(f"x = {x},  s = {s:.4f} (s < 0 → strictly feasible)")
    print(f"max(Gx - h) = {np.max(G @ x - h):.4f}")

    print("\n=== Provably empty polyhedron ===")
    G = np.array([[3.0, -1], [-1, 5], [-1, 0], [0, -1]])
    h = np.array([-2.0, 1.5, 0, 0])
    x, s, warn = PhaseOne(G, h, mu=15).solve()
    print(f"s = {s:.4f} (s > 0 → certified empty)")

    print("\n=== High-dimensional random system (200 × 1000) ===")
    rng = np.random.default_rng(0)
    m, n = 200, 1000
    G = rng.uniform(-10, 10, (m, n))
    h = G @ rng.uniform(-5, 5, n) + 1
    x, s, warn = PhaseOne(G, h, mu=15).solve()
    print(f"s = {s:.4f},  max(Gx - h) = {np.max(G @ x - h):.4f}")

    print("\n=== Current API: inequality block + bounds ===")
    n, k = 40, 60
    C = rng.uniform(-2, 2, (k, n))
    d = C @ rng.uniform(-0.5, 0.5, n) + 0.2
    p1 = PhaseOneSolver(C=C, d=d, lower_bound=-3, upper_bound=3,
                        x0=np.full(n, 2.5), suppress_print=True, tol=0.0,
                        max_outer_iters=50, max_inner_iters=200, t0=0.01)
    x, s = p1.solve()
    print(f"s = {s:.4f}, max(Cx - d) = {np.max(C @ x - d):.4f}, "
          f"|x|max = {np.abs(x).max():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
