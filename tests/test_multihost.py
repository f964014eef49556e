"""True multi-PROCESS distributed solves (SURVEY.md §2.2 comm backend),
exercising ``parallel.distributed.initialize``.

Two OS processes each own one CPU device, initialize jax.distributed
against a shared coordinator, and run the row-sharded LP and
cone-sharded SOCP barrier programs over the GLOBAL 2-device mesh — the
collectives cross a real process boundary (gloo), the CPU stand-in for
DCN between pod hosts.  Both processes must agree with each other and
with the ground truth."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from scipy.optimize import linprog, minimize


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _expected_lp():
    rng = np.random.default_rng(17)
    n, m, k = 24, 12, 10
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)
    ref = linprog(c, A_ub=C, b_ub=C @ xf + 0.5, A_eq=A, b_eq=A @ xf,
                  bounds=[(-3, 3)] * n, method="highs")
    assert ref.status == 0
    return ref.fun


def _expected_socp():
    rng = np.random.default_rng(23)
    K, M, ns = 4, 3, 10
    As = rng.standard_normal((K, M, ns))
    bs = rng.standard_normal((K, M))
    cs = rng.standard_normal((K, ns))
    x0 = rng.standard_normal(ns) * 0.1
    ds = np.array([np.linalg.norm(As[j] @ x0 + bs[j]) - cs[j] @ x0 + 1.0
                   for j in range(K)])
    q = rng.uniform(-1, 1, ns)
    cons = [{"type": "ineq",
             "fun": lambda x, j=j: (cs[j] @ x + ds[j])
             - np.linalg.norm(As[j] @ x + bs[j])} for j in range(K)]
    ref = minimize(lambda x: q @ x, x0, method="SLSQP", constraints=cons,
                   bounds=[(-3, 3)] * ns,
                   options={"maxiter": 1000, "ftol": 1e-10})
    # SLSQP oscillates in x on this instance but the objective is converged
    # (stable to 1e-10 between 400 and 1000 iterations) — accept status 9.
    assert ref.success or ref.status == 9, ref.message
    return ref.fun


def test_two_process_distributed_solves():
    nproc = 2
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ)
    # one CPU device per process: the global mesh spans processes, not
    # the in-process virtual mesh the rest of the suite uses
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(worker)) \
        + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), str(nproc), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(nproc)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost worker timed out")
        outs.append(out)
        assert p.returncode == 0, out

    results = {}
    for pid, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith("RESULT "):
                _, suite, wpid, val = line.split()
                results[(suite, int(wpid))] = float(val)
    assert set(results) == {("lp", 0), ("lp", 1), ("lppd", 0),
                            ("lppd", 1), ("socp", 0), ("socp", 1)}, outs

    # both processes computed the identical replicated optimum...
    assert results[("lp", 0)] == results[("lp", 1)]
    assert results[("lppd", 0)] == results[("lppd", 1)]
    assert results[("socp", 0)] == results[("socp", 1)]
    # ...and it matches the ground truth
    assert results[("lp", 0)] == pytest.approx(_expected_lp(), rel=2e-6)
    assert results[("lppd", 0)] == pytest.approx(_expected_lp(), rel=2e-6)
    assert results[("socp", 0)] == pytest.approx(_expected_socp(),
                                                 rel=1e-5, abs=1e-5)
