"""chip_smoke.py and the helpers it shares with bench.py, on the CPU.

The phase functions run here at tiny sizes, called directly; the script
itself refuses to run without a GPU.  The four-card phases run on four of
the eight virtual CPU devices (tests/conftest.py).  ``-m gpu`` runs the
phases on a card at a size between these and the script's.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
import bench
from interiorpoint.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _check(records):
    assert records
    for rec in records:
        json.dumps(rec)                      # each record prints as JSON
        assert rec["ok"], rec
        assert rec["err"] <= rec["tol"]
        assert rec["tol_reason"] and rec["precision"]
    return records


@pytest.mark.parametrize("phase,kwargs", [
    (cs.phase_lp, dict(n=40)),
    # the QP recipe has 20 inequalities: it needs n ≥ 100 for the null
    # space (n − 0.8n) to hold an interior
    (cs.phase_qp, dict(n=100)),
    (cs.phase_socp, dict(n=40)),
    (cs.phase_lasso, dict(n=60)),
    (cs.phase_lp_phase_one, dict(n=40)),
    (cs.phase_batch, dict(num=8, n=20)),
    (cs.phase_mixed_factor, dict(n=64)),
], ids=lambda v: getattr(v, "__name__", ""))
def test_one_card_phase_on_cpu(phase, kwargs):
    _check(phase(**kwargs))


def test_engine_pair_reports_both_engines():
    recs = _check(cs.phase_lp(n=30, seed=4))
    assert [r["phase"] for r in recs] == ["lp30_barrier", "lp30_pd"]
    assert recs[0]["newton_steps"] > 0 and recs[1]["pd_iterations"] > 0
    assert recs[0]["objective"] == pytest.approx(recs[1]["objective"],
                                                 abs=recs[0]["tol"])


@pytest.mark.parametrize("phase,axis,kwargs", [
    (cs.four_card_row_sharded, "rows", dict(n=100)),
    (cs.four_card_cone_sharded, "cones", dict(n=40)),
    (cs.four_card_batch, "batch", dict(num=8, n=20)),
    (cs.four_card_lasso, "batch", dict(n=40)),
], ids=lambda v: getattr(v, "__name__", v if isinstance(v, str) else ""))
def test_four_card_phase_on_virtual_devices(phase, axis, kwargs):
    from interiorpoint.parallel import make_mesh

    recs = _check(phase(make_mesh(4, (axis,)), **kwargs))
    assert all(r["sharded_on_all_cards"] for r in recs)


def test_run_phases_reports_a_failing_phase(capsys):
    def broken():
        raise RuntimeError("boom")

    def passing():
        return [dict(phase="p", ok=True)]

    assert cs.run_phases((passing,)) is True
    assert cs.run_phases((passing, broken)) is False
    out = capsys.readouterr().out
    assert '"phase": "broken", "ok": false' in out


def test_main_refuses_the_cpu(capsys):
    assert cs.main([]) != 0
    assert cs.main(["--four-cards"]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_script_exits_nonzero_without_gpu():
    out = _run(["chip_smoke.py"], ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_exits_nonzero_without_gpu():
    out = _run(["bench.py", "--suite", "lp", "--n", "20"], ROOT)
    assert out.returncode != 0
    assert "no GPU" in out.stderr


def test_lasso_tolerance_bounds_a_converged_solve():
    from interiorpoint import LassoSolver
    from interiorpoint.utils.generators import generate_lasso

    p = generate_lasso(50, rng=np.random.RandomState(2))
    s = LassoSolver(p["A"], p["b"], reg=p["reg"], **cs.LASSO_SETTINGS,
                    check_cvxpy=False, dtype="float64")
    s.solve()
    tol = cs.lasso_tol(p["A"], p["b"], cs.LASSO_SETTINGS["eps_rel"])
    assert cs.lasso_residual(p["A"], p["b"], p["reg"], s.X, True) <= tol
    # a solve cut short is caught
    s = LassoSolver(p["A"], p["b"], reg=p["reg"],
                    **dict(cs.LASSO_SETTINGS, max_iters=2),
                    check_cvxpy=False, dtype="float64")
    s.solve()
    assert cs.lasso_residual(p["A"], p["b"], p["reg"], s.X, True) > tol


def test_busy_union_and_idle_share_reduction():
    ivs = [(0, 10), (5, 20), (30, 40), (35, 38)]
    assert profiling.busy_ns(ivs, 0, 50) == 30
    assert profiling.busy_ns(ivs, 8, 32) == 14
    assert profiling.busy_ns([], 0, 10) == 0


def test_bench_counts_iterations_per_engine():
    for algorithm in ("barrier", "pd"):
        solver = bench.make_solver("lp", 30, algorithm)
        first, steady = profiling.time_solve(solver, 2)
        assert len(steady) == 2 and first > 0
        its = bench.iterations(solver)
        assert its == (solver.outer_iters if algorithm == "pd"
                       else sum(solver.inner_iters)) and its > 0


@pytest.mark.gpu
def test_smoke_phases_on_gpu(gpu):
    assert gpu.platform == "gpu"
    for phase in cs.ONE_CARD_PHASES:
        _check(phase(**({"num": 64, "n": 100} if phase is cs.phase_batch
                        else {"n": 1000})))
