"""Utility-layer tests: CSV IO, MIPLIB loader, generators, error analysis."""

import os

import numpy as np
import pytest

from interiorpoint.utils import csvio, generators, miplib, plotting


def test_csvio_roundtrip(tmp_path):
    arr = np.array([[1.5, 2.5, 0.0], [3.5, 0.0, 0.0]])
    path = str(tmp_path / "res.csv")
    csvio.write_results(path, arr)
    back = csvio.read_results(path)
    # zeros (skipped runs) come back as NaN (reference: parseAndPlot.py:86-93)
    assert np.isnan(back[0, 2]) and np.isnan(back[1, 1])
    np.testing.assert_allclose(back[0, :2], [1.5, 2.5])
    means = csvio.mean_over_reps(back)
    np.testing.assert_allclose(means, [2.0, 3.5])


def test_csvio_reads_reference_format(tmp_path):
    """Header line 'num_tests,N' then row-major values
    (reference: testSolver.py:248-271)."""
    path = str(tmp_path / "ref.csv")
    with open(path, "w") as f:
        f.write("2,3\n")
        f.write("1.0,2.0,3.0\n")
        f.write("4.0,5.0,6.0\n")
    arr = csvio.read_results(path)
    assert arr.shape == (2, 3)
    np.testing.assert_allclose(arr[1], [4, 5, 6])


def test_miplib_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    n, m, k = 10, 4, 6
    data = (rng.normal(size=n), rng.normal(size=(m, n)), rng.normal(size=m),
            rng.normal(size=(k, n)), rng.normal(size=k),
            np.full(n, 3.0), np.full(n, -3.0))
    path = str(tmp_path / "inst.npy")
    miplib.save_lp_npy(path, *data)
    back = miplib.load_lp_npy(path)
    for a, b in zip(data, back):
        np.testing.assert_array_equal(a, b)


def test_miplib_solve(tmp_path):
    """End-to-end: save a feasible instance in the reference .npy format
    (testSolver.py:292-301) and solve it."""
    rng = np.random.default_rng(1)
    n, m, k = 20, 10, 5
    A = rng.uniform(-1, 1, (m, n))
    C = rng.uniform(-1, 1, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-1, 1, n)
    path = str(tmp_path / "inst.npy")
    miplib.save_lp_npy(path, c, A, A @ xf, C, C @ xf, np.full(n, 3.0),
                       np.full(n, -3.0))
    solver = miplib.solve_lp_npy(path, suppress_print=True,
                                 check_cvxpy=False, epsilon=1e-8)
    from scipy.optimize import linprog
    ref = linprog(c, A_ub=C, b_ub=C @ xf, A_eq=A, b_eq=A @ xf,
                  bounds=[(-3, 3)] * n, method="highs")
    assert abs(solver.value - ref.fun) / abs(ref.fun) < 1e-4


def test_generators_feasible_by_construction():
    rng = np.random.default_rng(2)
    lp = generators.generate_lp(50, rng=rng)
    # x_feas satisfies Ax=b, Cx<=d by construction; any solver sees a
    # feasible instance (reference recipe: testSolver.py:82-87)
    assert lp["A"].shape == (40, 50) and lp["C"].shape == (10, 50)
    qp = generators.generate_qp(30, rng=rng)
    w = np.linalg.eigvalsh(qp["P"])
    assert w.min() >= 0.99  # P = MᵀM + I
    socp = generators.generate_socp(20, rng=rng)
    x0 = socp["x0"]
    for Ai, bi, ci, di in zip(socp["A"], socp["b"], socp["c"], socp["d"]):
        assert np.linalg.norm(Ai @ x0 + bi) <= ci @ x0 + di + 1e-9
    lasso = generators.generate_lasso(20, num_problems=5, rng=rng)
    assert lasso["b"].shape[1] == 5 and (lasso["reg"] > 0).all()


def test_average_relative_error_masking():
    truth = np.array([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]])
    res = np.array([[1.01, np.inf, 0.0], [2.02, 2.02, 2.02]])
    err = plotting.calculate_average_relative_error(truth, res)
    np.testing.assert_allclose(err, (0.01 + 0.01) / 2)


def test_average_relative_error_lasso_shape():
    truth = np.ones((1, 2, 3))
    res = np.full((1, 2, 3), 1.1)
    err = plotting.calculate_average_relative_error(truth, res, lasso=True)
    np.testing.assert_allclose(err, 0.1, rtol=1e-9)


# ---------------------------------------------------------------------------
# Backtrack-distribution instrumentation + the reference's six-style plot
# family (parseAndPlot.py:177-409).
# ---------------------------------------------------------------------------


def test_backtrack_histogram_counts_accepted_steps():
    """IPMResult.bt_hist bins accepted candidates sigma=beta^j; its total
    must equal the total Newton iterations that accepted a step."""
    from interiorpoint.models.lp import LPSolver

    rng = np.random.default_rng(8)
    n, m, k = 30, 24, 6
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-2, 2, n)
    s = LPSolver(c=rng.uniform(-2, 2, n), A=A, b=A @ xf, C=C, d=C @ xf,
                 lower_bound=-3, upper_bound=3, suppress_print=True,
                 check_cvxpy=False, epsilon=1e-6, t0=1)
    s.solve()
    h = s.backtrack_hist
    assert h is not None and (h >= 0).all()
    # every inner iteration either accepts a candidate (counted in h) or
    # stalls and ends its stage — so sum(h) <= total inner iters, with
    # equality when no stage stalled; and at least one step accepted.
    assert 0 < h.sum() <= sum(s.inner_iters)
    assert h.sum() >= sum(s.inner_iters) - s.outer_iters


def test_plot_family_writes_six_styles(tmp_path):
    from interiorpoint.utils.plotting import plot_family

    rng = np.random.default_rng(9)
    res_a = np.abs(rng.normal(1.0, 0.1, (3, 4)))
    res_b = np.abs(rng.normal(2.0, 0.2, (3, 4)))
    written = plot_family([res_a, res_b], [100, 500, 1000],
                          ["ours", "oracle"], "LP", str(tmp_path))
    assert len(written) == 6
    names = {os.path.basename(w) for w in written}
    assert names == {
        "LPaverageLinearLinePlot.png", "LPaverageLogarithmicLinePlot.png",
        "LPerrorbarLinear.png", "LPerrorbarLogarithmic.png",
        "LPaverageLinearBarPlot.png", "LPaverageLogarithmicBarPlot.png"}
    for w in written:
        assert os.path.getsize(w) > 0


def test_plot_backtrack_distribution_smoke(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from interiorpoint.utils.plotting import plot_backtrack_distribution

    ax = plot_backtrack_distribution(np.array([50, 20, 5, 0, 1, 0, 0]))
    path = str(tmp_path / "bt.png")
    ax.figure.savefig(path)
    plt.close(ax.figure)
    assert os.path.getsize(path) > 0


# ---------------------------------------------------------------------------
# MPS reader / LP relaxation (utils/mps.py) — the pipeline behind the
# reference's missing performanceTest.py (SURVEY.md §2.3 #17) and the
# regeneration path for its absent MIPLIB blobs.
# ---------------------------------------------------------------------------


_MPS_SAMPLE = """\
* hand-written sample exercising rows/ranges/markers/bounds
NAME          SAMPLE
ROWS
 N  OBJ
 L  CAP
 G  MINP
 E  BAL
 L  RNG
COLUMNS
    MARKER1   'MARKER'  'INTORG'
    X1        OBJ       2.0   CAP       1.0
    X1        MINP      1.0   BAL       1.0
    MARKER2   'MARKER'  'INTEND'
    X2        OBJ      -3.0   CAP       2.0
    X2        BAL       1.0   RNG       1.0
    X3        OBJ       1.0   MINP      1.0
    X3        RNG      -1.0
RHS
    RHS       CAP       10.0  MINP      1.0
    RHS       BAL       4.0   RNG       2.0
RANGES
    RNG1      RNG       3.0
BOUNDS
 UP BND       X1        6.0
 MI BND       X3
 UP BND       X3        5.0
ENDATA
"""


def test_mps_lp_relaxation_matches_scipy(tmp_path):
    from scipy.optimize import linprog
    from interiorpoint.utils import mps

    path = str(tmp_path / "sample.mps")
    with open(path, "w") as f:
        f.write(_MPS_SAMPLE)
    c, A, b, C, d, ub, lb = mps.lp_relaxation(mps.parse_mps(path), big=1e4)
    assert A.shape == (1, 3)          # BAL
    assert C.shape == (4, 3)          # CAP, -MINP, RNG, -(RNG lower)
    # integrality markers relaxed: X1 continuous in [0, 6]
    np.testing.assert_allclose(lb, [0.0, 0.0, -1e4])
    np.testing.assert_allclose(ub, [6.0, 1e4, 5.0])
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=list(zip(lb, ub)), method="highs")
    assert ref.status == 0
    # independent hand model of the same MPS
    ref2 = linprog([2.0, -3.0, 1.0],
                   A_ub=[[1.0, 2.0, 0.0],      # CAP: x1+2x2 <= 10
                         [-1.0, 0.0, -1.0],    # MINP: x1+x3 >= 1
                         [0.0, 1.0, -1.0],     # RNG: x2-x3 <= 2
                         [0.0, -1.0, 1.0]],    # RNG lower: x2-x3 >= -1
                   b_ub=[10.0, -1.0, 2.0, 1.0],
                   A_eq=[[1.0, 1.0, 0.0]], b_eq=[4.0],
                   bounds=[(0, 6), (0, None), (None, 5)], method="highs")
    assert abs(ref.fun - ref2.fun) < 1e-9


def test_mps_to_npy_solver_roundtrip(tmp_path):
    """MPS -> reference .npy layout -> LPSolver, vs HiGHS."""
    from scipy.optimize import linprog
    from interiorpoint.utils import miplib, mps

    path = str(tmp_path / "sample.mps")
    with open(path, "w") as f:
        f.write(_MPS_SAMPLE)
    npy = str(tmp_path / "sample.npy")
    mps.mps_to_npy(path, npy, big=50.0)   # finite box for the barrier
    c, A, b, C, d, ub, lb = miplib.load_lp_npy(npy)
    solver = miplib.solve_lp_npy(npy, suppress_print=True,
                                 check_cvxpy=False, epsilon=1e-8)
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=list(zip(lb, ub)), method="highs")
    assert abs(solver.value - ref.fun) / abs(ref.fun) < 1e-4


def test_mps_objsense_forms(tmp_path):
    """Both OBJSENSE spellings: the indented-data-line form and the
    one-line header form 'OBJSENSE MAXIMIZE' (emitted by several
    writers, accepted by HiGHS/Gurobi)."""
    from interiorpoint.utils import mps

    base = ("ROWS\n N  OBJ\n L  CAP\nCOLUMNS\n"
            "    X1        OBJ       2.0   CAP       1.0\n"
            "RHS\n    RHS       CAP       4.0\nENDATA\n")
    for header in ("OBJSENSE\n    MAXIMIZE\n", "OBJSENSE MAXIMIZE\n",
                   "OBJSENSE MAX\n"):
        path = str(tmp_path / "s.mps")
        with open(path, "w") as f:
            f.write("NAME S\n" + header + base)
        parsed = mps.parse_mps(path)
        assert parsed["sense"] == "MAX"
        c, *_ = mps.lp_relaxation(parsed)
        np.testing.assert_allclose(c, [-2.0])   # negated for max


def test_mps_bounds_free_format_and_missing_value(tmp_path):
    """BOUNDS edge forms: the free-format 3-token 'UP COL VAL' line (no
    bound-set name) must keep the bound, and a value-carrying key with
    the value column missing must raise a parse error rather than
    propagate None into the bound arrays."""
    import pytest
    from interiorpoint.utils import mps

    tmpl = ("NAME S\nROWS\n N  OBJ\n L  CAP\nCOLUMNS\n"
            "    X1        OBJ       1.0   CAP       1.0\n"
            "RHS\n    RHS       CAP       4.0\nBOUNDS\n{}ENDATA\n")
    path = str(tmp_path / "b.mps")
    with open(path, "w") as f:
        f.write(tmpl.format(" UP X1 2.5\n"))
    _, _, _, _, _, ub, _ = mps.lp_relaxation(mps.parse_mps(path))
    np.testing.assert_allclose(ub, [2.5])

    with open(path, "w") as f:
        f.write(tmpl.format(" UP BND X1\n"))
    with pytest.raises(ValueError, match="BOUNDS UP"):
        mps.parse_mps(path)


def test_structured_flow_lp_regression():
    """Committed structured-instance regression (reference family:
    testSolver.py:278-435 solves MIPLIB LP relaxations; aflow40b is a
    fixed-charge network-flow model).  tests/data/miplib/flow40.npy is a
    seeded instance of the same family generated by
    scripts/make_flow_instance.py — sparse ±1 incidence equalities,
    capacity-coupling inequalities, per-variable bounds, degenerate
    optimum — solved here against HiGHS ground truth."""
    from scipy.optimize import linprog
    from interiorpoint.utils import miplib

    path = os.path.join(os.path.dirname(__file__), "data", "miplib",
                        "flow40.npy")
    c, A, b, C, d, ub, lb = miplib.load_lp_npy(path)
    solver = miplib.solve_lp_npy(path, suppress_print=True,
                                 check_cvxpy=False, epsilon=1e-6)
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=list(zip(lb, ub)), method="highs")
    assert ref.status == 0
    assert abs(solver.value - ref.fun) / abs(ref.fun) < 1e-4
    # the returned point must actually be feasible, not just match the value
    x = np.asarray(solver.xstar)
    assert np.max(np.abs(A @ x - b)) < 1e-6
    assert np.max(C @ x - d) < 1e-6
    assert np.all(x >= lb - 1e-8) and np.all(x <= ub + 1e-8)
    # the Mehrotra engine on the same (heavily dual-degenerate) instance
    pd = miplib.solve_lp_npy(path, suppress_print=True, check_cvxpy=False,
                             epsilon=1e-8, algorithm="pd")
    assert abs(pd.value - ref.fun) / abs(ref.fun) < 1e-8
    assert pd.last_metrics["converged"] is True


def test_miplib_instance_regression():
    """Real-instance regression (reference: testSolver.py:278-435 on
    30n20b8/aflow40b).  The blobs are regenerable from public MPS sources
    with scripts/fetch_miplib.py; skipped until fetched (this build
    environment has no network egress)."""
    from scipy.optimize import linprog
    from interiorpoint.utils import miplib

    path = os.path.join(os.path.dirname(__file__), "data", "miplib",
                        "30n20b8.npy")
    if not os.path.exists(path):
        pytest.skip("run scripts/fetch_miplib.py to enable (needs network)")
    c, A, b, C, d, ub, lb = miplib.load_lp_npy(path)
    solver = miplib.solve_lp_npy(path, suppress_print=True,
                                 check_cvxpy=False, epsilon=1e-6)
    ref = linprog(c, A_ub=C, b_ub=d, A_eq=A, b_eq=b,
                  bounds=list(zip(lb, ub)), method="highs")
    assert abs(solver.value - ref.fun) / max(1.0, abs(ref.fun)) < 1e-3


# ---------------------------------------------------------------------------
# Matrix-free mixed-precision solve (ops/kkt.py matrix_free_prepare /
# matrix_free_prepared_solve).
# ---------------------------------------------------------------------------


def test_matrix_free_posdef_solve_accuracy():
    import jax.numpy as jnp
    from interiorpoint.ops.kkt import (matrix_free_prepare,
                                       matrix_free_prepared_solve)

    rng = np.random.default_rng(4)
    n = 60
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    # kappa ~ 1e9 barrier-style spectrum
    eigs = np.logspace(0, 9, n)
    H = (Q * eigs) @ Q.T
    H = 0.5 * (H + H.T)
    b = rng.standard_normal(n)
    Hj = jnp.asarray(H)
    bj = jnp.asarray(b)
    x, rel = matrix_free_prepared_solve(
        matrix_free_prepare(Hj.astype(jnp.float32), bj.dtype),
        lambda v: Hj @ v, bj)
    ref = np.linalg.solve(H, b)
    err = np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref)
    assert float(rel) < 1e-8
    assert err < 1e-6


def test_matrix_free_survives_indefinite_preconditioner():
    """An f32-assembly-perturbed (slightly indefinite) H_pre must still
    produce an accurate solve via the jitter ladder + refinement."""
    import jax.numpy as jnp
    from interiorpoint.ops.kkt import (matrix_free_prepare,
                                       matrix_free_prepared_solve)

    rng = np.random.default_rng(5)
    n = 40
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, 8, n)
    H = (Q * eigs) @ Q.T
    H = 0.5 * (H + H.T)
    # perturb the preconditioner at the f32-rounding magnitude (relative
    # to ||H||) -> possibly indefinite after scaling
    Hp = H + rng.standard_normal((n, n)) * 1e-7 * np.linalg.norm(H, 2)
    Hp = 0.5 * (Hp + Hp.T)
    b = rng.standard_normal(n)
    Hj = jnp.asarray(H)
    bj = jnp.asarray(b)
    x, rel = matrix_free_prepared_solve(
        matrix_free_prepare(jnp.asarray(Hp).astype(jnp.float32), bj.dtype),
        lambda v: Hj @ v, bj)
    ref = np.linalg.solve(H, b)
    assert float(rel) < 1e-7
    assert np.linalg.norm(np.asarray(x) - ref) / np.linalg.norm(ref) < 1e-4


def test_mps_rhs_ranges_optional_set_name(tmp_path):
    """Free-format MPS may omit the RHS/RANGES set name (the field is
    positional and optional); entries on such lines must not be dropped."""
    from interiorpoint.utils import mps

    named = str(tmp_path / "named.mps")
    with open(named, "w") as f:
        f.write(_MPS_SAMPLE)
    nameless = _MPS_SAMPLE.replace(
        "    RHS       CAP       10.0  MINP      1.0\n"
        "    RHS       BAL       4.0   RNG       2.0\n",
        "    CAP       10.0  MINP      1.0\n"
        "    BAL       4.0   RNG       2.0\n").replace(
        "    RNG1      RNG       3.0\n",
        "    RNG       3.0\n")
    assert nameless != _MPS_SAMPLE
    path2 = str(tmp_path / "nameless.mps")
    with open(path2, "w") as f:
        f.write(nameless)

    a = mps.lp_relaxation(mps.parse_mps(named), big=1e4)
    b = mps.lp_relaxation(mps.parse_mps(path2), big=1e4)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y)


def test_metrics_records_and_jsonl(tmp_path):
    """Structured metrics (utils/metrics.py — the SURVEY §5
    observability upgrade over the reference's print-only story): a
    solve populates solver.last_metrics, and when enable()d every solve
    appends one parseable JSON line."""
    import json

    from interiorpoint import LassoSolver, LPSolver
    from interiorpoint.utils import metrics

    rng = np.random.default_rng(3)
    n, m, k = 12, 8, 5
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-1, 1, n)
    c = rng.uniform(-2, 2, n)

    def make():
        return LPSolver(c=c, A=A, b=A @ xf, C=C, d=C @ xf,
                        lower_bound=-3, upper_bound=3,
                        suppress_print=True, check_cvxpy=False,
                        epsilon=1e-6, t0=1)

    # disabled (default): record populated, no file written
    s = make()
    s.solve()
    rec = s.last_metrics
    assert rec["kind"] == "LPSolver" and rec["n"] == n
    assert rec["num_eq"] == m and rec["newton_iters"] > 0
    assert rec["wall_s"] > 0 and not rec["phase1_ran"]
    assert rec["value"] == pytest.approx(s.value)

    path = tmp_path / "solves.jsonl"
    metrics.enable(str(path))
    try:
        make().solve()
        Al = rng.random((20, 6))
        bl = Al @ rng.random(6) + 0.01 * rng.standard_normal(20)
        LassoSolver(Al, bl, reg=0.1, check_cvxpy=False).solve()
    finally:
        metrics.disable()
    assert not metrics.enabled()
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert [r["kind"] for r in lines] == ["LPSolver", "LassoSolver"]
    assert lines[1]["num_samples"] == 1
    # records survive json round-trip with sane counters
    assert all(r["newton_iters"] >= 1 and "ts" in r for r in lines)

    # solves after disable() don't append
    make().solve()
    assert len(path.read_text().splitlines()) == 2


@pytest.mark.parametrize("rhs", ["vector", "matrix"])
@pytest.mark.parametrize("cond", [1e2, 1e4, 1e6, 1e8, 1e10, 1e12, 1e14])
def test_mixed_posdef_solve_vs_numpy(cond, rhs):
    """The default float64 factor path (float32 Cholesky of the Jacobi-
    scaled system, float64 refinement, exact float64 fallback on a stall)
    solves as accurately as NumPy's float64 solve across conditioning."""
    import jax
    import jax.numpy as jnp
    from interiorpoint.ops.kkt import mixed_posdef_solve

    rng = np.random.default_rng(int(np.log10(cond)))
    n = 48
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    # a badly scaled diagonal on top, as barrier Hessians have
    D = np.logspace(-3, 3, n)
    H = D[:, None] * ((Q * np.logspace(0, np.log10(cond), n)) @ Q.T) * D
    H = 0.5 * (H + H.T)
    B = rng.standard_normal(n if rhs == "vector" else (n, 3))
    X = np.asarray(jax.jit(mixed_posdef_solve)(jnp.asarray(H),
                                                jnp.asarray(B)))
    X_ref = np.linalg.solve(H, B)
    assert X.shape == B.shape

    def resid(Y):
        return np.linalg.norm(H @ Y - B) / (
            np.linalg.norm(H) * np.linalg.norm(Y) + np.linalg.norm(B))

    # normwise backward error within a small multiple of NumPy's
    assert resid(X) <= 10 * resid(X_ref) + 1e-15
    fwd = np.linalg.norm(X - X_ref) / np.linalg.norm(X_ref)
    assert fwd <= max(1e-12, cond * 1e-14)


# ---------------------------------------------------------------------------
# Compile cache directory (utils/compile_cache.py)
# ---------------------------------------------------------------------------


def _capture_config(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_uses_the_environment_directory(monkeypatch, tmp_path):
    from interiorpoint.utils import compile_cache

    calls = _capture_config(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    from interiorpoint.utils import compile_cache

    calls = _capture_config(monkeypatch)
    made = []
    monkeypatch.setattr(os, "makedirs", lambda p, exist_ok: made.append(p))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.CHECKOUT_CACHE_DIR
    assert calls == [("jax_compilation_cache_dir", path)] and made == [path]


def test_compile_cache_path_is_fixed_and_ignored_by_git():
    from interiorpoint.utils import compile_cache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = compile_cache.CHECKOUT_CACHE_DIR
    assert os.path.isabs(path)
    assert os.path.dirname(path) == root      # does not move with the cwd
    with open(os.path.join(root, ".gitignore")) as f:
        assert os.path.basename(path) + "/" in f.read().split()


@pytest.mark.parametrize("stats,expected", [
    ({"bytes_limit": 123456789, "bytes_in_use": 5}, 123456789),
    ({}, None),
    (None, None),
])
def test_device_bytes_limit(monkeypatch, stats, expected):
    import jax
    from interiorpoint.utils import memory

    dev = jax.local_devices()[0]

    class Fake:
        def memory_stats(self):
            return stats

    got = memory.device_bytes_limit(Fake())
    assert got == (memory.HOST_BYTES_LIMIT if expected is None else expected)
    assert memory.device_bytes_limit(dev) > 0
