"""Checkpoint / warm-start tests (new capability; the reference has only a
memoized resolve cache, LPSolver.py:525-526)."""

import numpy as np

from interiorpoint import LPSolver
from interiorpoint.utils import checkpoint


def _gen(seed=21):
    rng = np.random.default_rng(seed)
    n, m, k = 30, 24, 6
    A = rng.uniform(-2, 2, (m, n))
    C = rng.uniform(-2, 2, (k, n))
    xf = rng.uniform(-2, 2, n)
    c = rng.uniform(-2, 2, n)
    return c, A, A @ xf, C, C @ xf


def test_save_load_roundtrip(tmp_path):
    c, A, b, C, d = _gen()
    ls = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9)
    v1 = ls.solve()
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, ls)
    state = checkpoint.load_state(path)
    np.testing.assert_allclose(state["x"], np.asarray(ls.xstar))
    assert float(state["value"]) == float(ls._result.value)


def test_warm_solve_converges_fast(tmp_path):
    c, A, b, C, d = _gen(seed=22)
    ls = LPSolver(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
                  suppress_print=True, check_cvxpy=False, epsilon=1e-9)
    v1 = ls.solve()
    cold_iters = sum(ls.inner_iters)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, ls)
    state = checkpoint.load_state(path)

    v2 = checkpoint.warm_solve(ls, state)
    warm_iters = sum(ls.inner_iters)
    assert abs(v2 - v1) / max(abs(v1), 1.0) < 1e-6
    assert warm_iters < cold_iters / 2


def test_midsolve_checkpoint_resume(tmp_path):
    """True mid-solve resume: kill a staged solve partway through the
    barrier stages, resume from the checkpoint file in a FRESH solver, and
    reach the same optimum as an uninterrupted solve — without repeating
    the completed stages."""
    c, A, b, C, d = _gen(seed=23)
    kw = dict(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
              suppress_print=True, check_cvxpy=False, epsilon=1e-9,
              staged_dispatch=True)
    ref = LPSolver(**kw)
    v_ref = ref.solve()
    total_stages = ref.outer_iters
    p1 = ref._result.phase1
    p1_stages = (int(p1.outer_iters)
                 if p1 is not None and np.isfinite(p1.s) else 0)
    # interrupt after phase one finished but before the barrier converged
    # (max_outer_iters caps phase-1 and main stages separately)
    mid = p1_stages + 2
    assert mid < total_stages, "test problem too easy to interrupt"

    path = str(tmp_path / "mid.npz")
    part = LPSolver(**kw)
    part.solve(max_outer_iters=mid, checkpoint_path=path)
    assert part.outer_iters == mid

    res = LPSolver(**kw)
    v2 = res.solve(checkpoint_path=path, resume=True)
    assert abs(v2 - v_ref) / max(abs(v_ref), 1.0) < 1e-8
    # the resumed run continued from stage `mid` (its final counter
    # includes the checkpointed stages: same total as the clean run)
    assert res.outer_iters == total_stages
    # phase one was NOT re-run on resume (restored from the checkpoint)
    if p1_stages:
        assert int(res._result.phase1.outer_iters) == p1_stages


def test_phase1_checkpoint_resume(tmp_path):
    """A kill during PHASE ONE is resumable too: the partial solve dies
    with phase-1 incomplete (ValueError), yet the checkpoint lets a
    fresh solver continue phase one from its last stage and solve."""
    import pytest

    c, A, b, C, d = _gen(seed=23)
    kw = dict(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
              suppress_print=True, check_cvxpy=False, epsilon=1e-9,
              staged_dispatch=True)
    ref = LPSolver(**kw)
    v_ref = ref.solve()
    p1 = ref._result.phase1
    assert p1 is not None and np.isfinite(p1.s), "seed must need phase 1"
    p1_stages = int(p1.outer_iters)
    assert p1_stages > 2, "seed must need >2 phase-1 stages"

    path = str(tmp_path / "p1.npz")
    part = LPSolver(**kw)
    with pytest.raises(ValueError, match="Phase 1"):
        part.solve(max_outer_iters=2, checkpoint_path=path)

    res = LPSolver(**kw)
    v2 = res.solve(checkpoint_path=path, resume=True)
    assert abs(v2 - v_ref) / max(abs(v_ref), 1.0) < 1e-8
    # resumed phase one continued from stage 2: same final stage counter
    assert int(res._result.phase1.outer_iters) == p1_stages


def test_midsolve_resume_reconciles_trace_caps(tmp_path):
    """Resuming under a different config cap must not lose history: the
    partial run's max_outer_iters=mid sizes its checkpointed obj_vals /
    inner_iters traces at mid, and the resume (default cap) must place
    them in the head of its larger trace arrays so the final
    objective_vals covers EVERY stage (utils/checkpoint.py
    _restore_namedtuple reconciliation).  A resume whose caps are
    SMALLER than the checkpoint's raises instead of truncating."""
    import pytest

    c, A, b, C, d = _gen(seed=23)
    kw = dict(c=c, A=A, b=b, C=C, d=d, lower_bound=-3, upper_bound=3,
              suppress_print=True, check_cvxpy=False, epsilon=1e-9,
              staged_dispatch=True)
    ref = LPSolver(**kw)
    v_ref = ref.solve()
    total = ref.outer_iters
    p1 = ref._result.phase1
    p1_stages = (int(p1.outer_iters)
                 if p1 is not None and np.isfinite(p1.s) else 0)
    mid = p1_stages + 2
    assert mid < total

    path = str(tmp_path / "mid.npz")
    part = LPSolver(**kw)
    part.solve(max_outer_iters=mid, checkpoint_path=path)

    res = LPSolver(**kw)
    v2 = res.solve(checkpoint_path=path, resume=True)
    assert abs(v2 - v_ref) / max(abs(v_ref), 1.0) < 1e-8
    # the full trace: checkpointed head + resumed tail, no dropped stages
    assert len(res.objective_vals) == total
    assert len(res.inner_iters) == total
    ref_tail = ref.objective_vals[mid:]
    np.testing.assert_allclose(res.objective_vals[mid:], ref_tail,
                               rtol=1e-8)

    small = LPSolver(**kw)
    with pytest.raises(ValueError, match="at least as large"):
        small.solve(max_outer_iters=mid - 1, checkpoint_path=path,
                    resume=True)
