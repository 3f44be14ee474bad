"""The port's nested-partition runtime against the JAX package and against
its own flat solver: the numpy planners (bucketing, load balance, the
calibration report), blocked == flat before and after a resplice, the
envelope pipeline's launch ledger, the observed run against the reference
engine after carrying the reference plan across, and straggler
rebalancing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import load_balance as jlb
from repro.dg import solver as jsolver
from repro.dg.mesh import make_brick as jmake_brick
from repro.dg.mesh import two_tree_materials as jtwo_tree
from repro.runtime import executor as jexec
from repro.runtime.schedule import CalibrationReport as JReport
from repro_torch import convert
from repro_torch.core import load_balance as lb
from repro_torch.runtime.executor import (
    BlockedDGEngine,
    NestedPartitionExecutor,
    bucket_counts,
    pad_to_bucket,
)
from repro_torch.runtime.schedule import CalibrationReport

# one intra-op thread: the suite runs several pytest workers on one machine,
# and PyTorch's default of a thread per core oversubscribes it
torch.set_num_threads(1)

GRID = (8, 4, 4)
K = 128


def _pair(periodic):
    m = jmake_brick(GRID, (2.0, 1.0, 1.0), periodic=periodic)
    rho, lam, mu, _ = jtwo_tree(m)
    js = jsolver.DGSolver(mesh=m, order=3, rho=rho, lam=lam, mu=mu, kernel_impl="xla")
    return js, convert.solver_from(js, device="cpu")


def _q0(seed=0, M=4):
    return np.random.default_rng(seed).standard_normal((K, 9, M, M, M))


@pytest.mark.parametrize("counts,bucket", [([33, 31, 64], 8), ([5, 0, 3], 16), ([100, 28], 1),
                                           ([2048, 2048, 2048, 2048], 16)])
def test_bucket_counts_and_pads_match_reference(counts, bucket):
    np.testing.assert_array_equal(bucket_counts(counts, bucket), jexec.bucket_counts(counts, bucket))
    for n in counts:
        assert pad_to_bucket(n, bucket) == jexec.pad_to_bucket(n, bucket)


@pytest.mark.parametrize("P,bucket", [(2, 8), (4, 16), (3, 8)])
def test_initial_split_matches_reference(P, bucket):
    a = NestedPartitionExecutor(K, P, grid_dims=GRID, bucket=bucket)
    b = jexec.NestedPartitionExecutor(K, P, grid_dims=GRID, bucket=bucket)
    np.testing.assert_array_equal(a.counts, b.counts)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    assert a.chunk_pads == b.chunk_pads


def test_load_balance_solvers_match_reference():
    rates = [1.0, 2.5, 0.7]
    fns = [lambda k, r=r: 1e-3 + k / r for r in rates]
    a, b = lb.solve_multiway(fns, 1000), jlb.solve_multiway(fns, 1000)
    assert a.counts == b.counts and a.times == b.times
    args = ([32, 32, 64], [0.02, 0.01, 0.01])
    np.testing.assert_array_equal(lb.rebalance_from_measurements(*args, prev_weights=[1, 1, 2]),
                                  jlb.rebalance_from_measurements(*args, prev_weights=[1, 1, 2]))


def test_calibration_report_matches_reference():
    rng = np.random.default_rng(5)
    phases = [rng.uniform(0, 1e-3, 3) for _ in range(4)]
    a, b = CalibrationReport(*phases), JReport(*phases)
    for attr in ("step_s", "overlapped_s", "hidden_s", "overlap_efficiency"):
        np.testing.assert_array_equal(getattr(a, attr), getattr(b, attr))
    counts = [40, 40, 48]
    for fa, fb in zip(a.time_models(counts), b.time_models(counts)):
        assert fa(37.0) == fb(37.0)
    np.testing.assert_array_equal(CalibrationReport.from_chunk(0.3, [1, 2, 0], 5).step_s,
                                  JReport.from_chunk(0.3, [1, 2, 0], 5).step_s)
    assert a.summary() == b.summary()


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("P", [2, 4])
def test_blocked_equals_flat_before_and_after_resplice(periodic, P):
    _, ts = _pair(periodic)
    q0 = torch.as_tensor(_q0(P))
    dt = ts.cfl_dt()
    ex = NestedPartitionExecutor(K, P, grid_dims=GRID, bucket=8)
    eng = BlockedDGEngine(ts, ex)
    flat_rhs = ts.rhs(q0)
    torch.testing.assert_close(eng.rhs(q0), flat_rhs, rtol=0, atol=1e-13)
    torch.testing.assert_close(eng.pipeline().rhs(q0), flat_rhs, rtol=0, atol=1e-13)
    flat = ts.run(q0, 3, dt)
    torch.testing.assert_close(eng.run(q0, 3, dt), flat, rtol=0, atol=1e-13)
    ex.observe(np.linspace(2.0, 1.0, P) * 1e-2)
    ex.rebalance()
    assert not np.array_equal(ex.counts, NestedPartitionExecutor(K, P, grid_dims=GRID,
                                                                 bucket=8).counts)
    torch.testing.assert_close(eng.run(q0, 3, dt), flat, rtol=0, atol=1e-13)
    torch.testing.assert_close(eng.run(q0, 3, dt, fused=False), flat, rtol=0, atol=1e-13)


def test_envelope_pipeline_ledger():
    _, ts = _pair(False)
    ex = NestedPartitionExecutor(K, 3, grid_dims=GRID, bucket=8, rebalance_every=2)
    eng = BlockedDGEngine(ts, ex)
    pipe = eng.pipeline()
    (env, env_own, B), = pipe.bucket_signature
    assert B == 3 and env_own == max(ex.chunk_pads)
    eng.run(torch.as_tensor(_q0(1)), 3)
    assert pipe.stats.kernel_launches == {"volume": 1, "surface": 1}
    assert (pipe.dispatches, pipe.steps_run) == (1, 3)
    eng.run(torch.as_tensor(_q0(1)), 4, observe=True)
    assert pipe.stats.observe_chunks == 2 and pipe.stats.kernel_launches == {"volume": 1, "surface": 1}
    assert pipe.steps_run == 7 and ex.round == 2


def test_observed_run_matches_reference_engine_after_plan_carry():
    js, ts = _pair(True)
    kw = dict(grid_dims=GRID, bucket=8, rebalance_every=2, smoothing=1.0)
    jex = jexec.NestedPartitionExecutor(K, 4, **kw)
    jeng = jexec.BlockedDGEngine(js, jex)
    jex.observe([0.03, 0.01, 0.01, 0.02])
    jex.rebalance()  # a non-trivial reference plan
    tex = NestedPartitionExecutor(K, 4, **kw)
    teng = BlockedDGEngine(ts, tex)
    tex.apply(convert.plan_from(jex))
    np.testing.assert_array_equal(tex.counts, jex.counts)
    for a, b in zip(tex.partition.nodes, jex.partition.nodes):
        np.testing.assert_array_equal(a.elements, b.elements)
    q0 = _q0(2)
    dt = js.cfl_dt()
    want = np.asarray(jeng.run(jnp.asarray(q0), 4, dt=dt, observe=True))
    got = teng.run(convert.field_from(q0, device="cpu"), 4, dt=dt, observe=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(tex.counts, jex.counts)
    assert tex.round == jex.round - 1  # the reference's extra round is its pre-carry rebalance


def test_straggler_moves_the_split_within_three_chunks():
    _, ts = _pair(False)
    ex = NestedPartitionExecutor(K, 4, grid_dims=GRID, bucket=8, rebalance_every=2)
    eng = BlockedDGEngine(ts, ex)
    c0 = int(ex.counts[0])
    ex.inject_straggler(0, 2.0)
    eng.run(torch.as_tensor(_q0(3)), 6, observe=True)
    assert eng.pipeline().stats.observe_chunks == 3
    assert int(ex.counts[0]) < c0 and int(ex.counts.sum()) == K


def test_calibrate_then_rebalance():
    _, ts = _pair(False)
    ex = NestedPartitionExecutor(K, 2, grid_dims=GRID, bucket=8)
    eng = BlockedDGEngine(ts, ex)
    rep = eng.calibrate(torch.as_tensor(_q0(4)), reps=1)
    assert (rep.interior_s > 0).all() and (rep.boundary_s > 0).all()
    assert ex._n_obs == 1
    np.testing.assert_array_equal(ex._observed, rep.step_s)
    plan = ex.rebalance()
    assert int(plan.counts.sum()) == K and ex.round == plan.round == 1
    np.testing.assert_array_equal(ex.counts, plan.counts)
    assert eng.measure_block_times(torch.as_tensor(_q0(4))).shape == (2,)


def test_plan_cache_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        NestedPartitionExecutor(K, 2, grid_dims=GRID, plan_cache_dir="plans")
