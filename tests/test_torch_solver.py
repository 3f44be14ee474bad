"""The port's flat solver against the JAX package's: LSRK4(5) stage loop,
a 10-step trajectory on periodic and non-periodic two-tree bricks, equal
``cfl_dt`` and energy, energy that does not grow, and no silent CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dg import rk as jrk
from repro.dg import solver as jsolver
from repro.dg.mesh import make_brick as jmake_brick
from repro.dg.mesh import two_tree_materials as jtwo_tree
from repro_torch import convert
from repro_torch.dg import rk
from repro_torch.dg.solver import DGSolver, gaussian_pulse, make_two_tree_solver
from repro_torch.runtime.schedule import CalibrationReport

# one intra-op thread: the suite runs several pytest workers on one machine,
# and PyTorch's default of a thread per core oversubscribes it
torch.set_num_threads(1)


def _pair(periodic):
    """The same two-tree brick as a reference solver and a port solver."""
    m = jmake_brick((8, 4, 4), (2.0, 1.0, 1.0), periodic=periodic)
    rho, lam, mu, _ = jtwo_tree(m)
    js = jsolver.DGSolver(mesh=m, order=3, rho=rho, lam=lam, mu=mu, kernel_impl="xla")
    return js, convert.solver_from(js, kernel_impl="torch", device="cpu")


def test_lsrk_stage_loop_matches_reference_eager_loop():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((7, 9, 3, 3, 3))
    res = rng.standard_normal((7, 9, 3, 3, 3))
    jq, jres = jrk.lsrk45_step(jnp.asarray(q), jnp.asarray(res), lambda x: x * 1.25 - 0.5, 1e-3)
    tq, tres = rk.lsrk45_step(torch.as_tensor(q), torch.as_tensor(res),
                              lambda x: x * 1.25 - 0.5, 1e-3)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    for a, b in ((rk.LSRK_A, jrk.LSRK_A), (rk.LSRK_B, jrk.LSRK_B)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("periodic", [False, True])
def test_ten_step_trajectory_matches_reference(periodic):
    js, ts = _pair(periodic)
    assert ts.cfl_dt() == js.cfl_dt()
    rng = np.random.default_rng(4)
    q0 = rng.standard_normal((ts.mesh.K, 9, ts.M, ts.M, ts.M))
    dt = js.cfl_dt()
    want = np.asarray(js.run(jnp.asarray(q0), 10, dt, fused=False))
    t0 = torch.as_tensor(q0)
    got = ts.run(t0, 10, dt)
    np.testing.assert_array_equal(t0.numpy(), q0)  # the caller's field is intact
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    assert ts.energy(got) <= ts.energy(t0)
    np.testing.assert_allclose(ts.energy(got), js.energy(jnp.asarray(want)), rtol=1e-10)


@pytest.mark.parametrize("name,cp,cs,comp",
                         [("acoustic", (1.0, 1.0), (0.0, 0.0), 6),
                          ("coupled", (1.0, 3.0), (0.0, 2.0), 6),
                          ("elastic", (2.0, 2.0), (1.0, 1.0), 7)])
def test_energy_never_grows(name, cp, cs, comp):
    s = make_two_tree_solver(grid=(6, 4, 4), order=3, extent=(1.5, 1.0, 1.0), cp=cp, cs=cs,
                             device="cpu")
    q0 = gaussian_pulse(s, center=(0.75, 0.5, 0.5), component=comp, device="cpu")
    e0 = s.energy(q0)
    e1 = s.energy(s.run(q0, 30))
    assert np.isfinite(e1) and e1 <= e0 * 1.0001, (name, e0, e1)


def test_make_two_tree_solver_and_pulse_match_reference():
    js = jsolver.make_two_tree_solver()
    ts = make_two_tree_solver(device="cpu")
    for field in ("rho", "lam", "mu"):
        np.testing.assert_array_equal(getattr(ts, field), getattr(js, field))
    np.testing.assert_array_equal(ts.node_coords(), js.node_coords())
    np.testing.assert_array_equal(ts.neighbors.numpy(), np.asarray(js.neighbors))
    np.testing.assert_allclose(ts.cp_t.numpy(), np.asarray(js.cp_j), rtol=1e-15)
    np.testing.assert_array_equal(gaussian_pulse(ts, device="cpu").numpy(),
                                  np.asarray(jsolver.gaussian_pulse(js)))
    assert ts.zero_state().shape == (ts.mesh.K, 9, 4, 4, 4)
    assert ts.lift == js.lift and ts.metrics == js.metrics


def test_calibrate_reports_one_partition():
    s = make_two_tree_solver(grid=(4, 2, 2), order=2, device="cpu")
    rep = s.calibrate(gaussian_pulse(s, device="cpu"), reps=1)
    assert isinstance(rep, CalibrationReport)
    assert rep.step_s.shape == (1,) and rep.step_s[0] > 0


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None legitimately means it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_two_tree_solver()
    s = make_two_tree_solver(device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gaussian_pulse(s)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.field_from(np.zeros(3))


def test_kernel_impl_cuda_on_cpu_raises():
    s = make_two_tree_solver(grid=(4, 2, 2), order=2, device="cpu", kernel_impl="cuda")
    q = gaussian_pulse(s, device="cpu")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        s.rhs(q)
    with pytest.raises(ValueError, match="kernel_impl"):
        make_two_tree_solver(device="cpu", kernel_impl="pallas")


def test_solver_from_carries_a_periodic_mesh():
    m = jmake_brick((4, 4, 2), (1.0, 1.0, 0.5), periodic=True)
    K = m.K
    js = jsolver.DGSolver(mesh=m, order=2, rho=np.ones(K), lam=np.ones(K), mu=np.zeros(K),
                          dtype="float32")
    ts = convert.solver_from(js, device="cpu")
    assert ts.tdtype == torch.float32 and ts.mesh.grid == m.grid
    np.testing.assert_array_equal(ts.mesh.neighbors, m.neighbors)
    assert isinstance(ts, DGSolver) and (ts.mesh.neighbors >= 0).all()
