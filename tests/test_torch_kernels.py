"""The port's kernel module on the CPU: the plain PyTorch versions against the
JAX oracles (``repro.kernels.ref``) over the reference's own sweeps, against
the Pallas kernels in interpret mode on one shape per dtype, and the
``kernel_impl`` switch.  The CUDA kernels themselves are held against the
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dg.basis import diff_matrix, lgl_nodes_weights
from repro.kernels import ref as jref
from repro.kernels.dg_flux import dg_flux_pallas
from repro.kernels.dg_volume import dg_volume_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dg_flux import dg_flux
from repro_torch.kernels.dg_volume import dg_volume

# one intra-op thread: the suite runs several pytest workers on one machine,
# and PyTorch's default of a thread per core oversubscribes it
torch.set_num_threads(1)

TDT = {"float32": torch.float32, "float64": torch.float64}


def _tol(dt):
    return dict(rtol=5e-4, atol=5e-4) if dt == "float32" else dict(rtol=1e-11, atol=1e-11)


def _volume_inputs(K, order, dt, seed):
    rng = np.random.default_rng(seed)
    M = order + 1
    x, _ = lgl_nodes_weights(order)
    arrs = dict(
        q=rng.standard_normal((K, 9, M, M, M)),
        D=diff_matrix(x),
        rho=rng.uniform(0.5, 2, K),
        lam=rng.uniform(0.5, 2, K),
        mu=rng.uniform(0, 2, K),
    )
    j = {k: jnp.asarray(v, dt) for k, v in arrs.items()}
    t = {k: torch.as_tensor(np.asarray(v, dt)) for k, v in arrs.items()}
    return j, t, (2.0, 3.0, 4.0)


def _flux_inputs(F, M, dt, seed):
    rng = np.random.default_rng(seed)
    arrs = dict(
        Sm=rng.standard_normal((F, 6, M, M)),
        vm=rng.standard_normal((F, 3, M, M)),
        Sp=rng.standard_normal((F, 6, M, M)),
        vp=rng.standard_normal((F, 3, M, M)),
    )
    mats = np.abs(rng.standard_normal((F, 8))) + 0.5
    mats[: F // 3, 3] = 0.0  # acoustic minus side -> k1 = 0 branch
    arrs["mats"] = mats
    j = {k: jnp.asarray(v, dt) for k, v in arrs.items()}
    t = {k: torch.as_tensor(np.asarray(v, dt)) for k, v in arrs.items()}
    return j, t


def _volume_args(d, metrics):
    return (d["q"], d["D"], metrics, d["rho"], d["lam"], d["mu"])


def _flux_args(d, axis, sign):
    return (d["Sm"], d["vm"], d["Sp"], d["vp"], d["mats"], axis, sign)


@pytest.mark.parametrize("K,order", [(16, 7), (24, 3), (7, 5), (1, 2)])
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_dg_volume_plain_matches_reference(K, order, dt):
    j, t, metrics = _volume_inputs(K, order, dt, seed=K + order)
    got = ref.dg_volume_ref(*_volume_args(t, metrics))
    assert got.dtype == TDT[dt]
    want = jref.dg_volume_ref(*_volume_args(j, metrics))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dt))


@pytest.mark.parametrize("F,M", [(10, 8), (200, 4), (128, 8)])
@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("axis,sign", [(0, 1.0), (1, -1.0), (2, 1.0)])
def test_dg_flux_plain_matches_reference(F, M, dt, axis, sign):
    j, t = _flux_inputs(F, M, dt, seed=F + M + axis)
    FE, Fv = ref.dg_flux_ref(*_flux_args(t, axis, sign))
    jFE, jFv = jref.dg_flux_ref(*_flux_args(j, axis, sign))
    np.testing.assert_allclose(FE.numpy(), np.asarray(jFE), **_tol(dt))
    np.testing.assert_allclose(Fv.numpy(), np.asarray(jFv), **_tol(dt))


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_dg_volume_plain_matches_pallas_interpret(dt):
    j, t, metrics = _volume_inputs(16, 3, dt, seed=1)
    got = dg_volume(*_volume_args(t, metrics))  # the wrapper, on CPU tensors
    want = dg_volume_pallas(*_volume_args(j, metrics), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol(dt))


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_dg_flux_plain_matches_pallas_interpret(dt):
    j, t = _flux_inputs(40, 4, dt, seed=2)
    FE, Fv = dg_flux(*_flux_args(t, 1, -1.0))
    jFE, jFv = dg_flux_pallas(*_flux_args(j, 1, -1.0), interpret=True)
    np.testing.assert_allclose(FE.numpy(), np.asarray(jFE), **_tol(dt))
    np.testing.assert_allclose(Fv.numpy(), np.asarray(jFv), **_tol(dt))


def test_shear_clamp_follows_the_oracle():
    """An elastic minus side facing a zero shear impedance: the oracle's
    1e-300 clamp (not the Pallas kernel's 1e-30) sets k1, in both ports."""
    j, t = _flux_inputs(6, 3, "float64", seed=3)
    mats = np.ones((6, 8))
    mats[:, 2] = 0.0  # cs- = 0 with mu- > 0: shear denominator 0 -> clamp
    mats[:, 6] = 0.0
    t["mats"] = torch.as_tensor(mats)
    j["mats"] = jnp.asarray(mats)
    FE, Fv = ref.dg_flux_ref(*_flux_args(t, 0, 1.0))
    jFE, jFv = jref.dg_flux_ref(*_flux_args(j, 0, 1.0))
    np.testing.assert_array_equal(FE.numpy(), np.asarray(jFE))
    np.testing.assert_array_equal(Fv.numpy(), np.asarray(jFv))


def test_volume_term_scale_separates_rounding_from_faults():
    """At the dg-paper metric 2/h = 32 and its materials, the float32 JAX
    oracle stays within 5e-4 of the term scale of the port's float64 plain
    version; a transposed D, a dropped lam or a missing field does not."""
    rng = np.random.default_rng(8)
    K, order = 16, 7
    M = order + 1
    x, _ = lgl_nodes_weights(order)
    metrics = (32.0, 32.0, 32.0)
    arrs = dict(q=rng.standard_normal((K, 9, M, M, M)), D=diff_matrix(x), rho=np.ones(K),
                lam=np.ones(K), mu=np.where(np.arange(K) < K // 2, 0.0, 4.0))
    t = {k: torch.as_tensor(v) for k, v in arrs.items()}
    want = ref.dg_volume_ref(*_volume_args(t, metrics))
    scale = ref.dg_volume_term_scale(*_volume_args(t, metrics))
    assert bool((scale >= want.abs()).all())

    def scaled_err(got):
        return float(((torch.as_tensor(np.asarray(got, np.float64)) - want).abs() / (1 + scale)).max())

    j32 = {k: jnp.asarray(v, "float32") for k, v in arrs.items()}
    assert scaled_err(jref.dg_volume_ref(*_volume_args(j32, metrics))) <= 5e-4
    faults = [dict(t, D=t["D"].T.contiguous()), dict(t, lam=torch.zeros(K, dtype=torch.float64)),
              dict(t, q=torch.cat([t["q"][:, :8], torch.zeros_like(t["q"][:, 8:])], dim=1))]
    for bad in faults:
        assert scaled_err(ref.dg_volume_ref(*_volume_args(bad, metrics))) > 0.1


def test_wrappers_count_only_kernel_launches():
    _, t, metrics = _volume_inputs(4, 2, "float64", seed=4)
    v0, f0 = dg_volume.launches, dg_flux.launches
    dg_volume(*_volume_args(t, metrics))  # CPU tensors: plain version, no launch
    _, tf = _flux_inputs(4, 3, "float64", seed=5)
    dg_flux(*_flux_args(tf, 2, 1.0))
    assert (dg_volume.launches, dg_flux.launches) == (v0, f0)


def test_kernel_switch():
    _, t, metrics = _volume_inputs(4, 2, "float64", seed=6)
    args = _volume_args(t, metrics)
    n0 = dg_volume.launches
    torch.testing.assert_close(ops.dg_volume(*args), ops.dg_volume(*args, impl="torch"))
    assert dg_volume.launches == n0  # "auto" on CPU tensors: the plain version
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.dg_volume(*args, impl="cuda")
    _, tf = _flux_inputs(4, 3, "float64", seed=7)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.dg_flux(*_flux_args(tf, 0, 1.0), impl="cuda")
    with pytest.raises(ValueError, match="kernel impl"):
        ops.dg_volume(*args, impl="pallas")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No nvcc, no kernels: the build raises instead of falling back."""
    from repro_torch.kernels import build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at /usr/local/cuda")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not (tmp_path / "build").exists()


def test_wrappers_refuse_tensors_that_are_neither_cpu_nor_cuda():
    """Only a CPU tensor takes the plain version; anything else that is not
    on a CUDA device is refused before a pointer is taken."""
    q = torch.empty((2, 9, 3, 3, 3), dtype=torch.float64, device="meta")
    D = torch.empty((3, 3), dtype=torch.float64, device="meta")
    one = torch.empty(2, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        dg_volume(q, D, (1.0, 1.0, 1.0), one, one, one)
    S = torch.empty((2, 6, 3, 3), dtype=torch.float64, device="meta")
    v = torch.empty((2, 3, 3, 3), dtype=torch.float64, device="meta")
    mats = torch.empty((2, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        dg_flux(S, v, S, v, mats, 0, 1.0)
