"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card.  These tests need an NVIDIA GPU and skip without one; this file
imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.dg.basis import diff_matrix, lgl_nodes_weights
from repro_torch.dg.solver import gaussian_pulse, make_two_tree_solver
from repro_torch.kernels import ref
from repro_torch.kernels.dg_flux import dg_flux
from repro_torch.kernels.dg_volume import dg_volume
from repro_torch.kernels.flash_attention import HEAD_DIMS, bf16_tiling, flash_attention

pytestmark = pytest.mark.cuda

TDT = {"float32": torch.float32, "float64": torch.float64}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(dt):
    return dict(rtol=5e-4, atol=5e-4) if dt == "float32" else dict(rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("K,order", [(16, 7), (24, 3), (7, 5), (1, 2)])
@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_dg_volume_kernel(cuda, K, order, dt):
    rng = np.random.default_rng(K + order)
    M = order + 1
    x, _ = lgl_nodes_weights(order)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=TDT[dt], device=cuda)
    args = (t(rng.standard_normal((K, 9, M, M, M))), t(diff_matrix(x)), (2.0, 3.0, 4.0),
            t(rng.uniform(0.5, 2, K)), t(rng.uniform(0.5, 2, K)), t(rng.uniform(0, 2, K)))
    n0 = dg_volume.launches
    got = dg_volume(*args)
    assert dg_volume.launches == n0 + 1
    torch.testing.assert_close(got, ref.dg_volume_ref(*args), **_tol(dt))


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_dg_volume_kernel_at_the_dg_paper_metric(cuda, dt):
    """The solver's own D, metrics (2/h = 32) and materials; the error is
    held against the sum of the magnitudes of the terms each output adds
    up, which large cancelling derivatives leave far above the result."""
    s = make_two_tree_solver(grid=(32, 16, 16), order=7, device=cuda)
    sel = torch.cat([torch.arange(0, 64), torch.arange(s.mesh.K - 64, s.mesh.K)]).to(cuda)
    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.standard_normal((128, 9, 8, 8, 8)), dtype=TDT[dt], device=cuda)
    args = (q, s.D.to(q.dtype), s.metrics, s.rho_t[sel].to(q.dtype), s.lam_t[sel].to(q.dtype),
            s.mu_t[sel].to(q.dtype))
    err = (dg_volume(*args) - ref.dg_volume_ref(*args)).abs()
    assert bool((err <= _tol(dt)["atol"] * (1 + ref.dg_volume_term_scale(*args))).all())


@pytest.mark.parametrize("F,M", [(10, 8), (200, 4), (128, 8)])
@pytest.mark.parametrize("dt", ["float32", "float64"])
@pytest.mark.parametrize("axis,sign", [(0, 1.0), (1, -1.0), (2, 1.0)])
def test_dg_flux_kernel(cuda, F, M, dt, axis, sign):
    rng = np.random.default_rng(F + M + axis)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=TDT[dt], device=cuda)
    mats = np.abs(rng.standard_normal((F, 8))) + 0.5
    mats[: F // 3, 3] = 0.0
    args = (t(rng.standard_normal((F, 6, M, M))), t(rng.standard_normal((F, 3, M, M))),
            t(rng.standard_normal((F, 6, M, M))), t(rng.standard_normal((F, 3, M, M))),
            t(mats), axis, sign)
    n0 = dg_flux.launches
    (FE, Fv), (FE_r, Fv_r) = dg_flux(*args), ref.dg_flux_ref(*args)
    assert dg_flux.launches == n0 + 1
    torch.testing.assert_close(FE, FE_r, **_tol(dt))
    torch.testing.assert_close(Fv, Fv_r, **_tol(dt))


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros((2, 9, 3, 3, 3), dtype=torch.float64, device=cuda)
    D = torch.zeros((3, 3), dtype=torch.float64, device=cuda)
    one = torch.ones(2, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        dg_flux(q[:, :6, 0], q[:, 6:, 0].contiguous(), q[:, :6, 0].contiguous(),
                q[:, 6:, 0].contiguous(), torch.ones((2, 8), dtype=torch.float64, device=cuda),
                0, 1.0)
    with pytest.raises(ValueError, match="float32"):
        dg_volume(q, D.float(), (1.0, 1.0, 1.0), one, one, one)
    with pytest.raises(ValueError, match="device"):
        dg_volume(q, D.cpu(), (1.0, 1.0, 1.0), one, one, one)


def test_flat_solver_kernels_match_plain_version(cuda):
    s = make_two_tree_solver(grid=(8, 4, 4), order=3, device=cuda)
    plain = make_two_tree_solver(grid=(8, 4, 4), order=3, device=cuda, kernel_impl="torch")
    q0 = gaussian_pulse(s, center=(1.0, 0.5, 0.5), device=cuda)
    n0 = dg_volume.launches
    a, b = s.run(q0, 5), plain.run(q0, 5)
    assert dg_volume.launches == n0 + 25
    torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def _flash_inputs(cuda, dt, B, Hq, Hkv, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    t = lambda shape: torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                                      device=cuda).to(dt)
    return t((B, Hq, Sq, D)), t((B, Hkv, Skv, D)), t((B, Hkv, Skv, D))


FLASH_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}  # tests/test_kernels.py


@pytest.mark.parametrize("S,D", [(256, 64), (192, 32), (128, 128), (200, 80), (96, 160)])
@pytest.mark.parametrize("mode", ["causal", "encoder", "swa"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel(cuda, S, D, mode, dt):
    """The sweep of the reference's own kernel test (plus head dims 80 and
    160 at ragged lengths), GQA 2:1 read in place."""
    q, k, v = _flash_inputs(cuda, dt, 2, 4, 2, S, S, D, S + D)
    kw = dict(causal=(mode != "encoder"), window=(S // 4 if mode == "swa" else None))
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == n0 + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    tol = FLASH_TOL[dt]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_kernel_q_offset(cuda):
    """Queries at positions 40.. against 104 keys (a prefix already in the
    cache), GQA 7:1 as in qwen2-7b."""
    q, k, v = _flash_inputs(cuda, torch.float32, 1, 7, 1, 64, 104, 128, 3)
    got = flash_attention(q, k, v, causal=True, q_offset=40)
    want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=40)
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


def _bf16_case(cuda, B, Hq, Hkv, Sq, Skv, D, seed, **kw):
    """One bf16 launch (the wgmma kernel) against the plain version."""
    q, k, v = _flash_inputs(cuda, torch.bfloat16, B, Hq, Hkv, Sq, Skv, D, seed)
    n0 = flash_attention.launches
    got = flash_attention(q, k, v, **kw)
    assert flash_attention.launches == n0 + 1
    want = ref.flash_attention_ref(q, k, v, **kw)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_bf16_at_the_slice(cuda):
    """qwen2-7b's attention on one sub-batch: B 2, Hq 28, Hkv 4, S 2048,
    D 128, causal."""
    _bf16_case(cuda, 2, 28, 4, 2048, 2048, 128, 11, causal=True)


def test_flash_bf16_q_offset(cuda):
    """300 queries after a 1748-token prefix (Skv 2048), GQA 7:1."""
    _bf16_case(cuda, 1, 7, 1, 300, 2048, 128, 12, causal=True, q_offset=1748)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bf16_ragged_lengths(cuda, D, causal):
    """Sq 200 and Skv 333, neither a multiple of a tile, at every compiled
    head dim (causal: the queries follow a 133-token prefix)."""
    _bf16_case(cuda, 2, 4, 2, 200, 333, D, D, causal=causal, q_offset=133 if causal else 0)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_bf16_window_edge_inside_a_tile(cuda, D):
    """A window of 200 keys: its edge falls inside the 128-row kv tiles."""
    _bf16_case(cuda, 1, 4, 2, 512, 512, D, 5, causal=True, window=200)


def test_flash_bf16_first_visited_tile_fully_masked(cuda):
    """Window 16: q tile 1 (rows 128..255) starts at kv tile 0, which is
    fully masked for its rows 143..255; the next tile's rescale must wipe
    what it left exactly."""
    window = 16
    assert (128 - window + 1) // bf16_tiling(128)["block_k"] == 0
    _bf16_case(cuda, 1, 2, 1, 512, 512, 128, 6, causal=True, window=window)


def test_flash_attention_refuses_what_it_does_not_take(cuda):
    q, k, v = _flash_inputs(cuda, torch.float32, 1, 2, 1, 8, 8, 48, 0)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_attention(q, k, v)
    q, k, v = _flash_inputs(cuda, torch.float64, 1, 2, 1, 8, 8, 64, 0)
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k, v)
    q, k, v = _flash_inputs(cuda, torch.float32, 1, 2, 1, 8, 8, 64, 0)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k.expand(1, 3, 8, 64).contiguous(), v.expand(1, 3, 8, 64).contiguous())
