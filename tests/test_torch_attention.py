"""The port's attention against the JAX package on the same numpy inputs:
the flash kernel's plain version against the Pallas kernel (interpret mode),
the rounding the bf16 kernel adds (P in bf16 before p.v), the model-level
``flash_attention`` with ``q_offset`` and a replicated-kv head map, and the
decode path with per-row cache lengths."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattn
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS, bf16_tiling
from repro_torch.kernels.flash_attention import flash_attention as flash_kernel
from repro_torch.models import attention as tattn

# the tolerances of the reference's own kernel test (tests/test_kernels.py)
TOL = {"float32": dict(rtol=5e-4, atol=5e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor in ``dt``."""
    return jnp.asarray(a, jnp.dtype(dt)), torch.as_tensor(a).to(TDT[dt])


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("S,D,blocks", [(256, 64, (64, 64)), (192, 32, (64, 32)),
                                        (128, 128, (128, 128))])
@pytest.mark.parametrize("mode", ["causal", "encoder", "swa"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_ref_matches_pallas_kernel(S, D, blocks, mode, dt):
    """The sweep of tests/test_kernels.py::test_flash_kernel."""
    rng = np.random.default_rng(S + D)
    (jq, tq), (jk, tk), (jv, tv) = (_both(rng.standard_normal((2, 2, S, D), np.float32), dt)
                                    for _ in range(3))
    kw = dict(causal=(mode != "encoder"), window=(S // 4 if mode == "swa" else None))
    want = flash_attention_pallas(jq, jk, jv, block_q=blocks[0], block_k=blocks[1],
                                  interpret=True, **kw)
    got = ref.flash_attention_ref(tq, tk, tv, **kw)
    assert got.dtype == TDT[dt]
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dt])


@pytest.mark.parametrize("mode", ["causal", "encoder", "swa"])
def test_flash_ref_reads_gqa_in_place(mode):
    """Hq 4 on Hkv 2: the plain version (and the wrapper's CPU route) equals
    the Pallas kernel on repeated k and v."""
    rng = np.random.default_rng(3)
    S, D = 96, 32
    q = rng.standard_normal((2, 4, S, D), np.float32)
    k = rng.standard_normal((2, 2, S, D), np.float32)
    v = rng.standard_normal((2, 2, S, D), np.float32)
    kw = dict(causal=(mode != "encoder"), window=(24 if mode == "swa" else None))
    want = jops.flash_attention_op(jnp.asarray(q), jnp.asarray(np.repeat(k, 2, axis=1)),
                                   jnp.asarray(np.repeat(v, 2, axis=1)), impl="interpret", **kw)
    t = torch.as_tensor
    for got in (ref.flash_attention_ref(t(q), t(k), t(v), **kw),
                ops.flash_attention_op(t(q), t(k), t(v), impl="auto", **kw),
                flash_kernel(t(q), t(k), t(v), **kw)):
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


def test_flash_ref_is_not_the_unmasked_function():
    """The mask and the GQA head map matter at this tolerance: dropping the
    causal mask, or pairing q head h with kv head h % Hkv, fails."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.as_tensor(rng.standard_normal(s), dtype=torch.float32)
               for s in ((1, 4, 64, 32), (1, 2, 64, 32), (1, 2, 64, 32)))
    good = ref.flash_attention_ref(q, k, v, causal=True)
    assert (good - ref.flash_attention_ref(q, k, v, causal=False)).abs().max() > 0.1
    swapped = ref.flash_attention_ref(q[:, [0, 2, 1, 3]], k, v, causal=True)[:, [0, 2, 1, 3]]
    assert (good - swapped).abs().max() > 0.1


def _flash_bf16_p(q, k, v, *, causal, window, block_k):
    """The plain version as the bf16 kernel rounds it: an online softmax in
    float32 over kv tiles of ``block_k`` rows, each tile's P rounded to bf16
    before p.v (tensor cores: exact products, float32 sums), the row sum l
    taken over the unrounded P."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(Hq // Hkv, dim=1)
    vf = v.float().repeat_interleave(Hq // Hkv, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) / math.sqrt(D)
    qpos = torch.arange(Sq)[:, None]
    kpos = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, ref.MASKED)
    m = torch.full((B, Hq, Sq, 1), ref.MASKED)
    l = torch.zeros((B, Hq, Sq, 1))
    acc = torch.zeros((B, Hq, Sq, D))
    for k0 in range(0, Skv, block_k):
        st = s[..., k0:k0 + block_k]
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(st - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.bfloat16().float(), vf[..., k0:k0 + block_k, :])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,blocks", [
    (2, 2, 2, 256, 64, (64, 64)), (2, 2, 2, 192, 32, (64, 32)), (2, 2, 2, 128, 128, (128, 128)),
    (1, 7, 1, 160, 32, (80, 80)),  # GQA 7:1, as qwen2-7b's heads
])
@pytest.mark.parametrize("mode", ["causal", "encoder", "swa"])
def test_bf16_p_rounding_stays_inside_the_tolerance(B, Hq, Hkv, S, D, blocks, mode):
    """The bf16 kernel rounds P to bf16 for p.v, where the Pallas kernel
    keeps it in float32: emulated at the kernel's kv tile, the result stays
    within the reference's bf16 tolerance of the Pallas kernel, at the
    reference sweep's shapes and at a narrow GQA 7:1 shape."""
    rng = np.random.default_rng(S + D + Hq)
    q = rng.standard_normal((B, Hq, S, D), np.float32)
    k = rng.standard_normal((B, Hkv, S, D), np.float32)
    v = rng.standard_normal((B, Hkv, S, D), np.float32)
    kw = dict(causal=(mode != "encoder"), window=(S // 4 if mode == "swa" else None))
    g = Hq // Hkv
    jq, _ = _both(q, "bfloat16")
    (jk, _), (jv, _) = (_both(np.repeat(x, g, axis=1), "bfloat16") for x in (k, v))
    want = flash_attention_pallas(jq, jk, jv, block_q=blocks[0], block_k=blocks[1],
                                  interpret=True, **kw)
    t = lambda x: torch.as_tensor(x).bfloat16()
    got = _flash_bf16_p(t(q), t(k), t(v), block_k=bf16_tiling(D)["block_k"], **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["bfloat16"])


@pytest.mark.parametrize("D", HEAD_DIMS)
def test_bf16_tiling_by_head_dim(D):
    """Every compiled head dim takes the wgmma + TMA path; its padded rows
    are whole 64-column swizzle rows, and q plus two K/V stages (and the
    1 KB alignment slack and the barriers) fit in a block's 227 KB."""
    t = bf16_tiling(D)
    assert t["path"] == "wgmma+tma"
    assert t["padded_dim"] % 64 == 0 and D <= t["padded_dim"] < D + 64
    assert t["block_q"] == 128 and t["block_k"] in (64, 128)
    row = t["padded_dim"] * 2  # bytes of a padded bf16 row
    smem = 1024 + t["block_q"] * row + 2 * 2 * t["block_k"] * row + 8 * 10
    assert smem <= 232448
    assert t["block_k"] == 128 or 1024 + t["block_q"] * row + 4 * 128 * row > 232448
    with pytest.raises(ValueError, match="head_dim 48"):
        bf16_tiling(48)


@pytest.mark.parametrize("q_offset,kv_map", [(0, None), (32, None), (16, (0, 0, 1, 1, 0, 0))])
def test_flash_attention_matches_reference_blocked(q_offset, kv_map):
    """The model-level entry with a position shift (queries after a prefix)
    and a replicated-kv head map, against the reference's lax version."""
    rng = np.random.default_rng(q_offset + 1)
    Hq = 4 if kv_map is None else len(kv_map)
    Sq, Skv, D = 32, 32 + q_offset, 16
    q = rng.standard_normal((2, Hq, Sq, D), np.float32)
    k = rng.standard_normal((2, 2, Skv, D), np.float32)
    v = rng.standard_normal((2, 2, Skv, D), np.float32)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                 q_offset=q_offset, kv_map=kv_map, block_q=16, block_k=16)
    t = torch.as_tensor
    got = tattn.flash_attention(t(q), t(k), t(v), causal=True, q_offset=q_offset, kv_map=kv_map,
                                block_q=16, block_k=16)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])
    naive = tattn.naive_attention(t(q), t(k), t(v), causal=True, q_offset=q_offset, kv_map=kv_map)
    np.testing.assert_allclose(_f32(naive), _f32(want), **TOL["float32"])


def test_flash_attention_impl_switch():
    x = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="kernel impl"):
        tattn.flash_attention(x, x, x, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        tattn.flash_attention(x, x, x, impl="cuda")


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("kv_map", [None, (0, 0, 1, 1)])
def test_decode_attention_per_row_lengths(window, kv_map):
    rng = np.random.default_rng(5)
    B, Hq, Hkv, C, D = 3, 4, 2, 16, 8
    q = rng.standard_normal((B, Hq, 1, D), np.float32)
    kc = rng.standard_normal((B, Hkv, C, D), np.float32)
    vc = rng.standard_normal((B, Hkv, C, D), np.float32)
    clen = np.array([3, 9, 16], np.int32)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                  jnp.asarray(clen), window=window, kv_map=kv_map)
    t = torch.as_tensor
    got = tattn.decode_attention(t(q), t(kc), t(vc), t(clen), window=window, kv_map=kv_map)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)
    # a scalar length is the per-row path at that length, row by row
    for b, L in enumerate(clen):
        row = tattn.decode_attention(t(q[b:b + 1]), t(kc[b:b + 1]), t(vc[b:b + 1]), int(L),
                                     window=window, kv_map=kv_map)
        np.testing.assert_allclose(_f32(row), _f32(got[b:b + 1]), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rolling", [False, True])
def test_update_cache_per_row_and_scalar(rolling):
    rng = np.random.default_rng(6)
    B, G, C, D = 3, 2, 8, 4
    kc = rng.standard_normal((B, G, C, D), np.float32)
    vc = rng.standard_normal((B, G, C, D), np.float32)
    kn = rng.standard_normal((B, G, 1, D), np.float32)
    vn = rng.standard_normal((B, G, 1, D), np.float32)
    t = torch.as_tensor
    for clen in (np.array([0, 5, 11 if rolling else 7], np.int32), 4):
        jk, jv = jattn.update_cache(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn),
                                    jnp.asarray(vn), jnp.asarray(clen), rolling=rolling)
        tk, tv = t(kc.copy()), t(vc.copy())
        out_k, out_v = tattn.update_cache(tk, tv, t(kn), t(vn),
                                          t(clen) if isinstance(clen, np.ndarray) else clen,
                                          rolling=rolling)
        assert out_k is tk and out_v is tv  # written in place
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_pick_block_matches_reference():
    for n in (1, 7, 48, 96, 512, 2048, 2049):
        for target in (16, 64, 512):
            assert tattn.pick_block(n, target) == jattn.pick_block(n, target)
