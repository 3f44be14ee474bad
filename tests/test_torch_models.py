"""The port's LM stack against the JAX package on the same inputs and the
same weights (carried by ``convert.lm_params_from``): head plans, norms,
rope, MLPs, and the smoke ``qwen2-7b`` prefill and decode logits against the
reference's mesh-free ``LM`` (called outside any ``logical_axis_rules``, as
``tests/test_models.py`` does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.shapes import smoke_config as jsmoke_config
from repro.models import common as jcommon
from repro.models.zoo import LM as JLM
from repro.models.zoo import get_config as jget_config
from repro.models.zoo import list_archs as jlist_archs
from repro_torch.configs.shapes import smoke_config
from repro_torch.convert import lm_params_from, model_config_from
from repro_torch.models import common
from repro_torch.models.zoo import LM, get_config
from repro_torch.parallel.steps import greedy

TOL = dict(rtol=5e-4, atol=5e-4)  # the reference's float32 kernel tolerance


def _zoo_head_shapes():
    shapes = set()
    for a in jlist_archs():
        c = jget_config(a)
        if getattr(c, "n_heads", 0):
            shapes.add((c.n_heads, c.n_kv_heads))
    return sorted(shapes)


@pytest.mark.parametrize("tp", [1, 16])
def test_head_plan_matches_reference(tp):
    shapes = _zoo_head_shapes()
    assert len(shapes) >= 5
    for q, kv in shapes:
        ours, ref = common.make_head_plan(q, kv, tp), jcommon.make_head_plan(q, kv, tp)
        assert ours.__dict__ == ref.__dict__, (q, kv, tp)


def test_config_carries_every_reference_field():
    jcfg = jget_config("qwen2-7b")
    cfg = model_config_from(jcfg, kernel_impl="torch")
    assert cfg == get_config("qwen2-7b").replace(kernel_impl="torch")
    assert cfg.padded_vocab == jcfg.padded_vocab and cfg.head_dim_ == jcfg.head_dim_
    assert smoke_config(get_config("qwen2-7b")) == model_config_from(
        jsmoke_config(jcfg), kernel_impl="auto")
    with pytest.raises(KeyError, match="qwen2-7b"):
        get_config("mixtral-8x22b")


def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 64), np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    np.testing.assert_allclose(
        common.rmsnorm(torch.as_tensor(x), torch.as_tensor(scale), 1e-6).numpy(),
        np.asarray(jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6)), **TOL)
    pos = np.tile(np.arange(5, dtype=np.int32) + 7, (2, 1))[:, None, :]
    for pct in (1.0, 0.25):  # partial rotary (stablelm-2 style) passes channels through
        inv = common.rope_freqs(64, 1e4, pct)
        np.testing.assert_array_equal(inv, jcommon.rope_freqs(64, 1e4, pct))
        got = common.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), torch.as_tensor(inv))
        want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), jnp.asarray(inv))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bf16 inputs: cos and sin are cast to the input dtype before the multiply
    xb = torch.as_tensor(x).to(torch.bfloat16)
    got = common.apply_rope(xb, torch.as_tensor(pos), torch.as_tensor(inv))
    want = jcommon.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), jnp.asarray(inv))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("mlp_type", ["gated_silu", "gelu"])
def test_mlp_matches_reference(mlp_type):
    rng = np.random.default_rng(1)
    d, f = 32, 48
    names = (["w_gate", "w_up", "w_down"] if mlp_type == "gated_silu"
             else ["w_up", "b_up", "w_down", "b_down"])
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d), "b_up": (f,), "b_down": (d,)}
    p = {n: rng.standard_normal(shapes[n]).astype(np.float32) * 0.2 for n in names}
    x = rng.standard_normal((3, 7, d), np.float32)
    want = jcommon.gated_mlp_apply({n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x),
                                   mlp_type)
    got = common.gated_mlp_apply({n: torch.as_tensor(a) for n, a in p.items()},
                                 torch.as_tensor(x), mlp_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def smoke_pair():
    """The smoke qwen2-7b in float32 on both sides, with the reference's
    weights carried into the port."""
    jcfg = jsmoke_config(jget_config("qwen2-7b"))
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(0))
    cfg = model_config_from(jcfg, kernel_impl="auto")
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from(params, cfg, device="cpu"))
    return jlm, params, lm


def test_lm_params_from_fills_every_weight(smoke_pair):
    _, params, lm = smoke_pair
    sd = lm_params_from(params, lm.cfg, device="cpu")
    assert set(sd) == set(lm.state_dict())
    np.testing.assert_array_equal(lm.layers[1].attn["wk"].numpy(),
                                  np.asarray(params["layers"]["attn"]["wk"][1]))


def test_smoke_prefill_and_decode_match_reference(smoke_pair):
    jlm, params, lm = smoke_pair
    cfg = lm.cfg
    rng = np.random.default_rng(2)
    B, S, n_dec = 2, 40, 8
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    max_len = S + n_dec + 4
    jlogits, jcache = jlm.prefill(params, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    logits, cache = lm.prefill(torch.as_tensor(toks, dtype=torch.long), max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(cache["seg0"]["k"].numpy(), np.asarray(jcache["seg0"]["k"]), **TOL)
    jtok = jnp.argmax(jnp.where(jnp.arange(jlogits.shape[-1]) < cfg.vocab_size, jlogits, -jnp.inf),
                      axis=-1).astype(jnp.int32)
    tok = greedy(logits, cfg.vocab_size)
    for _ in range(n_dec):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jlogits, jcache = jlm.decode_step(params, jcache, jtok)
        logits, cache = lm.decode_step(cache, tok)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        jtok = jnp.argmax(jnp.where(jnp.arange(jlogits.shape[-1]) < cfg.vocab_size, jlogits,
                                    -jnp.inf), axis=-1).astype(jnp.int32)
        tok = greedy(logits, cfg.vocab_size)
    assert cache["len"] == S + n_dec


def test_port_decode_matches_prefill(smoke_pair):
    """Decoding token by token reproduces the full-sequence logits, with the
    cache length a scalar and a per-row vector."""
    _, _, lm = smoke_pair
    rng = np.random.default_rng(3)
    B, S, S0 = 2, 48, 42
    toks = torch.as_tensor(rng.integers(0, lm.cfg.vocab_size, (B, S)), dtype=torch.long)
    full, _ = lm(toks)
    for per_row in (False, True):
        logits, cache = lm.prefill(toks[:, :S0], max_len=S + 8)
        if per_row:
            cache["len"] = torch.full((B,), S0, dtype=torch.long)
        errs = [float((logits - full[:, S0 - 1]).abs().max())]
        for t in range(S0, S):
            logits, cache = lm.decode_step(cache, toks[:, t])
            errs.append(float((logits - full[:, t]).abs().max()))
        assert max(errs) < 5e-4, (per_row, errs)


def test_unported_families_raise():
    base = get_config("qwen2-7b")
    for kw, item in ((dict(family="moe", n_experts=4), "A15"), (dict(ssm_state=8), "A16"),
                     (dict(family="vlm", frontend_tokens=16), "A14")):
        with pytest.raises(NotImplementedError, match=item):
            LM(smoke_config(base).replace(**kw), device="cpu")
