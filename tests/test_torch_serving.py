"""The port's one-shot serving against the JAX package: the report -> plan
solve, the greedy tokens of a served batch, the calibration pass and the
CLI.  The reference's ``ServeKernels`` needs a mesh, which this jax
rejects, so the reference side is a greedy loop over its mesh-free
``LM.prefill`` / ``LM.decode_step``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.shapes import smoke_config as jsmoke_config
from repro.models.zoo import LM as JLM
from repro.models.zoo import get_config as jget_config
from repro.runtime.executor import NestedPartitionExecutor as JExecutor
from repro.runtime.schedule import CalibrationReport as JReport
from repro_torch.convert import lm_params_from, model_config_from
from repro_torch.data.pipeline import _rng
from repro_torch.launch import serve as serve_cli
from repro_torch.models.zoo import LM
from repro_torch.parallel.steps import make_serve_step
from repro_torch.runtime.executor import NestedPartitionExecutor
from repro_torch.runtime.schedule import CalibrationReport
from repro_torch.runtime.serving import ServeKernels, build_lm, calibrate_split, decode_batch


@pytest.mark.parametrize("n,P,bucket", [(4, 2, 1), (7, 3, 1), (64, 4, 4), (10, 2, 1)])
@pytest.mark.parametrize("seed", [0, 1])
def test_plan_from_report_matches_reference(n, P, bucket, seed):
    rng = np.random.default_rng([seed, n, P])
    phases = {k: rng.uniform(0.5, 2.0, P) * 1e-3 for k in ("boundary_s", "interior_s",
                                                         "transfer_s")}
    phases["correction_s"] = rng.uniform(0, 0.2, P) * 1e-3
    ours = NestedPartitionExecutor(n, P, bucket=bucket, smoothing=1.0)
    ref = JExecutor(n, P, bucket=bucket, smoothing=1.0)
    for _ in range(2):  # a second solve starts from the first one's counts
        ours.observe(CalibrationReport(**phases).step_s)
        ref.observe(JReport(**phases).step_s)
        a = ours.plan_from_report(CalibrationReport(**phases))
        b = ref.plan_from_report(JReport(**phases))
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(ours.offsets, ref.offsets)
        assert a.round == b.round == ours.round == ref.round
        assert ours.predicted_makespan() == pytest.approx(ref.predicted_makespan(), rel=1e-12)


@pytest.fixture(scope="module")
def smoke_serve():
    jcfg = jsmoke_config(jget_config("qwen2-7b"))
    jlm = JLM(jcfg)
    params = jlm.init(jax.random.PRNGKey(1))
    cfg = model_config_from(jcfg)
    lm = LM(cfg, device="cpu")
    lm.load_state_dict(lm_params_from(params, cfg, device="cpu"))
    return jlm, params, lm


def _reference_greedy(jlm, params, rows, n_gen, max_len):
    vocab = jlm.cfg.vocab_size

    def pick(logits):
        logits = jnp.where(jnp.arange(logits.shape[-1]) < vocab, logits, -jnp.inf)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)

    logits, cache = jlm.prefill(params, {"tokens": jnp.asarray(rows)}, max_len=max_len)
    tok = pick(logits)
    out = [np.asarray(tok)]
    for _ in range(n_gen - 1):
        logits, cache = jlm.decode_step(params, cache, tok)
        tok = pick(logits)
        out.append(np.asarray(tok))
    return np.stack(out, axis=1)


def test_decode_batch_gives_reference_tokens(smoke_serve):
    jlm, params, lm = smoke_serve
    rows = _rng(0, 0).integers(0, lm.cfg.vocab_size, (3, 24), dtype=np.int32)
    kernels = ServeKernels(lm, max_len=24 + 10 + 8)
    gen, t_prefill, t_decode = decode_batch(kernels, rows, 10)
    assert gen.dtype == np.int32 and gen.shape == (3, 10)
    np.testing.assert_array_equal(gen, _reference_greedy(jlm, params, rows, 10, kernels.max_len))
    assert t_prefill > 0 and t_decode > 0
    # an eager loop: one program per decode step
    assert (kernels.stats.dispatches, kernels.stats.steps_run) == (9, 9)
    assert kernels.prefills == 1


def test_calibrate_split_keeps_the_batch_and_bumps_the_round(smoke_serve):
    _, _, lm = smoke_serve
    prompts = _rng(1, 0).integers(0, lm.cfg.vocab_size, (5, 16), dtype=np.int32)
    kernels = ServeKernels(lm, max_len=16 + 4 + 8)
    ex, report = calibrate_split(kernels, prompts, 2, calib_gen=3)
    assert ex.round == 1 and int(ex.counts.sum()) == 5 and (ex.counts >= 0).all()
    assert ex.offsets[0] == 0 and ex.offsets[-1] == 5
    assert (report.boundary_s > 0).all() and (report.interior_s > 0).all()


def test_serve_cli_runs_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "gen.npy"
    assert serve_cli.main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu", "--batch", "4",
                           "--prompt-len", "16", "--gen", "5", "--partitions", "2",
                           "--calib-gen", "2", "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "calibrated split: counts=" in text
    assert "arch=qwen2-7b batch=4 partitions=2" in text
    assert "decode-dispatches/sub-batch=4 (eager loop)" in text
    gen = np.load(out)
    assert gen.shape == (4, 5) and ((gen >= 0) & (gen < 512)).all()
    # the split only reorders work: one batch of the same rows gives the same tokens
    cfg, lm = build_lm("qwen2-7b", smoke=True, seed=0, device="cpu")
    prompts = _rng(0, 0).integers(0, cfg.vocab_size, (4, 16), dtype=np.int32)
    whole, _, _ = decode_batch(ServeKernels(lm, max_len=16 + 5 + 8), prompts, 5)
    np.testing.assert_array_equal(gen, whole)


def test_serve_cli_lists_the_archs(capsys):
    assert serve_cli.main(["--list-scenarios"]) == 0
    assert "qwen2-7b" in capsys.readouterr().out


def test_build_lm_runs_on_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_lm("qwen2-7b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--arch", "qwen2-7b", "--smoke", "--batch", "2"])
    cfg, lm = build_lm("qwen2-7b", smoke=True, device="cpu")
    assert lm.device.type == "cpu" and cfg.kernel_impl == "auto" and cfg.tp_size == 1


def test_masked_serve_step_freezes_inactive_rows(smoke_serve):
    """Active rows take the plain step's token; inactive rows keep their
    token and their per-row cache position."""
    _, _, lm = smoke_serve
    rows = torch.as_tensor(_rng(2, 0).integers(0, lm.cfg.vocab_size, (3, 12)), dtype=torch.long)
    _, cache = lm.prefill(rows, max_len=20)
    plain_tok, _ = make_serve_step(lm)(lm.prefill(rows, max_len=20)[1], rows[:, -1])
    cache["len"] = torch.full((3,), 12, dtype=torch.long)
    active = torch.tensor([True, False, True])
    tok, cache = make_serve_step(lm, masked=True)(cache, rows[:, -1], active)
    np.testing.assert_array_equal(tok.numpy(), np.where(active, plain_tok, rows[:, -1]))
    np.testing.assert_array_equal(cache["len"].numpy(), [13, 12, 13])
