"""The port's memory estimate and remat policies on the CPU: `count_params`
against the JAX package's for the seven Qwen presets (exact), the automatic
choice (never on the CPU, off for the flagship step and attn for B 64 x S
8190 on an 80 GB card, taken by `train_SMB_decoder` when no flag is given),
and each remat policy's training step (fp32, dropout 0.2) against remat off:
loss and every grad bit for bit, with the attention cores run again by
"full" and "dots" and not by "attn"."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gamer_tpu.models.generative import qwen_family as JQ
from gamer_tpu.tasks.train_smb_decoder import make_loss_fn as jax_make_loss_fn
from gamer_tpu.train import memory as JM
from gamer_tpu_torch.data import synthetic as TS
from gamer_tpu_torch.entry import flagship_config, make_batch
from gamer_tpu_torch.models.generative import qwen_family as TQ
from gamer_tpu_torch.modules import layers as TL
from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
from gamer_tpu_torch.train import memory as TM
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_tasks_smb import run_port

PRESETS = list(TQ.QWEN_FAMILY_PRESETS)


@pytest.mark.parametrize("backbone", PRESETS)
def test_count_params_matches_jax(backbone):
    kw = dict(vocab_size=1041, padded_vocab_size=1152, num_behavior=3)
    assert TM.count_params(TQ.build_config(backbone, **kw)) == JM.count_params(
        JQ.build_config(backbone, **kw))
    model = TQ.QwenFamilyModel(TQ.build_config(backbone, vocab_size=64, hidden_size=32,
                                               num_hidden_layers=2, head_dim=8,
                                               intermediate_size=48), device="cpu")
    real = sum(p.numel() for p in model.parameters())
    approx = TM.count_params(model.cfg)
    assert abs(approx - real) / real < 0.10, (approx, real)


def test_selector():
    """Never on the CPU; at the flagship widths on an 80 GB card: off for the
    flagship step, attn at B 64 x S 8190; the port's estimate counts more
    than JAX's (its RMSNorms' fp32 copies and dropout temporaries; the q/k
    norm and RoPE keep only the pre-norm q and k and an fp32 rstd a head)."""
    cfg = flagship_config(dtype="bfloat16", dropout_rate=0.2)
    assert TM.device_hbm_bytes("cpu") == float("inf")
    assert TM.auto_remat_overrides(cfg, 1024, 8192, device="cpu") == {}
    remat, policy, est = TM.select_remat(cfg, 64, 505, hbm_bytes=80e9)
    assert not remat and policy == "attn"
    assert est["total"] == est["params"] + est["acts"] + est["logits"]
    jcfg = JQ.QwenFamilyConfig.from_dict(cfg.to_dict())
    assert est["total"] > JM.estimate_train_hbm_bytes(jcfg, 64, 505)["total"] * 1.4
    remat, policy, _ = TM.select_remat(cfg, 64, 8190, hbm_bytes=80e9)
    assert remat and policy == "attn"
    # the plain paths keep more: [tokens, V] logits, S^2 attention rows
    plain = TM.estimate_train_hbm_bytes(
        cfg.replace(attention_impl="jnp", moe_impl="jnp", ce_impl="jnp"), 64, 505)
    assert plain["total"] > est["total"] and plain["logits"] > 1041 * 64 * 505


def test_train_task_takes_the_automatic_choice(tmp_path, monkeypatch):
    """train_SMB_decoder without --gradient_checkpointing takes remat from
    `train/memory.py`: on a card too small for the step, policy attn."""
    TS.write_synthetic_dataset(str(tmp_path / "data"), "Demo", TS.SyntheticSpec(
        n_users=12, n_items=20, num_levels=2, level_sizes=(4, 5), min_len=5, max_len=8,
        seed=1))
    argv = ["train_SMB_decoder", "--dataset", "Demo", "--data_path", tmp_path / "data",
            "--tasks", "smb_explicit_decoder_2", "--max_his_len", 4, "--epochs", 1,
            "--batch_size", 8, "--n_layers", 1, "--hidden_size", 16,
            "--model_max_length", 64]
    run_port(argv + ["--output_dir", tmp_path / "off"])
    monkeypatch.setattr(TM, "device_hbm_bytes", lambda device=None: 1e3)
    run_port(argv + ["--output_dir", tmp_path / "auto"])
    run_port(argv + ["--output_dir", tmp_path / "pinned", "--no-gradient_checkpointing"])
    saved = lambda name: json.loads((tmp_path / name / "config.json").read_text())
    assert not saved("off")["remat"] and not saved("pinned")["remat"]
    assert saved("auto")["remat"] and saved("auto")["remat_policy"] == "attn"


def _step(cfg, batch, counter):
    model = TQ.QwenFamilyModel(cfg, device="cpu", seed=3)
    counter["n"] = 0
    loss, _ = make_loss_fn(model, cfg, deterministic=False)(batch, torch.Generator().manual_seed(5))
    forward_calls = counter["n"]
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()}, forward_calls,
            counter["n"])


@pytest.fixture
def attention_calls(monkeypatch):
    """Counts the attention cores' calls (the fused attention's plain
    version here, kernel a on the card)."""
    counter = {"n": 0}
    core = TL.fa.fused_mask_attention

    def counted(*args, **kw):
        counter["n"] += 1
        return core(*args, **kw)

    monkeypatch.setattr(TL.fa, "fused_mask_attention", counted)
    return counter


def test_remat_policies_match_remat_off(attention_calls):
    cfg = flagship_config(tiny=True, dropout_rate=0.2)
    batch = make_batch(cfg, 3, 4, np.random.default_rng(2))
    want, want_grads, fwd, total = _step(cfg, batch, attention_calls)
    assert fwd == total == 3  # 2 self-attention layers, 1 cross-attention
    reruns = {"full": 3, "dots": 3, "attn": 0}
    for policy, rerun in reruns.items():
        loss, grads, fwd, total = _step(cfg.replace(remat=True, remat_policy=policy), batch,
                                        attention_calls)
        assert (fwd, total - fwd) == (3, rerun), policy
        assert torch.equal(loss, want), policy
        for name, g in want_grads.items():
            assert torch.equal(grads[name], g), (policy, name)
    with pytest.raises(ValueError, match="remat_policy"):
        _step(cfg.replace(remat=True, remat_policy="everything"), batch, attention_calls)


def test_each_norm_runs_once_a_step():
    """Without remat every RMSNorm of the flagship layers runs once a training
    step (the cross-attention gate reuses its input's norm, so remat off
    keeps the layer's graph and its grads bit for bit); under "attn" each
    runs twice (the recompute)."""
    cfg = flagship_config(tiny=True, dropout_rate=0.2)
    batch = make_batch(cfg, 2, 3, np.random.default_rng(0))
    for remat, calls in ((False, 1), (True, 2)):
        c = cfg.replace(remat=remat, remat_policy="attn")
        model = TQ.QwenFamilyModel(c, device="cpu", seed=0)
        counts = {}
        for name, mod in model.named_modules():
            if isinstance(mod, TL.RMSNorm) and name.startswith("layers.") and "attn" not in name:
                counts[name] = 0
                mod.register_forward_hook(lambda m, i, o, n=name: counts.__setitem__(n, counts[n] + 1))
        loss, _ = make_loss_fn(model, c, deterministic=False)(batch, torch.Generator().manual_seed(1))
        loss.backward()
        assert "layers.1.post_self_attention_layernorm" in counts
        assert set(counts.values()) == {calls}, counts


def test_jax_attn_policy_reruns_its_attention_kernel():
    """The deliberate difference of ROADMAP section 3.3: JAX's "attn" names
    the o-projection's output, so its backward runs the Pallas attention
    forward again (the grad jaxpr of a tiny Qwen3Multi, 3 attention calls,
    holds 12 `pallas_call`s without remat and 15 with it), where the port's
    keeps each core's saved tensors (test_remat_policies_match_remat_off:
    no attention core runs again)."""
    from tests.test_torch_qwen_family import make_batch as jax_batch
    from tests.test_torch_qwen_family import tiny_kwargs

    counts = []
    for remat in (False, True):
        cfg = JQ.build_config("Qwen3Multi", **tiny_kwargs("pallas_interpret", remat=remat,
                                                          remat_policy="attn"))
        model = JQ.QwenFamilyModel(cfg)
        batch = {k: jnp.asarray(v) for k, v in jax_batch(cfg, B=2).items()}
        params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                                   **JQ.prepare_train_inputs(cfg, batch)))
        loss_fn = jax_make_loss_fn(model, cfg, deterministic=False)
        jaxpr = jax.make_jaxpr(jax.grad(lambda p: loss_fn(p, batch, jax.random.PRNGKey(1))[0]))
        counts.append(str(jaxpr(params)).count("pallas_call["))
    assert counts == [12, 15]
