"""Port parity: the scoring forward of the Qwen3 family (gamer_tpu_torch) on
the CPU against the JAX package, on the same weights (gamer_tpu_torch.convert).

The JAX side runs its Pallas kernels in interpret mode ("pallas_interpret")
or its jnp path ("jnp"); the port runs the matching path (the kernels' plain
versions on the CPU, or its plain path). fp32, tolerance 1e-4 on loss and
logits; the valid-target count must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.models.generative import qwen_family as JQ
from gamer_tpu.tasks.train_smb_decoder import make_loss_fn as jax_make_loss_fn
from gamer_tpu_torch.convert import load_jax_params
from gamer_tpu_torch.models.generative import qwen_family as TQ
from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

TOL = dict(rtol=1e-4, atol=1e-4)
IMPLS = ("attention_impl", "moe_impl", "ce_impl")


def tiny_kwargs(impl: str = "jnp", **kw) -> dict:
    """2 layers, hidden 128, d_ff 128, 4/2 heads of 32 (the JAX fused paths
    need 128-multiples)."""
    base = dict(vocab_size=64, hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=32, intermediate_size=128, dropout_rate=0.0,
                num_positions=5, num_experts=6, num_behavior=3, behavior_embedding_dim=32,
                behavior_base=14, temperature=0.7, **{k: impl for k in IMPLS})
    base.update(kw)
    return base


def make_batch(cfg, B: int = 2, blocks: int = 8, seed: int = 0) -> dict:
    """Right-padded scoring batch (numpy): behavior tokens at block starts,
    behavior and pad labels ignored, the last row a batch-padding row."""
    rng = np.random.default_rng(seed)
    P = cfg.num_positions
    S = blocks * P
    ids = rng.integers(cfg.behavior_base + cfg.num_behavior, cfg.vocab_size, (B, S)).astype(np.int32)
    ids[:, ::P] = rng.integers(cfg.behavior_base, cfg.behavior_base + cfg.num_behavior, (B, blocks))
    attn = np.ones((B, S), np.int32)
    attn[-1, S - 2 * P - 1:] = 0
    ids[attn == 0] = 0
    labels = ids.copy()
    labels[attn == 0] = -100
    labels[:, ::P] = -100
    row_valid = np.ones(B, np.int32)
    if B > 1:
        row_valid[-1] = 0
    return dict(
        input_ids=ids, attention_mask=attn, labels=labels, row_valid=row_valid,
        session_ids=np.repeat(np.sort(rng.integers(0, 3, (B, blocks)), axis=1), P, axis=1).astype(np.int32),
        actions=np.repeat(rng.integers(1, 4, (B, blocks)), P, axis=1).astype(np.int32),
        extended_session_ids=np.maximum(np.cumsum(attn, axis=1) - 1, 0).astype(np.int32))


def jax_and_port(backbone: str, batch: dict, route_mode: str = "periodic", **kw):
    """(JAX model, JAX params, port model) of one config on the same weights."""
    jcfg = JQ.build_config(backbone, **kw)
    jmodel = JQ.QwenFamilyModel(jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jmodel.init(jax.random.PRNGKey(0), **JQ.prepare_train_inputs(jcfg, jbatch),
                         route_mode=route_mode)
    tcfg = TQ.QwenFamilyConfig.from_dict(jcfg.to_dict())
    tmodel = load_jax_params(TQ.QwenFamilyModel(tcfg, device="cpu"), params)
    return jmodel, params, tmodel


@pytest.mark.parametrize("impl", ["pallas_interpret", "jnp"])
@pytest.mark.parametrize("backbone", ["Qwen3Multi", "Qwen3", "Qwen3SessionMulti",
                                      "Qwen3MoeAction"])
def test_scoring_loss_matches_jax(backbone, impl):
    kw = tiny_kwargs(impl)
    batch = make_batch(JQ.build_config(backbone, **kw), B=3)
    jmodel, params, tmodel = jax_and_port(backbone, batch, **kw)
    want, want_aux = jax_make_loss_fn(jmodel, jmodel.cfg, deterministic=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, None)
    got, aux = make_loss_fn(tmodel)(batch)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert int(aux["denom"]) == int(want_aux["denom"])


@pytest.mark.parametrize("backbone", ["Qwen3Multi", "Qwen3SessionMulti", "Qwen3MoeAction"])
def test_logits_match_jax(backbone):
    kw = tiny_kwargs()
    batch = make_batch(JQ.build_config(backbone, **kw))
    jmodel, params, tmodel = jax_and_port(backbone, batch, **kw)
    jin = JQ.prepare_train_inputs(jmodel.cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    want = jmodel.apply(params, **jin, route_mode="periodic")["logits"]
    tin = TQ.prepare_train_inputs(tmodel.cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    with torch.no_grad():
        got = tmodel(**tin, route_mode="periodic")["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_presets_and_config_roundtrip_match_jax(tmp_path):
    for backbone in JQ.QWEN_FAMILY_PRESETS:
        want = JQ.build_config(backbone, num_hidden_layers=6).to_dict()
        got = TQ.build_config(backbone, num_hidden_layers=6).to_dict()
        for impl in IMPLS:  # the port defaults to its kernels
            want.pop(impl), got.pop(impl)
        assert got == want, backbone
    cfg = TQ.build_config("Qwen3Multi", dtype="bfloat16")
    again = TQ.QwenFamilyConfig.from_file(cfg.save(str(tmp_path)))
    assert again.to_dict() == cfg.to_dict() and again.extra["backbone"] == "Qwen3Multi"
    assert JQ.QwenFamilyConfig.from_file(str(tmp_path)).to_dict() == cfg.to_dict()


def test_unported_modes_raise():
    """Once the MoeAction preset raised; it now builds with its
    (num_experts - 1) * num_behavior + 1 experts and its expert ids route
    the MLPs (the JAX parity of its forward, loss and grads is held by the
    tests above and by test_torch_train.py)."""
    action_cfg = TQ.build_config("Qwen3MoeAction", **tiny_kwargs())
    action = TQ.QwenFamilyModel(action_cfg, device="cpu")
    assert action.layers[0].mlp.experts_gate.shape[0] == action_cfg.total_experts == 16
    inputs = TQ.prepare_train_inputs(action_cfg, {k: torch.as_tensor(v) for k, v in
                                                  make_batch(action_cfg).items()})
    assert inputs["expert_index"].max() > action_cfg.num_experts - 1
    with torch.no_grad():
        out = action(**inputs)["logits"]
        plain = action(**{**inputs, "expert_index": None})["logits"]
    assert torch.isfinite(out).all() and not torch.allclose(out, plain)
    cfg = TQ.build_config("Qwen3Multi", **tiny_kwargs())
    model = TQ.QwenFamilyModel(cfg, device="cpu")
    # the training loss is ported: it needs a generator and has grads
    train_loss = make_loss_fn(model, deterministic=False)
    with pytest.raises(ValueError):
        train_loss(make_batch(cfg))
    loss, _ = train_loss(make_batch(cfg), torch.Generator().manual_seed(0))
    loss.backward()
    assert all(p.grad is not None for p in model.parameters())
    # the same seed draws the same weights
    again = TQ.QwenFamilyModel(cfg, device="cpu")
    for (name, a), b in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(a, b), name
