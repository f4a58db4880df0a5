"""Port parity of the training kernels' functions on the CPU: the fused
attention, MoE FFN and tied-head CE of gamer_tpu_torch.ops (their plain
versions, differentiated by autograd) against the JAX Pallas kernels in
interpret mode with their custom VJPs (the TPU backward kernels b, i, k),
outputs and grads at rtol = atol = 1e-4, fp32, with dropout off and on (the
same seed on both sides). The dropout masks the forward and the backward
apply are compared bit for bit through inputs that expose them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.ops.pallas_attention import fused_mask_attention as jax_attention
from gamer_tpu.ops.pallas_ce import TM as CE_TM, fused_ce_rows as jax_ce
from gamer_tpu.ops.pallas_moe import TM as MOE_TM, fused_moe_ffn as jax_moe
from gamer_tpu_torch.ops import fused_attention as FA
from gamer_tpu_torch.ops import fused_ce as FC
from gamer_tpu_torch.ops import fused_moe as FM

TOL = dict(rtol=1e-4, atol=1e-4)
SEED = 321


def _streams(rng, B, S):
    attn = np.ones((B, S), np.int32)
    attn[1, :6] = 0
    attn[-1, S - 9:] = 0
    sessions = np.sort(rng.integers(0, 4, (B, S)), axis=1).astype(np.int32)
    actions = rng.integers(1, 4, (B, S)).astype(np.int32)
    rel = np.cumsum(attn, 1) - 1
    blocks = np.where(attn == 1, rel // 5, -1).astype(np.int32)
    return [attn, sessions, actions, blocks]


def _attention_both(q, k, v, dout, streams, H, kind, rate):
    """(out, dq, dk, dv) of the JAX kernel (interpret) and of the port."""
    jstreams = [jnp.asarray(s) for s in streams]
    f = lambda a, b, c: jax_attention(a, b, c, *jstreams, SEED, H, kind, True, rate)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(dout)))]
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = FA.fused_mask_attention(*leaves, *(torch.as_tensor(s) for s in streams), SEED, H, kind,
                                  rate)
    grads = torch.autograd.grad(got, leaves, torch.as_tensor(dout))
    return want, [got.detach().numpy(), *(g.numpy() for g in grads)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("kind", ["causal", "session", "multi", "session_multi"])
def test_attention_grads_match_jax_kernel(kind, rate):
    B, S, H, Hkv, D = 3, 40, 4, 2, 32
    rng = np.random.default_rng(1)
    q, dout = (rng.standard_normal((B, S, H * D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, S, Hkv * D)).astype(np.float32) for _ in range(2))
    want, got = _attention_both(q, k, v, dout, _streams(rng, B, S), H, kind, rate)
    for name, w, g in zip(("out", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_attention_dropout_masks_are_bit_exact():
    """With q = 0 every allowed key gets the same probability, and with
    one-hot values (and G = 1) out[i, j] and dv[j, i] are nonzero exactly
    where key j of query i is allowed and kept: the forward's and the
    backward's masks, read off both packages."""
    B, S, H, D = 2, 32, 2, 32
    rng = np.random.default_rng(2)
    streams = _streams(rng, B, S)
    q = np.zeros((B, S, H * D), np.float32)
    k = rng.standard_normal((B, S, H * D)).astype(np.float32)
    eye = np.tile(np.eye(S, D, dtype=np.float32), (B, 1, H))  # value of key j = e_j
    want, got = _attention_both(q, k, eye, eye, streams, H, "causal", 0.2)
    np.testing.assert_array_equal(got[0] != 0, want[0] != 0)  # forward mask
    np.testing.assert_array_equal(got[3] != 0, want[3] != 0)  # backward mask (dv)
    kept = (want[0] != 0).mean()
    assert 0.3 < kept < 0.6  # causal half, 80% of it kept


def _moe_inputs(rng, P, T, D, F, NB):
    xp = (rng.standard_normal((P, T, D)) * 0.5).astype(np.float32)
    wgu = (rng.standard_normal((P, D, 2 * F)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.standard_normal((P, F, D)) / np.sqrt(F)).astype(np.float32)
    btab = (rng.standard_normal((P, NB, 2 * F)) * 0.1).astype(np.float32)
    beh = rng.integers(0, NB, (P, T)).astype(np.int32)
    gout = rng.standard_normal((P, T, D)).astype(np.float32)
    return xp, wgu, wd, btab, beh, gout


def _moe_both(xp, wgu, wd, btab, beh, gout, rate, use_bias):
    """(out, dxp, dwgu, dwd, dbtab) of the JAX kernel (interpret) and of the port."""
    P, T = beh.shape
    jbeh = jnp.asarray(beh.reshape(P, T // MOE_TM, MOE_TM))
    f = lambda *w: jax_moe(*w, jbeh, SEED, "silu", rate, use_bias, True)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (xp, wgu, wd, btab)))
    want = [np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(gout)))]
    leaves = [torch.tensor(a, requires_grad=True) for a in (xp, wgu, wd, btab)]
    got = FM.fused_moe_ffn(*leaves, torch.as_tensor(beh), SEED, rate=rate, use_bias=use_bias)
    grads = torch.autograd.grad(got, leaves, torch.as_tensor(gout), allow_unused=True,
                                materialize_grads=True)
    return want, [got.detach().numpy(), *(g.numpy() for g in grads)]


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("use_bias", [False, True])
def test_moe_grads_match_jax_kernel(use_bias, rate):
    args = _moe_inputs(np.random.default_rng(3), 2, MOE_TM, 128, 128, 4)
    want, got = _moe_both(*args, rate, use_bias)
    for name, w, g in zip(("out", "dxp", "dwgu", "dwd", "dbtab"), want, got):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_moe_dropout_masks_are_bit_exact():
    """Gate weights 0 with gate bias 1, up and down weights the identity:
    out = keep * silu(1) * x / keep_frac, and dx = keep * silu(1) * gout /
    keep_frac, so their nonzero patterns are the forward's and the
    backward's masks."""
    P, T, D = 2, MOE_TM, 128
    rng = np.random.default_rng(4)
    xp = rng.standard_normal((P, T, D)).astype(np.float32)
    gout = rng.standard_normal((P, T, D)).astype(np.float32)
    eye = np.tile(np.eye(D, dtype=np.float32), (P, 1, 1))
    wgu = np.concatenate([np.zeros_like(eye), eye], axis=2)
    btab = np.concatenate([np.ones((P, 1, D), np.float32), np.zeros((P, 1, D), np.float32)], 2)
    beh = np.zeros((P, T), np.int32)
    want, got = _moe_both(xp, wgu, eye, btab, beh, gout, 0.2, True)
    np.testing.assert_array_equal(got[0] != 0, want[0] != 0)
    np.testing.assert_array_equal(got[1] != 0, want[1] != 0)
    assert 0.75 < (want[0] != 0).mean() < 0.85


def test_ce_grads_match_jax_kernel():
    rng = np.random.default_rng(5)
    N, D, V, Vp, inv_t = CE_TM, 64, 333, 384, 1 / 0.7
    h = rng.standard_normal((N, D)).astype(np.float32)
    table = (rng.standard_normal((V, D)) / np.sqrt(D)).astype(np.float32)
    tgt = rng.integers(0, V, N).astype(np.int32)
    valid = (rng.random(N) > 0.25).astype(np.int32)
    g = rng.random(N).astype(np.float32)
    planes = [jnp.asarray(a.reshape(-1, 1, CE_TM)) for a in (tgt, valid)]
    f = lambda hh, tt: jax_ce(hh, jnp.pad(tt, ((0, Vp - V), (0, 0))), *planes, V, inv_t, True)
    nll, vjp = jax.vjp(f, jnp.asarray(h), jnp.asarray(table))
    want_dh, want_de = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in (h, table)]
    got, _ = FC.fused_ce_rows(*leaves, torch.as_tensor(tgt), torch.as_tensor(valid), inv_t)
    dh, de = torch.autograd.grad(got, leaves, torch.as_tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(nll), **TOL)
    np.testing.assert_allclose(dh.numpy(), np.asarray(want_dh), **TOL)
    np.testing.assert_allclose(de.numpy(), np.asarray(want_de), **TOL)
    assert (dh.numpy()[valid == 0] == 0).all()


def test_gelu_qwen3multi_loss_and_grads_match_jax():
    """A tiny Qwen3Multi with hidden_act "gelu" through the fused MoE path
    (the port's default): the port's training loss and every parameter's
    grad against the JAX `make_loss_fn` with its MoE Pallas kernel in
    interpret mode (attention and CE on both sides' plain paths, which
    other tests hold to the kernels), at the tolerances of
    tests/test_torch_train.py."""
    from gamer_tpu.models.generative import qwen_family as JQ
    from gamer_tpu.tasks.train_smb_decoder import make_loss_fn as jax_make_loss_fn
    from gamer_tpu_torch.convert import to_flax
    from gamer_tpu_torch.models.generative import qwen_family as TQ
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from tests.test_torch_qwen_family import make_batch, tiny_kwargs
    from tests.test_torch_train import _assert_trees_close

    # one layer that is sparse, cross-attending and behavior-injected
    kw = tiny_kwargs("jnp", hidden_act="gelu", num_hidden_layers=1, sparse_layers=[0],
                     cross_attention_layers=[0], behavior_injection_layers=[0])
    batch = make_batch(JQ.build_config("Qwen3Multi", **kw), B=2, blocks=4)
    jcfg = JQ.build_config("Qwen3Multi", **{**kw, "moe_impl": "pallas_interpret"})
    jmodel = JQ.QwenFamilyModel(jcfg)
    tcfg = TQ.QwenFamilyConfig.from_dict({**jcfg.to_dict(), "moe_impl": "auto"})
    tmodel = TQ.QwenFamilyModel(tcfg, device="cpu", seed=0)
    # the port's seeded weights in the flax layout (the tree from a trace of
    # init, which is much cheaper than running it)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    template = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                  **JQ.prepare_train_inputs(jcfg, jbatch)))
    params = to_flax(dict(tmodel.named_parameters()), template)
    jloss_fn = jax_make_loss_fn(jmodel, jmodel.cfg, deterministic=False)
    (want, want_aux), want_grads = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        params, jbatch, jax.random.PRNGKey(3))
    loss, aux = make_loss_fn(tmodel, deterministic=False)(batch, torch.Generator().manual_seed(3))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    assert int(aux["denom"]) == int(want_aux["denom"])
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    _assert_trees_close(to_flax(grads, params), jax.device_get(want_grads))
