"""Port parity: the fused tied-head CE (gamer_tpu_torch.ops.fused_ce) on the
CPU, i.e. the kernel's plain version, and the causal-LM losses, against the
JAX Pallas kernel in interpret mode and the JAX losses. fp32, tolerance 1e-5;
covers the shift, IGNORE_LABEL rows, row_valid and temperature; bf16 inputs
through the kernel and its VJP; the dE kernel's row splits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.modules import losses as JL
from gamer_tpu.ops.pallas_ce import TM, _ce_forward, fused_ce_rows as jax_fused
from gamer_tpu_torch.modules import losses as TL
from gamer_tpu_torch.ops import fused_ce as FC

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, D, V = 3, 29, 64, 333  # V not a lane multiple; B*(S-1) not a tile multiple


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    hidden = (rng.standard_normal((B, S, D)) * 0.3).astype(np.float32)
    table = (rng.standard_normal((V, D)) / np.sqrt(D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S))
    labels[rng.random((B, S)) < 0.3] = JL.IGNORE_LABEL
    labels[:, :3] = JL.IGNORE_LABEL
    return hidden, table, labels.astype(np.int32), np.array([1, 1, 0], np.int32)


def test_plain_version_matches_jax_kernel():
    rng = np.random.default_rng(1)
    N, Vp = TM, 384
    h = rng.standard_normal((N, D)).astype(np.float32)
    table = np.zeros((Vp, D), np.float32)
    table[:V] = rng.standard_normal((V, D)) / np.sqrt(D)
    tgt = rng.integers(0, V, N).astype(np.int32)
    valid = (rng.random(N) > 0.25).astype(np.int32)
    want = jax_fused(jnp.asarray(h), jnp.asarray(table), jnp.asarray(tgt.reshape(-1, 1, TM)),
                     jnp.asarray(valid.reshape(-1, 1, TM)), V, 1 / 0.7, True)
    nll, lse = FC.fused_ce_rows(torch.as_tensor(h), torch.as_tensor(table[:V]),
                                torch.as_tensor(tgt), torch.as_tensor(valid), 1 / 0.7)
    np.testing.assert_allclose(nll.numpy(), np.asarray(want), **TOL)
    assert (nll.numpy()[valid == 0] == 0).all()
    logits = (h @ table[:V].T) / 0.7
    m = logits.max(-1)
    np.testing.assert_allclose(lse.numpy(), m + np.log(np.exp(logits - m[:, None]).sum(-1)),
                               **TOL)


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_losses_match_jax(temperature):
    hidden, table, labels, row_valid = _loss_inputs()
    jh, jt, jl, jr = map(jnp.asarray, (hidden, table, labels, row_valid))
    th, tt, tl, tr = map(torch.as_tensor, (hidden, table, labels, row_valid))
    want, want_denom = JL.fused_causal_lm_loss_with_denom(jh, jt, jl, temperature, jr,
                                                          interpret=True)
    got, denom = TL.fused_causal_lm_loss_with_denom(th, tt, tl, temperature, tr)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert int(denom) == int(want_denom)

    logits = np.einsum("bsd,vd->bsv", hidden, table)
    want, want_denom = JL.causal_lm_loss_with_denom(jnp.asarray(logits), jl, temperature, jr)
    got, denom = TL.causal_lm_loss_with_denom(torch.as_tensor(logits), tl, temperature, tr)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert int(denom) == int(want_denom)
    np.testing.assert_allclose(float(TL.causal_lm_loss(torch.as_tensor(logits), tl, temperature)),
                               float(JL.causal_lm_loss(jnp.asarray(logits), jl, temperature)),
                               **TOL)


def test_all_targets_ignored_gives_zero_loss_and_unit_denom():
    hidden, table, labels, _ = _loss_inputs(2)
    labels[:] = TL.IGNORE_LABEL
    loss, denom = TL.fused_causal_lm_loss_with_denom(
        torch.as_tensor(hidden), torch.as_tensor(table), torch.as_tensor(labels))
    assert float(loss) == 0.0 and int(denom) == 1


@pytest.mark.parametrize("temperature", [1.0, 0.7])
def test_plain_version_bf16_matches_jax_kernel(temperature):
    """bf16 h and table (made in fp32 with numpy, rounded once, the same
    values on both sides). Forward nll and lse at 1e-5 of their max; the
    VJP's dh and dE at 2e-2: the TPU kernel rounds dlog to bf16 before its two
    products (pallas_ce.py:77) and the plain version does not (3e-3 to 5e-3
    in dh and dE here)."""
    rng = np.random.default_rng(7)
    N, Vp, inv_t = TM, 384, 1 / temperature
    h = rng.standard_normal((N, D)).astype(np.float32)
    table = np.zeros((Vp, D), np.float32)
    table[:V] = rng.standard_normal((V, D)) / np.sqrt(D)
    tgt = rng.integers(0, V, N).astype(np.int32)
    tgt[:2] = V - 1  # the ragged last 64-column chunk of the kernels
    valid = (rng.random(N) > 0.25).astype(np.int32)
    g = rng.random(N).astype(np.float32)
    jh, jt = jnp.asarray(h, jnp.bfloat16), jnp.asarray(table, jnp.bfloat16)
    planes = [jnp.asarray(a.reshape(-1, 1, TM)) for a in (tgt, valid)]
    want_nll, want_lse = _ce_forward(jh, jt, *planes, V, inv_t, True)
    _, vjp = jax.vjp(lambda a, b: jax_fused(a, b, *planes, V, inv_t, True), jh, jt)
    want_dh, want_de = vjp(jnp.asarray(g))

    th, tt = (torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16().requires_grad_(True)
              for a in (jh, jt[:V]))
    nll, lse = FC.fused_ce_rows(th, tt, torch.as_tensor(tgt), torch.as_tensor(valid), inv_t)
    dh, de = torch.autograd.grad(nll, (th, tt), torch.as_tensor(g))
    assert dh.dtype == de.dtype == torch.bfloat16

    def close(got, want, tol):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        assert np.abs(got - want).max() <= tol * np.abs(want).max()

    close(nll.detach().numpy(), want_nll, 1e-5)
    close(lse.detach().numpy(), np.asarray(want_lse).reshape(N), 1e-5)
    close(dh.float().numpy(), want_dh.astype(jnp.float32), 2e-2)
    close(de.float().numpy(), want_de[:V].astype(jnp.float32), 2e-2)
    assert (np.asarray(want_de[V:], np.float32) == 0).all()  # padded vocab rows
    assert (dh.float().numpy()[valid == 0] == 0).all()


@pytest.mark.parametrize("N,V,sms,want", [(64 * 504, 1041, 132, (30, 1088)),
                                          (1000, 1041, 132, (4, 256)),
                                          (5, 17, 132, (1, 64)),
                                          (64 * 504, 17, 132, (126, 256)),
                                          (10 ** 5, 40000, 132, (1, 100032))])
def test_de_splits_fill_two_waves(N, V, sms, want):
    """The dE kernel's vocab tiles times its row splits fit two waves of two
    CTAs an SM; splits are whole 64-row tiles, at least 256 rows where there
    are enough, and together cover every row."""
    splits, rows = FC.de_splits(N, V, sms)
    assert (splits, rows) == want
    assert rows % FC.TM == 0 and splits * rows >= N > (splits - 1) * rows
    assert splits * -(-V // 64) <= 4 * sms or splits == 1
