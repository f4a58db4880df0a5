"""Port parity: RMSNorm, RoPE, attention cores and GQAAttention
(gamer_tpu_torch.modules.layers) against the JAX package, in fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.modules import layers as JL
from gamer_tpu_torch.convert import state_dict_from_jax
from gamer_tpu_torch.modules import layers as TL
from gamer_tpu_torch.ops import qk_norm_rope as QN

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    want = JL.RMSNorm(1e-6).apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = TL.RMSNorm(16, 1e-6)
    norm.load_state_dict({"weight": torch.as_tensor(scale)})
    _close(norm(torch.as_tensor(x)), want)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 60, (2, 7)).astype(np.int32)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    jcos, jsin = JL.rope_cos_sin(jnp.asarray(pos), 32)
    tcos, tsin = QN.rope_cos_sin(torch.as_tensor(pos), 32)
    _close(tcos, jcos)
    _close(tsin, jsin)
    _close(QN.apply_rope(torch.as_tensor(x), tcos, tsin),
           JL.apply_rope(jnp.asarray(x), jcos, jsin))


def test_attend_matches_jax_with_no_key_rows():
    rng = np.random.default_rng(2)
    B, Sq, Sk, H, Hkv, D = 2, 9, 11, 4, 2, 16
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    allowed = rng.random((B, 1, Sq, Sk)) > 0.5
    allowed[0, 0, 3] = False  # a row with no allowed key
    allowed[1, 0, 0] = False
    want = JL.attend(*map(jnp.asarray, (q, k, v, allowed)), D ** -0.5)
    got = TL.attend(*map(torch.as_tensor, (q, k, v, allowed)), D ** -0.5)
    _close(got, want)
    assert (got[0, 3] == 0).all() and (got[1, 0] == 0).all()


@pytest.mark.parametrize("with_generated", [False, True])
def test_attend_shared_prompt_matches_jax(with_generated):
    rng = np.random.default_rng(3)
    B, K, S, T, H, Hkv, D = 2, 3, 10, 2, 4, 2, 16
    q = rng.standard_normal((B * K, 1, H, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    kg, vg = (rng.standard_normal((B * K, T, Hkv, D)).astype(np.float32) for _ in range(2))
    allowed = rng.random((B, S)) > 0.3
    if not with_generated:
        allowed[1] = False  # a frozen cross row with no key -> zeros
    gen = (kg, vg) if with_generated else (None, None)
    want = JL.attend_shared_prompt(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                   *(None if a is None else jnp.asarray(a) for a in gen),
                                   jnp.asarray(allowed), D ** -0.5)
    got = TL.attend_shared_prompt(torch.as_tensor(q), torch.as_tensor(kp), torch.as_tensor(vp),
                                  *(None if a is None else torch.as_tensor(a) for a in gen),
                                  torch.as_tensor(allowed), D ** -0.5)
    _close(got, want)


@pytest.mark.parametrize("is_cross", [False, True])
def test_gqa_attention_matches_jax(is_cross):
    rng = np.random.default_rng(4)
    B, S, Dm, H, Hkv, D, NB = 2, 12, 64, 4, 2, 16, 3
    x = rng.standard_normal((B, S, Dm)).astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None].repeat(B, 0)
    act = rng.integers(0, NB + 1, (B, S)).astype(np.int32)
    allowed = np.tril(np.ones((S, S), bool))[None, None] & (act[:, None, None, :] < act[:, None, :, None])
    mod = JL.GQAAttention(num_heads=H, num_kv_heads=Hkv, head_dim=D, is_cross=is_cross,
                          num_behavior=NB)
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(allowed))
    kw = dict(action_index=jnp.asarray(act)) if is_cross else {}
    params = mod.init(jax.random.PRNGKey(0), *args, **kw)
    want, _ = mod.apply(params, *args, **kw)

    tmod = TL.GQAAttention(Dm, H, Hkv, D, is_cross=is_cross, num_behavior=NB, use_kernel=False)
    tmod.load_state_dict(state_dict_from_jax(params))
    targs = (torch.as_tensor(x), torch.as_tensor(pos), torch.as_tensor(allowed))
    tkw = dict(action_index=torch.as_tensor(act)) if is_cross else {}
    got, _ = tmod(*targs, **tkw)
    _close(got, want)
