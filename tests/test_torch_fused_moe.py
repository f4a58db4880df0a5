"""Port parity: the fused MoE FFN (gamer_tpu_torch.ops.fused_moe) on the CPU,
i.e. the kernel's plain version, against the JAX Pallas kernel in interpret
mode, and PositionRoutedMLP's periodic, fused and one-hot paths against the
JAX module. fp32, tolerance 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.modules.moe import PositionRoutedMLP as JaxMLP
from gamer_tpu.ops.pallas_moe import TM, fused_moe_ffn as jax_fused
from gamer_tpu_torch.convert import state_dict_from_jax
from gamer_tpu_torch.modules.moe import PositionRoutedMLP
from gamer_tpu_torch.ops import fused_moe as FM

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_bias", [False, True])
def test_plain_version_matches_jax_kernel(use_bias):
    P, T, D, F, NB = 3, TM, 128, 128, 4
    rng = np.random.default_rng(0)
    xp = (rng.standard_normal((P, T, D)) * 0.5).astype(np.float32)
    wgu = (rng.standard_normal((P, D, 2 * F)) / np.sqrt(D)).astype(np.float32)
    wd = (rng.standard_normal((P, F, D)) / np.sqrt(F)).astype(np.float32)
    btab = (rng.standard_normal((P, NB, 2 * F)) * 0.1).astype(np.float32)
    beh = rng.integers(0, NB, (P, T)).astype(np.int32)
    want = jax_fused(jnp.asarray(xp), jnp.asarray(wgu), jnp.asarray(wd), jnp.asarray(btab),
                     jnp.asarray(beh.reshape(P, T // TM, TM)), 0, "silu", 0.0, use_bias, True)
    got = FM.fused_moe_ffn(*(torch.as_tensor(a) for a in (xp, wgu, wd, btab, beh)),
                           use_bias=use_bias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # hash dropout is taken: seeded, and different from rate 0
    args = [torch.as_tensor(a) for a in (xp, wgu, wd, btab, beh)]
    dropped = FM.fused_moe_ffn(*args, 5, rate=0.2, use_bias=use_bias)
    assert torch.equal(dropped, FM.fused_moe_ffn(*args, 5, rate=0.2, use_bias=use_bias))
    assert not torch.equal(dropped, got)


# (route_mode, JAX impl, port use_kernel)
PATHS = [("periodic", "jnp", False), ("periodic", "pallas_interpret", True),
         ("onehot", "jnp", False)]


@pytest.mark.parametrize("injection", [False, True])
@pytest.mark.parametrize("route_mode,jax_impl,use_kernel", PATHS)
def test_position_routed_mlp_matches_jax(route_mode, jax_impl, use_kernel, injection):
    B, P, n, D, F, NB, bdim = 2, 5, 4, 128, 128, 3, 32
    S = P * n
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    pos = np.tile(np.arange(S) % P + 1, (B, 1)).astype(np.int32)
    pos[1, -P:] = 0  # pad block: expert 0 on the one-hot path
    beh = rng.integers(0, NB + 1, (B, S)).astype(np.int32)
    mod = JaxMLP(d_model=D, d_ff=F, num_experts=P + 1, behavior_injection=injection,
                 num_behavior=NB, behavior_dim=bdim, impl=jax_impl)
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(beh))
    kw = dict(route_mode=route_mode, num_positions=P)
    params = mod.init(jax.random.PRNGKey(0), *args, **kw)
    want = mod.apply(params, *args, **kw)

    tmod = PositionRoutedMLP(D, F, P + 1, behavior_injection=injection, num_behavior=NB,
                             behavior_dim=bdim, use_kernel=use_kernel)
    tmod.load_state_dict(state_dict_from_jax(params))
    got = tmod(torch.as_tensor(x), torch.as_tensor(pos), torch.as_tensor(beh), **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError):
        PositionRoutedMLP(32, 32, 4, mlp_type="t5")
    with pytest.raises(NotImplementedError):
        PositionRoutedMLP(32, 32, 4, shared_expert=True)
    mlp = PositionRoutedMLP(32, 32, 4)
    with pytest.raises(NotImplementedError):
        mlp(torch.zeros(1, 3, 32), torch.zeros(1, 3, dtype=torch.int32),
            expert_index=torch.zeros(1, 3, dtype=torch.int32), num_positions=3)
