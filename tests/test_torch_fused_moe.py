"""Port parity: the fused MoE FFN (gamer_tpu_torch.ops.fused_moe) on the CPU,
i.e. the kernel's plain version, against the JAX Pallas kernel in interpret
mode, and PositionRoutedMLP's periodic, fused and one-hot paths against the
JAX module. fp32, tolerance 1e-5; bf16 inputs through the kernel and its VJP;
the weight-gradient products' splits over T. MoeAction's grouped launch:
its row table's invariants, and its plain version against the per-level
passes with the masked sum, bit for bit, whole and on a rank's experts."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.modules.moe import PositionRoutedMLP as JaxMLP
from gamer_tpu.ops.pallas_moe import TM, fused_moe_ffn as jax_fused
from gamer_tpu_torch.convert import state_dict_from_jax
from gamer_tpu_torch.core import trace
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


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("use_bias", [False, True])
def test_plain_version_bf16_matches_jax_kernel(use_bias, rate):
    """bf16 inputs (made in fp32 with numpy, rounded once, the same values on
    both sides) through the plain version and its autograd, and through the
    JAX kernel and its VJP in interpret mode: out, dx, dWgu, dWd and dbtab
    at 2e-2 of their max. The TPU kernel rounds h to bf16 before the down
    product (pallas_moe.py:83) and dgu and h_drop before the products that
    read them (:113-121); the plain version keeps them in fp32, which the
    tolerance covers. Ids outside [0, NB) add and receive nothing."""
    P, T, D, F, NB = 2, TM, 128, 128, 4
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal((P, T, D)) * 0.5, rng.standard_normal((P, D, 2 * F)) / np.sqrt(D),
              rng.standard_normal((P, F, D)) / np.sqrt(F), rng.standard_normal((P, NB, 2 * F)) * 0.3]
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    beh = rng.integers(-1, NB + 1, (P, T)).astype(np.int32)
    gout = rng.standard_normal((P, T, D)).astype(np.float32)
    f = lambda *w: jax_fused(*w, jnp.asarray(beh.reshape(P, T // TM, TM)), 9, "silu", rate,
                             use_bias, True)
    out, vjp = jax.vjp(f, *jargs)
    want = [out, *vjp(jnp.asarray(gout, jnp.bfloat16))]

    leaves = [torch.tensor(np.asarray(a.astype(jnp.float32))).bfloat16().requires_grad_(True)
              for a in jargs]
    got = FM.fused_moe_ffn(*leaves, torch.as_tensor(beh), 9, rate=rate, use_bias=use_bias)
    grads = torch.autograd.grad(got, leaves, torch.as_tensor(gout).bfloat16(), allow_unused=True,
                                materialize_grads=True)
    assert got.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    for name, g, w in zip(("out", "dx", "dwgu", "dwd", "dbtab"), (got, *grads), want):
        g, w = g.detach().float().numpy(), np.asarray(w.astype(jnp.float32))
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), name
    if not use_bias:
        assert (np.asarray(want[4], np.float32) == 0).all() and (grads[3] == 0).all()


@pytest.mark.parametrize("T,P,D,F,bf16,want", [
    (64 * 101, 5, 256, 512, True, (6, 1088, 13, 512, 101, 64)),  # the flagship, bf16
    (64 * 101, 5, 256, 512, False, (1, 6464, 3, 2176, 26, 249)),  # and fp32
    (99, 2, 64, 64, True, (1, 128, 1, 128, 2, 64)),  # too few rows to split
    (5, 2, 64, 64, False, (1, 32, 1, 32, 1, 5)),
    (10 ** 6, 8, 256, 1024, True, (2, 500000, 4, 250016, 15625, 64)),  # few splits fill the card
])
def test_weight_grad_splits_fill_two_waves(T, P, D, F, bf16, want):
    """Each product's output tiles times its splits fit two waves of two CTAs
    on 132 SMs; splits are whole 32-row k slices (dbtab: 64-row tiles in
    bf16, any rows in fp32) and together cover every row once."""
    got = FM.weight_grad_splits(T, P, D, F, D, 132, bf16)
    assert got == want
    tile = 128 if bf16 else 64
    tiles = [P * -(-D // tile) * -(-2 * F // tile), P * -(-F // tile) * -(-D // tile)]
    for (splits, rows), n_tiles in zip((got[0:2], got[2:4]), tiles):
        assert rows % 32 == 0 and splits * rows >= T > (splits - 1) * rows
        assert splits * n_tiles <= 4 * 132 or splits == 1
    n_b, kc_b = got[4:]
    assert n_b * kc_b >= T > (n_b - 1) * kc_b and (kc_b == FM.TM or not bf16)


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


def _moe_action_inputs(B=2, P=5, n=4, D=128, NB=3, seed=2):
    """x, position, behavior and MoeAction expert ids of B rows of n item
    blocks; the last block of row 1 is a pad block (position 0, action 0,
    so expert 0)."""
    rng = np.random.default_rng(seed)
    S = P * n
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    pos = np.tile(np.arange(S) % P + 1, (B, 1)).astype(np.int32)
    act = np.repeat(rng.integers(1, NB + 1, (B, n)), P, axis=1).astype(np.int32)
    pos[1, -P:] = act[1, -P:] = 0
    beh = np.where(pos == 1, 0, act).astype(np.int32)  # 0 at the behavior token
    expert = np.maximum(P * (act - 1) + pos, 0).astype(np.int32)
    return x, pos, beh, expert


@pytest.mark.parametrize("injection", [False, True])
@pytest.mark.parametrize("route_mode,jax_impl,use_kernel", PATHS)
def test_moe_action_mlp_matches_jax(route_mode, jax_impl, use_kernel, injection):
    """MoeAction routing (`expert_index`, P * num_behavior + 1 experts): the
    factorized periodic path, fused (the kernel's plain version here) and
    plain, one pass per behavior level, and the one-hot path, against the
    JAX module on the same parameters; fp32, 1e-5, dropout off. The JAX
    module runs its jnp factorized path for both impls (its Pallas kernel
    takes no expert_index). Pad blocks give exactly zero on the periodic
    paths, as in JAX."""
    P, NB, D, F, bdim = 5, 3, 128, 128, 32
    x, pos, beh, expert = _moe_action_inputs(P=P, D=D, NB=NB)
    mod = JaxMLP(d_model=D, d_ff=F, num_experts=P * NB + 1, behavior_injection=injection,
                 num_behavior=NB, behavior_dim=bdim, impl=jax_impl)
    args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(beh))
    kw = dict(route_mode=route_mode, num_positions=P)
    params = mod.init(jax.random.PRNGKey(0), *args, expert_index=jnp.asarray(expert), **kw)
    want = np.asarray(mod.apply(params, *args, expert_index=jnp.asarray(expert), **kw))

    tmod = PositionRoutedMLP(D, F, P * NB + 1, behavior_injection=injection, num_behavior=NB,
                             behavior_dim=bdim, use_kernel=use_kernel)
    tmod.load_state_dict(state_dict_from_jax(params))
    launches = trace.counter("launch.h")
    got = tmod(*(torch.as_tensor(a) for a in (x, pos, beh)),
               expert_index=torch.as_tensor(expert), **kw).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert trace.counter("launch.h") == launches, "a CPU call launches no kernel"
    if route_mode == "periodic":
        assert (got[1, -P:] == 0).all() and (want[1, -P:] == 0).all()
        assert np.abs(got[0]).min() > 0


def test_unported_paths_raise():
    """The paths that raised before the enc-dec models were ported now run:
    `mlp_type="t5"` and `shared_expert` (with behavior injection, relu) on
    the one-hot, periodic and dense paths give the JAX module's output within
    1e-5 on the same weights; only an unknown mlp_type raises. MoeAction
    routing (`expert_index`) runs on every path."""
    with pytest.raises(ValueError):
        PositionRoutedMLP(32, 32, 4, mlp_type="swiglu2")
    P, D, F, NB = 3, 16, 24, 2
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2 * P, D)).astype(np.float32)
    pos = np.tile(np.arange(2 * P) % P + 1, (2, 1)).astype(np.int32)
    beh = rng.integers(0, NB + 1, pos.shape).astype(np.int32)
    for mlp_type, shared, sparse in (("t5", False, True), ("t5", True, True),
                                     ("qwen3", True, True), ("t5", True, False)):
        kw = dict(d_model=D, d_ff=F, num_experts=P + 1, is_sparse=sparse, mlp_type=mlp_type,
                  hidden_act="relu", behavior_injection=True, num_behavior=NB, behavior_dim=8,
                  shared_expert=shared)
        jmod = JaxMLP(**kw)
        args = (jnp.asarray(x), jnp.asarray(pos), jnp.asarray(beh))
        params = jmod.init(jax.random.PRNGKey(1), *args)
        tmod = PositionRoutedMLP(**kw)
        tmod.load_state_dict(state_dict_from_jax(params))
        assert tmod.shared_expert == (shared and sparse) and not tmod.use_kernel
        for route_mode in ("onehot", "periodic"):
            want = jmod.apply(params, *args, route_mode=route_mode, num_positions=P)
            got = tmod(*(torch.as_tensor(a) for a in (x, pos, beh)), route_mode=route_mode,
                       num_positions=P)
            assert got.shape == (2, 2 * P, D)
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    x, pos, beh, expert = (torch.as_tensor(a) for a in _moe_action_inputs(P=P, n=2, D=32, NB=NB))
    for use_kernel in (True, False):
        mlp = PositionRoutedMLP(32, 32, P * NB + 1, num_behavior=NB, use_kernel=use_kernel)
        torch.nn.init.normal_(mlp.experts_gate), torch.nn.init.normal_(mlp.experts_up)
        torch.nn.init.normal_(mlp.experts_down)
        out = mlp(x, pos, expert_index=expert, route_mode="periodic", num_positions=P)
        assert out.shape == x.shape and torch.isfinite(out).all()
        onehot = mlp(x, pos, expert_index=expert, num_positions=P)
        torch.testing.assert_close(out[:, :-P], onehot[:, :-P])  # pad blocks differ by design
        assert (out[1, -P:] == 0).all()


@pytest.mark.parametrize("act", ["gelu", "relu", "gelu_new"])
def test_activations_match_jax_kernel(act):
    """Every activation of kernels h and i besides silu (JAX's gelu is the
    tanh approximation for both names), with bias and dropout 0.2 on one
    seed: the port's fused_moe_ffn on the CPU against the JAX kernel and its
    VJP in interpret mode, forward within 1e-5 relative, the grads of x,
    Wgu, Wd and btab within 1e-4."""
    P, T, D, F, NB = 2, TM, 128, 128, 4
    rng = np.random.default_rng(21)
    arrays = [(rng.standard_normal((P, T, D)) * 0.5).astype(np.float32),
              (rng.standard_normal((P, D, 2 * F)) / np.sqrt(D)).astype(np.float32),
              (rng.standard_normal((P, F, D)) / np.sqrt(F)).astype(np.float32),
              (rng.standard_normal((P, NB, 2 * F)) * 0.3).astype(np.float32)]
    beh = rng.integers(0, NB, (P, T)).astype(np.int32)
    gout = rng.standard_normal((P, T, D)).astype(np.float32)
    f = lambda *w: jax_fused(*w, jnp.asarray(beh.reshape(P, T // TM, TM)), 9, act, 0.2, True,
                             True)
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in arrays))
    want = [np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(gout)))]
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    got = FM.fused_moe_ffn(*leaves, torch.as_tensor(beh), 9, act, rate=0.2, use_bias=True)
    grads = torch.autograd.grad(got, leaves, torch.as_tensor(gout))
    np.testing.assert_allclose(got.detach().numpy(), want[0], rtol=1e-5,
                               atol=1e-5 * np.abs(want[0]).max())
    for name, g, w in zip(("dx", "dwgu", "dwd", "dbtab"), grads, want[1:]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4, err_msg=name)


def test_unknown_activation_raises_value_error():
    args = [torch.zeros(1, 4, 16), torch.zeros(1, 16, 32), torch.zeros(1, 16, 16),
            torch.zeros(1, 1, 32), torch.zeros(1, 4, dtype=torch.int32)]
    with pytest.raises(ValueError, match="swish"):
        FM.fused_moe_ffn(*args, act_name="swish")
    with pytest.raises(ValueError, match="swish"):
        FM.fused_moe_ffn_plain(*args, act_name="swish")


# ---- MoeAction's grouped launch (`fused_moe_ffn_grouped`): the row table and
# the plain version against one pass per behavior level

def _levels(kind: str, T: int, NB: int, rng) -> np.ndarray:
    """[T] block levels 0..NB (0: a pad block): "mixed" (every level and pad
    blocks), "missing" (no level 2), "one" (level NB only, no pad)."""
    if kind == "one":
        return np.full(T, NB, np.int64)
    lv = rng.integers(0, NB + 1, T)
    if kind == "missing":
        lv[lv == 2] = 1
    return lv


@pytest.mark.parametrize("kind", ["mixed", "missing", "one"])
@pytest.mark.parametrize("T,NB", [(1, 3), (63, 3), (200, 3), (6144, 3), (777, 1), (300, 5)])
def test_level_rows_invariants(T, NB, kind):
    """Every row of a level appears exactly once, in its level's run and in
    row order; rows of no level (0, or past NB) are absent; each run starts
    on a 128-row boundary, so no 64-row tile holds two levels; tiles past
    the runs have level -1; the tiles fit the static bound."""
    rng = np.random.default_rng(T + NB)
    lv = _levels(kind, T, NB, rng)
    lv[rng.integers(0, T, max(1, T // 50))] = NB + 1  # ids past the levels: no expert
    g = FM.level_rows(torch.as_tensor(lv), NB)
    rows, tile_level, level_tile = (t.numpy() for t in g)
    assert all(t.dtype == torch.int32 and t.is_contiguous() for t in g)
    assert len(tile_level) == FM.row_tiles(T, NB) and len(rows) == len(tile_level) * FM.TM
    assert len(tile_level) == 2 * (-(-T // FM.GROUP_ROWS) + NB - 1)
    assert level_tile[0] == 0 and (np.diff(level_tile) % 2 == 0).all()
    assert level_tile[-1] <= len(tile_level)
    for a in range(1, NB + 1):
        run = rows[level_tile[a - 1] * FM.TM:level_tile[a] * FM.TM]
        members = np.flatnonzero(lv == a)
        assert len(run) == -(-len(members) // FM.GROUP_ROWS) * FM.GROUP_ROWS
        assert np.array_equal(run, np.concatenate([members, -np.ones(len(run) - len(members))]))
        assert (tile_level[level_tile[a - 1]:level_tile[a]] == a - 1).all()
    assert (tile_level[level_tile[-1]:] == -1).all() and (rows[level_tile[-1] * FM.TM:] == -1).all()
    real = rows[rows >= 0]
    assert len(real) == len(set(real)) == ((lv >= 1) & (lv <= NB)).sum()


def _grouped_inputs(kind: str, T: int, P: int = 5, NB: int = 3, D: int = 32, F: int = 48,
                    seed: int = 0):
    """xp [P, T, D], stacked weights of P * NB + 1 experts (expert 0 the pad
    expert), behavior ids [P, T] and block levels [T] (`_levels`)."""
    rng = np.random.default_rng(seed)
    E, NBH = P * NB + 1, NB + 1
    t = lambda *shape, scale=1.0: torch.as_tensor(
        (rng.standard_normal(shape) * scale).astype(np.float32))
    xp, wgu, wd = t(P, T, D), t(E, D, 2 * F, scale=D ** -0.5), t(E, F, D, scale=F ** -0.5)
    btab = t(E, NBH, 2 * F, scale=0.3)
    beh = torch.as_tensor(rng.integers(0, NBH, (P, T)).astype(np.int32))
    return xp, wgu, wd, btab, beh, torch.as_tensor(_levels(kind, T, NB, rng))


def _per_level(xp, wgu, wd, btab, beh, lv, NB, use_bias, seed, rate):
    """One plain pass over every row per level a with experts P(a-1)+1..Pa,
    each kept where the row's level is a: the ungrouped MoeAction path."""
    P = xp.shape[0]
    out = torch.zeros((), dtype=xp.dtype)
    for a in range(1, NB + 1):
        w = slice(P * (a - 1) + 1, P * a + 1)
        y = FM.fused_moe_ffn_plain(xp, wgu[w], wd[w], btab[w], beh, use_bias, seed, rate)
        out = out + y * (lv == a).to(xp.dtype)[None, :, None]
    return out


@pytest.mark.parametrize("kind", ["mixed", "missing", "one"])
@pytest.mark.parametrize("rate,use_bias", [(0.0, False), (0.2, False), (0.2, True), (0.0, True)])
def test_grouped_plain_matches_per_level_passes(rate, use_bias, kind):
    """The grouped plain version (one gather, pass and scatter a level, the
    row table of `level_rows`) equals the three per-level plain passes with
    the masked sum, bit for bit in fp32: the output (pad blocks exactly
    zero) and dx; the weight grads (sums over other sets of rows) within
    1e-5. T 130: not a multiple of the 64-row tile."""
    NB, seed = 3, 77
    xp, wgu, wd, btab, beh, lv = _grouped_inputs(kind, 130, NB=NB, seed=len(kind))
    groups = FM.level_rows(lv, NB)
    leaves = [t.clone().requires_grad_(True) for t in (xp, wgu, wd, btab)]
    got = FM.fused_moe_ffn_grouped(*leaves, beh, groups, 1, seed, "silu", rate, use_bias)
    ref_leaves = [t.clone().requires_grad_(True) for t in (xp, wgu, wd, btab)]
    want = _per_level(*ref_leaves, beh, lv, NB, use_bias, seed, rate)
    assert torch.equal(got, want)
    assert (got[:, lv == 0] == 0).all() and (got[:, lv > 0].abs() > 0).any()
    gout = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    grads = torch.autograd.grad(got, leaves, gout, allow_unused=True, materialize_grads=True)
    ref = torch.autograd.grad(want, ref_leaves, gout, allow_unused=True, materialize_grads=True)
    assert torch.equal(grads[0], ref[0])
    for name, g, r in zip(("dwgu", "dwd", "dbtab"), grads[1:], ref[1:]):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5, msg=name)
    assert (grads[1][0] == 0).all()  # the pad expert takes no row
    plain = FM.fused_moe_ffn_grouped_bwd_plain(xp, wgu, wd, btab, beh, groups, 1, gout, seed,
                                               rate, use_bias)
    for g, r in zip(plain, grads):
        assert torch.equal(g, r)


@pytest.mark.parametrize("n", [2, 4])
def test_grouped_plain_on_a_ranks_experts(n):
    """The model axis (`modules/moe.py`): rank m holds experts [m E/n,
    (m+1) E/n) of E = 16 and runs the grouped version with first = 1 - m E/n;
    each rank's output equals the per-level passes at the (level, position)
    pairs whose expert it holds and zero elsewhere, and the ranks' outputs
    sum to the whole, bit for bit (dropout 0.2, bias)."""
    P, NB, seed, rate = 5, 3, 11, 0.2
    xp, wgu, wd, btab, beh, lv = _grouped_inputs("mixed", 99, P=P, NB=NB, seed=n)
    E = wgu.shape[0]
    groups = FM.level_rows(lv, NB)
    whole = FM.fused_moe_ffn_grouped(xp, wgu, wd, btab, beh, groups, 1, seed, "silu", rate, True)
    assert torch.equal(whole, _per_level(xp, wgu, wd, btab, beh, lv, NB, True, seed, rate))
    total = 0
    for m in range(n):
        e0, e1 = m * E // n, (m + 1) * E // n
        w = slice(e0, e1)
        part = FM.fused_moe_ffn_grouped(xp, wgu[w], wd[w], btab[w], beh, groups, 1 - e0, seed,
                                        "silu", rate, True)
        held = torch.zeros((P, len(lv)), dtype=torch.bool)
        for a in range(1, NB + 1):
            experts = P * (a - 1) + 1 + torch.arange(P)
            held[:, lv == a] = ((experts >= e0) & (experts < e1))[:, None]
        assert torch.equal(part, torch.where(held[..., None], whole, 0.0))
        total = total + part
    assert torch.equal(total, whole)
