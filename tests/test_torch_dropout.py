"""Port parity: the stateless hash dropout (gamer_tpu_torch.modules.dropout
and the keep masks of gamer_tpu_torch.ops) against the JAX package, bit for
bit, and the residual hash dropout's forward and backward."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.modules import dropout as JD
from gamer_tpu.ops import pallas_attention as JA
from gamer_tpu_torch.core import trace
from gamer_tpu_torch.modules import dropout as TD
from gamer_tpu_torch.ops import fused_attention as FA
from gamer_tpu_torch.ops import hash_dropout as HD

SEEDS = [0, 1, 977, 2 ** 31 - 2]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("bh,r0,c0", [(0, 0, 0), (5, 64, 128), (77, 1000, 3), (383, 4096, 8000)])
def test_dropout_keep_tile_is_bit_exact(seed, bh, r0, c0):
    want = np.asarray(JA.dropout_keep_tile(seed, bh, r0, c0, (24, 40), 0.2))
    got = FA.dropout_keep_tile(seed, bh, r0, c0, (24, 40), 0.2).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rate", [0.1, 0.2, 0.5])
def test_hash_keep_mask_is_bit_exact(seed, rate):
    thresh, keep_p = JD.keep_threshold(rate, bits=32)
    assert TD.keep_threshold(rate) == (thresh, keep_p)
    assert FA.keep_fraction(rate) == JA.keep_fraction(rate) == keep_p
    shape = (3, 17, 29)
    want = np.asarray(JD._hash_keep_mask(jnp.uint32(seed), shape, 3 * 17 * 29, thresh))
    np.testing.assert_array_equal(HD.hash_keep_mask(seed, shape, thresh).numpy(), want)
    assert abs(want.mean() - keep_p) < 0.05


def test_attention_keep_mask_matches_tiles():
    B, H, S = 2, 3, 37
    full = FA.attention_keep_mask(11, B, H, S, S, 0.2).numpy()
    for b in range(B):
        for h in range(H):
            tile = np.asarray(JA.dropout_keep_tile(11, b * H + h, 0, 0, (S, S), 0.2))
            np.testing.assert_array_equal(full[b, h], tile)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_dropout_forward_and_backward_match_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 9, 16)).astype(np.float32)
    g = rng.standard_normal((4, 9, 16)).astype(np.float32)
    thresh, keep_p = JD.keep_threshold(0.2, bits=32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    import jax

    jx = jnp.asarray(x, jdt)
    want, vjp = jax.vjp(lambda a: JD._hash_dropout(a, jnp.uint32(42), thresh, keep_p), jx)
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    tx = torch.as_tensor(x).to(tdt).requires_grad_(True)
    got = TD.hash_dropout(tx, 42, 0.2)
    (got_dx,) = torch.autograd.grad(got, tx, torch.as_tensor(g).to(tdt))
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(got_dx.float().numpy(), np.asarray(want_dx, np.float32))
    assert TD.hash_dropout(tx, 42, 0.0) is tx
    assert (TD.hash_dropout(tx, 42, 1.0) == 0).all()


# ---------------------------------------------------------------------------
# the residual hash dropout of ops/hash_dropout.py: the plain versions of K1
# (with and without its residual) and K2 against JAX's `residual +
# _hash_dropout` and its vjp, bit for bit


def _bits(a) -> np.ndarray:
    """An array's bit patterns (torch or numpy/JAX, fp32 or bf16)."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_residual_dropout(y, r, g, seed, rate):
    """(out, dy, dr) of JAX's `r + _hash_dropout(y)` (dr None without r)."""
    import jax

    thresh, keep_p = JD.keep_threshold(rate, bits=32)
    if r is None:
        out, vjp = jax.vjp(lambda a: JD._hash_dropout(a, jnp.uint32(seed), thresh, keep_p), y)
        return out, vjp(g)[0], None
    out, vjp = jax.vjp(lambda a, b: b + JD._hash_dropout(a, jnp.uint32(seed), thresh, keep_p),
                       y, r)
    dy, dr = vjp(g)
    return out, dy, dr


@pytest.mark.parametrize("rate", [0.2, 0.1])  # 1 / 0.9 rounds in bf16, 1 / 0.8 does not
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [True, False])
def test_residual_hash_dropout_is_bit_exact_with_jax(rate, dtype, residual):
    """K1's (with and without its residual) and K2's plain versions, through
    `hash_dropout_add` / `hash_dropout` and autograd, at a length that is
    not a multiple of 8."""
    rng = np.random.default_rng(1)
    shape = (3, 7, 13)  # 273 elements
    y, r, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(3))
    jy, jr, jg = (jnp.asarray(a, _JDT[dtype]) for a in (y, r, g))
    want, want_dy, want_dr = _jax_residual_dropout(jy, jr if residual else None, jg, 977, rate)
    ty, tr = (torch.as_tensor(a).to(_TDT[dtype]).requires_grad_(True) for a in (y, r))
    got = TD.hash_dropout_add(tr, ty, 977, rate) if residual else TD.hash_dropout(ty, 977, rate)
    leaves = (ty, tr) if residual else (ty,)
    grads = torch.autograd.grad(got, leaves, torch.as_tensor(g).to(_TDT[dtype]))
    assert got.dtype == _TDT[dtype]
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(grads[0]), _bits(want_dy))
    if residual:
        np.testing.assert_array_equal(_bits(grads[1]), _bits(want_dr))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_residual_hash_dropout_rows_from_row0_draw_the_global_mask(dtype):
    """A process's rows from global row `row0`: its K1 output equals those
    rows of JAX's `r + _hash_dropout` on the global batch, bit for bit."""
    rng = np.random.default_rng(2)
    B, row0 = 5, 2
    y, r = (rng.standard_normal((B, 9, 24)).astype(np.float32) for _ in range(2))
    want, _, _ = _jax_residual_dropout(jnp.asarray(y, _JDT[dtype]), jnp.asarray(r, _JDT[dtype]),
                                       jnp.zeros((B, 9, 24), _JDT[dtype]), 31, 0.1)
    ty, tr = (torch.as_tensor(a[row0:]).to(_TDT[dtype]) for a in (y, r))
    got = TD.hash_dropout_add(tr, ty, 31, 0.1, row0)
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)[row0:]))


def test_residual_hash_dropout_cpu_dispatch_counts_no_launch():
    """CPU tensors take the plain versions and no launch is counted; the
    rate 0 and 1 shortcuts stay; non-contiguous inputs are made contiguous
    by `modules/dropout` (the mask is on the logical index)."""
    before = (trace.counter("launch.K1"), trace.counter("launch.K2"))
    y = torch.randn(4, 6, 8, requires_grad=True)
    r = torch.randn(4, 6, 8, requires_grad=True)
    out = TD.hash_dropout_add(r, y, 5, 0.2)
    out.sum().backward()
    assert (trace.counter("launch.K1"), trace.counter("launch.K2")) == before
    thresh, keep_p = TD.keep_threshold(0.2)
    want = r + HD.apply_mask(y, 5, thresh, keep_p)
    np.testing.assert_array_equal(_bits(out), _bits(want))
    np.testing.assert_array_equal(r.grad.numpy(), np.ones((4, 6, 8), np.float32))
    assert torch.equal(TD.hash_dropout_add(r, y, 5, 0.0), r + y)
    assert torch.equal(TD.hash_dropout_add(r, y, 5, 1.0), r + 0.0)
    yt = y.detach().transpose(0, 2)  # non-contiguous
    np.testing.assert_array_equal(_bits(TD.hash_dropout(yt, 5, 0.2)),
                                  _bits(TD.hash_dropout(yt.contiguous(), 5, 0.2)))


def test_residual_hash_dropout_wrapper_checks_its_inputs():
    thresh, keep_p = TD.keep_threshold(0.2)
    y = torch.randn(4, 8)
    with pytest.raises(ValueError, match="contiguous"):
        HD.hash_dropout(y.t(), 1, thresh, keep_p)
    with pytest.raises(ValueError, match="does not match"):
        HD.hash_dropout(y, 1, thresh, keep_p, residual=torch.randn(8))
    with pytest.raises(TypeError, match="float16"):
        HD.hash_dropout(y.half(), 1, thresh, keep_p)
    assert HD.hash_dropout(y.double(), 1, thresh, keep_p).dtype == torch.float64  # a reference
    with pytest.raises(TypeError, match="one dtype"):  # no call site passes a mixed pair
        HD.hash_dropout(y.bfloat16(), 1, thresh, keep_p, residual=y)
    with pytest.raises(ValueError, match="cuda or cpu"):
        HD.hash_dropout(torch.empty(4, 8, device="meta"), 1, thresh, keep_p)
    with pytest.raises(ValueError, match="runs on cuda"):
        HD._launch(y, 1, thresh, keep_p)


# the layer structures of the presets that chip_smoke.py's phases train:
# Qwen3Multi (sparse, cross-attention from layer 1), Qwen3Moe/MoeAction
# (sparse, no cross-attention), Qwen3 (dense MLPs)
_STRUCTURES = {"multi": dict(sparse_layers=[0, 1], cross_attention_layers=[1]),
               "moe": dict(sparse_layers=[0, 1], cross_attention_layers=[]),
               "dense": dict(sparse_layers=[], cross_attention_layers=[1])}


@pytest.mark.parametrize("structure", sorted(_STRUCTURES))
@pytest.mark.parametrize("policy", [None, "full", "attn", "dots"])
def test_chip_smoke_dropout_launches_match_a_counted_step(structure, policy, monkeypatch):
    """chip_smoke.py's expected K1 / K2 launches a training step
    (`_step_launches`, `_remat_launches`) equal the calls a step makes of
    the wrappers that launch them, counted here on the CPU, at each remat
    policy (the recompute runs every dropout site of a layer again but its
    last)."""
    import chip_smoke as cs
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    calls = {"hash_dropout_fwd": 0, "hash_dropout_bwd": 0}
    for name in calls:
        fn = getattr(HD, name)

        def counted(*args, _fn=fn, _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(HD, name, counted)
    cfg = cs.flagship_config(tiny=True, dtype="float32", dropout_rate=cs.DROP_RATE,
                             behavior_injection_layers=[0], remat=policy is not None,
                             remat_policy=policy or "attn", **_STRUCTURES[structure])
    model = QwenFamilyModel(cfg, device="cpu", seed=0)
    loss, _ = make_loss_fn(model, cfg, deterministic=False)(cs.make_batch(cfg, 2, 4),
                                                            torch.Generator().manual_seed(0))
    loss.backward()
    want = cs._remat_launches(cfg, policy)
    assert calls == {k: want[k] for k in calls}
