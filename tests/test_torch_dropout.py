"""Port parity: the stateless hash dropout (gamer_tpu_torch.modules.dropout
and the keep masks of gamer_tpu_torch.ops) against the JAX package, bit for
bit, and the residual hash dropout's forward and backward."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.modules import dropout as JD
from gamer_tpu.ops import pallas_attention as JA
from gamer_tpu_torch.modules import dropout as TD
from gamer_tpu_torch.ops import fused_attention as FA

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
    np.testing.assert_array_equal(TD._hash_keep_mask(seed, shape, thresh).numpy(), want)
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
