"""Port parity: fused mask attention (gamer_tpu_torch.ops.fused_attention) on
the CPU, i.e. the kernel's plain version, against the JAX Pallas kernel in
interpret mode. fp32, tolerance 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.ops.pallas_attention import fused_mask_attention as jax_fused
from gamer_tpu_torch.core import trace
from gamer_tpu_torch.ops import _build
from gamer_tpu_torch.ops import fused_attention as FA

B, S, H, Hkv, D = 3, 40, 4, 2, 32


def _inputs(seed=0):
    """Row 0 full, row 1 left-padded, row 2 right-padded; random actions so
    that the cross kinds have rows with no allowed key."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H * D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv * D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv * D)).astype(np.float32)
    attn = np.ones((B, S), np.int32)
    attn[1, :6] = 0
    attn[2, S - 9:] = 0
    sessions = np.sort(rng.integers(0, 4, (B, S)), axis=1).astype(np.int32)
    actions = rng.integers(1, 4, (B, S)).astype(np.int32)
    rel = np.cumsum(attn, 1) - 1
    blocks = np.where(attn == 1, rel // 5, -1).astype(np.int32)
    return q, k, v, attn, sessions, actions, blocks


@pytest.mark.parametrize("kind", ["causal", "session", "multi", "session_multi"])
def test_plain_version_matches_jax_kernel(kind):
    arrays = _inputs()
    want = jax_fused(*(jnp.asarray(a) for a in arrays), 0, H, kind, True)
    launches = trace.counter("launch.a")
    got = FA.fused_mask_attention(*(torch.as_tensor(a) for a in arrays), 0, H, kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert trace.counter("launch.a") == launches, "a CPU call launches no kernel"
    if kind in ("multi", "session_multi"):
        empty = np.abs(np.asarray(want)).max(-1) == 0
        assert empty.any() and (got.numpy()[empty] == 0).all()


def test_wrapper_rejects_what_the_kernel_does_not_take():
    t = [torch.as_tensor(a) for a in _inputs()]
    # dropout is taken: finite, seeded, and different from rate 0
    a = FA.fused_mask_attention(*t, 3, H, "causal", dropout_rate=0.1)
    assert torch.isfinite(a).all()
    assert torch.equal(a, FA.fused_mask_attention(*t, 3, H, "causal", dropout_rate=0.1))
    assert not torch.equal(a, FA.fused_mask_attention(*t, 0, H, "causal"))
    with pytest.raises(ValueError):
        FA.fused_mask_attention(*t, 0, H, "action_same")


@pytest.mark.parametrize("B,S,kind,want", [(64, 505, "causal", 1), (1, 2048, "causal", 8),
                                           (1, 8192, "causal", 3), (1, 2048, "session", 5),
                                           (1, 5, "multi", 2)])
def test_dkv_splits_fill_the_card(B, S, kind, want):
    """The bf16 dK/dV kernel splits its pairs only where the grid would not
    fill 132 SMs, at most 8 ways and never into more shares than pairs."""
    assert FA.dkv_splits(B, S, 3, 2, kind, 132) == want


def test_aligned_copies_only_misaligned_views():
    t = torch.zeros(64, dtype=torch.bfloat16)
    assert _build.aligned(t).data_ptr() == t.data_ptr()
    view = t[1:33]  # 2 bytes past an aligned address
    moved = _build.aligned(view)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, view)


@pytest.mark.parametrize("D,want", [(32, 32), (48, 64), (200, 256), (256, 256), (264, 320),
                                    (320, 320), (512, 512)])
def test_head_dim_route(D, want, monkeypatch):
    """The head dim the kernels run at: the compiled 32/64/128/256 up to
    256, above it the wide route at the next multiple of 64. The forward
    wrapper (its launch recorded, not run) zero-pads each head to that dim,
    passes it with the true D^-0.5 scale, and slices the output back."""
    import contextlib

    assert FA._padded_head_dim(D) == want
    calls = []
    monkeypatch.setattr(FA._build, "launch", lambda name, argtypes, *args: calls.append(args))
    monkeypatch.setattr(FA._build, "stream_of", lambda t: 0)
    monkeypatch.setattr(FA.torch.cuda, "device", lambda dev: contextlib.nullcontext())
    Bq, Sq, Hq, Hk = 2, 9, 4, 2
    q, k, v = (torch.ones(Bq, Sq, h * D) for h in (Hq, Hk, Hk))
    streams = [torch.ones(Bq, Sq, dtype=torch.int32) for _ in range(4)]
    out, lse = FA._launch_fwd(q, k, v, streams, 0, Hq, "causal", 0.0, with_lse=True)
    (args,) = calls
    assert args[9:15] == (Bq, Sq, Hq, Hk, want, FA.KINDS["causal"])
    assert args[15] == pytest.approx(D ** -0.5)
    assert out.shape == q.shape and lse.shape == (Bq, Hq, Sq)
