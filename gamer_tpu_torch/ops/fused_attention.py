"""Fused masked GQA attention: kernel a (forward) and kernel b (backward).

`fused_mask_attention` is the counterpart of `gamer_tpu/ops/pallas_attention.py`
`fused_mask_attention`: q [B, S, H*D], k/v [B, S, Hkv*D] in the
projection-native layout, the mask evaluated from the integer streams, rows
with no allowed key giving 0 (and 0 grads), optional attention-prob dropout
keyed on `dropout_seed` by the stateless hash `dropout_keep_tile` (an int or a
seed in device memory, `ops/seeds.DeviceSeed`, which the kernels read on the
card). For CUDA tensors it launches `csrc/fused_attention_fwd.cu` (saving the per-row
logsumexp when a gradient is needed) behind a `torch.autograd.Function` whose
backward launches `csrc/fused_attention_bwd.cu` (`fused_mask_attention_bwd`);
both kernels serve every S. The C entry points pick the kernel by dtype
before any launch: bf16 runs on the tensor cores, fp32 on the CUDA cores
(full fp32). For CPU tensors it runs
`fused_mask_attention_plain`, the same function in plain PyTorch (masks from
`ops/masks.py`, the same hash mask, then `modules/layers.attend`), whose
backward is autograd.

Widths: every head dim runs through the kernels. The one rule, in
`_padded_head_dim`: up to 256 the kernels are compiled for head dims
`HEAD_DIMS`; over 256 they take the wide route, in which each CTA owns 64
output columns and walks the full head dim in 64-deep slices
(`WIDE_STEP`). The wrapper zero-pads q, k and v per head to the next
compiled dim, or over 256 to the next multiple of 64, and slices the output
and grads back. The scale stays the true D^-0.5, so the zero columns add 0
to every score; at the flagship head dim (64) nothing is padded or copied.

The hash helpers here are bit-exact with the JAX package's: on the CPU and in
plain PyTorch the uint32 arithmetic runs in int64 and wraps with
`& 0xFFFFFFFF`.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.ops import _build, seeds
from gamer_tpu_torch.ops.masks import streams_allowed

KINDS = {"causal": 0, "session": 1, "multi": 2, "session_multi": 3}
HEAD_DIMS = (32, 64, 128, 256)  # head dims the kernels are compiled for
WIDE_STEP = 64  # over 256, the wide route takes head dims in multiples of this

_M1, _M2, _M3 = 0x85EBCA6B, 0xC2B2AE35, 0x9E3779B1
_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """The single-mul mixer `_fmix32` of the JAX kernels, on int64 holding uint32."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    return x ^ (x >> 15)


def drop_threshold(rate: float) -> int:
    """uint32 drop threshold: an element is kept when its hash is >= it."""
    return min(int(round(rate * 4294967296.0)), 4294967295)


def keep_fraction(rate: float) -> float:
    """Exact keep probability after uint32 threshold quantization."""
    return (4294967296 - drop_threshold(rate)) / 4294967296.0


def hash_bits(seed, bh, rows, cols) -> torch.Tensor:
    """The uint32 hash (in int64) of (seed, bh, row, col), broadcasting int
    tensors (`rows` a tensor); `seed` an int or an `ops/seeds.DeviceSeed`."""
    x = (_mul32(rows, _M3) + _mul32(cols, _M1) + _mul32(bh, _M2)
         + seeds.hash_term(seed, rows.device)) & _U32
    return fmix32(x)


def hash_keep(seed, bh, rows, cols, rate: float) -> torch.Tensor:
    """Keep mask of the hash of (seed, bh, row, col), broadcasting int tensors;
    `seed` an int or an `ops/seeds.DeviceSeed`."""
    return hash_bits(seed, bh, rows, cols) >= drop_threshold(rate)


def dropout_keep_tile(seed: int, bh: int, r0: int, c0: int, shape, rate: float,
                      device=None) -> torch.Tensor:
    """Boolean keep-mask tile for query rows [r0, r0+shape[0]) x key columns
    [c0, c0+shape[1]) of attention matrix (batch*num_heads + head) == bh; a
    pure function of absolute coordinates, so any tiling draws the same mask."""
    rows = torch.arange(r0, r0 + shape[0], dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(c0, c0 + shape[1], dtype=torch.int64, device=device)[None, :]
    return hash_keep(seed, torch.tensor(bh, dtype=torch.int64, device=device), rows, cols, rate)


def attention_keep_mask(seed: int, B: int, H: int, Sq: int, Sk: int, rate: float,
                        device=None) -> torch.Tensor:
    """[B, H, Sq, Sk] keep mask of every (batch, head) attention matrix."""
    bh = torch.arange(B * H, dtype=torch.int64, device=device).view(B, H, 1, 1)
    rows = torch.arange(Sq, dtype=torch.int64, device=device).view(1, 1, Sq, 1)
    cols = torch.arange(Sk, dtype=torch.int64, device=device).view(1, 1, 1, Sk)
    return hash_keep(seed, bh, rows, cols, rate)


def fused_mask_attention_plain(q, k, v, attention_mask, session_ids, actions, block_ids,
                               dropout_seed: int = 0, num_heads: int = 1,
                               kind: str = "causal",
                               dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernels: materialize `allowed` and the
    hash keep mask, then attend (fp32 math); differentiable by autograd."""
    from gamer_tpu_torch.modules.layers import attend

    B, S, HD = q.shape
    D = HD // num_heads
    Hkv = k.shape[2] // D
    allowed = streams_allowed(kind, attention_mask, session_ids, actions, block_ids)
    keep = None
    if dropout_rate > 0.0:
        keep = attention_keep_mask(dropout_seed, B, num_heads, S, S, dropout_rate, q.device)
    out = attend(q.reshape(B, S, num_heads, D), k.reshape(B, S, Hkv, D),
                 v.reshape(B, S, Hkv, D), allowed, D ** -0.5, keep=keep,
                 keep_prob=keep_fraction(dropout_rate))
    return out.reshape(B, S, HD)


def _check(q, k, v, streams, num_heads, kind):
    if kind not in KINDS:
        raise ValueError(f"unknown attention mask kind {kind!r}")
    B, S, HD = q.shape
    D = HD // num_heads
    if HD % num_heads:
        raise ValueError(f"q's width {HD} is not a multiple of num_heads {num_heads}")
    Hkv = k.shape[2] // D
    if k.shape != (B, S, Hkv * D) or v.shape != k.shape or num_heads % Hkv:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)} {tuple(v.shape)} for q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    streams = [t.to(device=q.device, dtype=torch.int32).contiguous() for t in streams]
    if any(t.shape != (B, S) for t in streams):
        raise ValueError("mask streams must be [B, S]")
    return B, S, D, Hkv, streams


def _padded_head_dim(D: int) -> int:
    """The head dim a head of width D runs at: the next compiled one up to
    256, over 256 (the wide route) the next multiple of `WIDE_STEP`."""
    if D > HEAD_DIMS[-1]:
        return -(-D // WIDE_STEP) * WIDE_STEP
    return next(d for d in HEAD_DIMS if d >= D)


def _pad_heads(t: torch.Tensor, D: int, Dp: int) -> torch.Tensor:
    """[B, S, heads * D] -> [B, S, heads * Dp], each head zero-padded."""
    B, S, HD = t.shape
    return F.pad(t.reshape(B, S, HD // D, D), (0, Dp - D)).reshape(B, S, HD // D * Dp)


def _unpad_heads(t: torch.Tensor, D: int, Dp: int) -> torch.Tensor:
    B, S, HDp = t.shape
    return t.reshape(B, S, HDp // Dp, Dp)[..., :D].reshape(B, S, HDp // Dp * D)


def _dropout_args(seed, rate: float, device) -> tuple[int | None, int, int, float]:
    """(seed pointer, seed add, threshold, 1 / keep fraction) of the C entry
    points; the seed an int or a `DeviceSeed` (`ops/seeds.kernel_args`)."""
    if rate <= 0.0:
        return None, 0, 0, 1.0
    return (*seeds.kernel_args(seed, device), drop_threshold(rate), 1.0 / keep_fraction(rate))


# the dropout arguments: seed pointer, seed add, threshold, 1 / keep fraction
_DROPOUT_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
_FWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float] + \
    _DROPOUT_ARGTYPES + [ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_float] + \
    _DROPOUT_ARGTYPES + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def dkv_splits(B: int, S: int, Hkv: int, G: int, kind: str, sms: int) -> int:
    """Shares into which the bf16 dK/dV kernel splits each CTA's (query
    head, query tile) pairs: enough that the longest CTA (key tile 0) holds
    no more than an even share of the work over `sms` SMs at three CTAs each,
    at most 8: on 132 SMs 1 at the flagship B 64 x S 505, 8 at B 1 x S 2048."""
    nk = -(-S // 64)
    longest = G * nk
    causal = kind in ("causal", "multi")
    total = G * B * Hkv * (nk * (nk + 1) // 2 if causal else nk * nk)
    return max(1, min(8, longest, math.ceil(3 * sms * longest / total)))


def _launch_fwd(q, k, v, streams, seed, num_heads, kind, rate, with_lse: bool):
    B, S, D, Hkv, streams = _check(q, k, v, streams, num_heads, kind)
    Dp = _padded_head_dim(D)
    if Dp != D:
        q, k, v = (_pad_heads(t, D, Dp) for t in (q, k, v))
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, S), dtype=torch.float32, device=q.device) if with_lse else None
    with torch.cuda.device(q.device):
        _build.launch("fused_attention_fwd", _FWD_ARGTYPES, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), *(t.data_ptr() for t in streams), out.data_ptr(),
                      lse.data_ptr() if with_lse else None, B, S, num_heads, Hkv, Dp,
                      KINDS[kind], D ** -0.5, *_dropout_args(seed, rate, q.device),
                      _build.dtype_code(q), _build.stream_of(q))
    trace.count("launch.a")
    return (out if Dp == D else _unpad_heads(out, D, Dp)), lse


def fused_mask_attention_bwd(q, k, v, out, dout, lse, attention_mask, session_ids, actions,
                             block_ids, dropout_seed: int = 0, num_heads: int = 1,
                             kind: str = "causal", dropout_rate: float = 0.0):
    """Kernel b: (dq, dk, dv) of `fused_mask_attention` from its output `out`
    and saved logsumexp `lse` [B, H, S] (CUDA tensors only)."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_mask_attention_bwd launches a CUDA kernel; got {q.device}")
    streams = (attention_mask, session_ids, actions, block_ids)
    B, S, D, Hkv, streams = _check(q, k, v, streams, num_heads, kind)
    if dout.shape != q.shape or out.shape != q.shape or lse.shape != (B, num_heads, S):
        raise ValueError("dout/out must be shaped like q and lse [B, H, S]")
    out, dout = out.to(q.dtype), dout.to(q.dtype)
    D_real, D = D, _padded_head_dim(D)
    if D != D_real:  # out's padded columns are 0, as the kernel's own output would be
        q, k, v, out, dout = (_pad_heads(t, D_real, D) for t in (q, k, v, out, dout))
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out, dout = _build.aligned(out), _build.aligned(dout)
    lse = lse.float().contiguous()
    # rowsum(dO * O) per (head, row), filled by the library's delta kernel
    delta = torch.empty((B, num_heads, S), dtype=torch.float32, device=q.device)
    nsplit = 1
    if q.dtype == torch.bfloat16 and D <= HEAD_DIMS[-1]:  # the wide route does not split
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        nsplit = dkv_splits(B, S, Hkv, num_heads // Hkv, kind, sms)
    ws = (torch.empty(2 * nsplit * k.numel(), dtype=torch.float32, device=q.device)
          if nsplit > 1 else None)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    with torch.cuda.device(q.device):
        _build.launch("fused_attention_bwd", _BWD_ARGTYPES, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                      delta.data_ptr(), *(t.data_ptr() for t in streams), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), ws.data_ptr() if ws is not None else None,
                      B, S, num_heads, Hkv, D, KINDS[kind], D_real ** -0.5,
                      *_dropout_args(dropout_seed, dropout_rate, q.device), nsplit,
                      _build.dtype_code(q), _build.stream_of(q))
    trace.count("launch.b")
    if D != D_real:
        dq, dk, dv = (_unpad_heads(t, D_real, D) for t in (dq, dk, dv))
    return dq, dk, dv


def fused_mask_attention_bwd_plain(q, k, v, dout, attention_mask, session_ids, actions,
                                   block_ids, dropout_seed: int = 0, num_heads: int = 1,
                                   kind: str = "causal", dropout_rate: float = 0.0):
    """Plain version of kernel b: autograd through the plain forward."""
    with torch.enable_grad():
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        out = fused_mask_attention_plain(q, k, v, attention_mask, session_ids, actions,
                                         block_ids, dropout_seed, num_heads, kind, dropout_rate)
        return torch.autograd.grad(out, (q, k, v), dout)


class _FusedAttention(torch.autograd.Function):
    """Kernel a forward (with lse), kernel b backward."""

    @staticmethod
    def forward(ctx, q, k, v, attn, sid, act, blk, seed, num_heads, kind, rate):
        out, lse = _launch_fwd(q, k, v, (attn, sid, act, blk), seed, num_heads, kind, rate,
                               with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, attn, sid, act, blk)
        ctx.args = (seed, num_heads, kind, rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, attn, sid, act, blk = ctx.saved_tensors
        dq, dk, dv = fused_mask_attention_bwd(q, k, v, out, dout, lse, attn, sid, act, blk,
                                              *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def fused_mask_attention(q, k, v, attention_mask, session_ids, actions, block_ids,
                         dropout_seed: int = 0, num_heads: int = 1, kind: str = "causal",
                         dropout_rate: float = 0.0) -> torch.Tensor:
    """q [B, S, H*D], k/v [B, S, Hkv*D], streams [B, S] -> out [B, S, H*D].

    `dropout_rate` > 0 drops attention probabilities by the hash keyed on
    `dropout_seed` (the backward regenerates the same mask). Differentiable
    in q, k and v."""
    if kind not in KINDS:
        raise ValueError(f"unknown attention mask kind {kind!r}")
    if q.device.type == "cpu":
        return fused_mask_attention_plain(q, k, v, attention_mask, session_ids, actions,
                                          block_ids, dropout_seed, num_heads, kind, dropout_rate)
    if q.device.type != "cuda":
        raise ValueError(f"fused_mask_attention runs on cuda or cpu, not {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedAttention.apply(q, k, v, attention_mask, session_ids, actions, block_ids,
                                     dropout_seed, num_heads, kind, dropout_rate)
    return _launch_fwd(q, k, v, (attention_mask, session_ids, actions, block_ids), dropout_seed,
                       num_heads, kind, dropout_rate, with_lse=False)[0]
