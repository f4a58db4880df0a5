"""The attention prologue's per-head q/k RMSNorm and RoPE: kernel N1 (forward)
and N2 (backward).

The counterpart of XLA's fusion of `gamer_tpu/modules/layers.py:215-219`
(`q_norm`, `k_norm`, `rope_cos_sin`, `apply_rope` of `GQAAttention`), which
the JAX package leaves to XLA inside the jitted step (no `pallas_call`).
`qk_norm_rope(q, k, wq, wk, positions, theta, eps)` takes the projected,
pre-norm q [B, S, H, D] and k [B, S, Hkv, D] and returns them normed (an RMS
norm a head, with the weights wq and wk) and rotated (NeoX half-rotation at
`positions` [B, S]). For CUDA tensors it launches `csrc/qk_norm_rope.cu`: N1
behind a `torch.autograd.Function` that saves the pre-norm q and k and each
row's fp32 rstd, and whose backward is N2 (the pre-norm grads, and the
weights' grads as a fixed-order sum of per-CTA fp32 partials, so two runs
give the same bits). For CPU tensors it runs `qk_norm_rope_plain`, whose
backward is autograd.

The plain version is the JAX package's chain, and rounds where the kernels
round (the kernel source says how). With `fixed_order=True` it also sums a
row's squares in the kernels' order (`sum_squares`: each element with its
RoPE partner i + D/2, then a halving tree), and N1 then equals it bit for
bit on the card in bf16 and fp32. The CPU route keeps the mean of
`x.float().square()`, as the port's `RMSNorm` does: the CPU training tests
hold several `Trainer` steps to JAX's within 1e-4, and the kernels' order
moves one MoE grad element past that.

Both routes take q and k contiguous, of one dtype and one even head dim,
with the same leading [B, S] as the positions (any integer dtype), and fp32
weights [D]; the kernels take float32 and bfloat16. A row that fits
`MAX_CHUNKS` chunks of a warp's registers takes the register kernels, a
wider one the wide kernels, which hold its pair sums (and in N2 the
weights' grads) in shared memory: any even head dim up to what that memory
holds (`geometry`, about 19,000). Anything else raises, on the CPU too.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.ops import _build

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHUNKS = 4  # register chunks of 32 lanes a row may take (csrc/qk_norm_rope.cu `launch_v`)
BLOCKS_PER_SM = 8  # CTAs an SM at most (the kernels launch fewer where fewer fit)
WIDE_SMEM_BYTES = 227 * 1024  # the shared memory a CTA may take on sm_90 (the wide kernels)


def rope_inv_freq(head_dim: int, theta: float, device) -> torch.Tensor:
    """[head_dim // 2] fp32: 1 / theta^(i / half), built on `device`."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    # theta filled on the device (no copy from the host, which a CUDA graph capture refuses)
    base = torch.full((), theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 1e6) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [B, S] -> (cos, sin) each [B, S, head_dim] fp32 (NeoX
    half-rotation layout)."""
    angles = positions.float()[..., None] * rope_inv_freq(head_dim, theta, positions.device)
    cos = torch.cat([torch.cos(angles), torch.cos(angles)], dim=-1)
    sin = torch.cat([torch.sin(angles), torch.sin(angles)], dim=-1)
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; cos/sin [B, S, D] (angles fp32, applied in x.dtype)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    cos = cos.to(x.dtype)[:, :, None, :]
    sin = sin.to(x.dtype)[:, :, None, :]
    return x * cos + rotated * sin


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The fp32 sum of x's squares over the last dim [..., 1], in the
    kernels' order: x_i^2 + x_{i+D/2}^2 for i < D/2, then a halving tree
    (s[:n] + s[n:]) over those pair sums zero-padded to a power of two."""
    sq = x.float().square()
    half = x.shape[-1] // 2
    s = sq[..., :half] + sq[..., half:]
    n = 1 << (half - 1).bit_length()
    s = F.pad(s, (0, n - half))
    while n > 1:
        n //= 2
        s = s[..., :n] + s[..., n:]
    return s


def norm_rope_plain(x: torch.Tensor, weight: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor, eps: float, fixed_order: bool = False) -> torch.Tensor:
    """One of q, k [B, S, H, D]: the RMS norm (variance in fp32, in the
    kernels' order if `fixed_order`; rsqrt cast to x's dtype, x * rstd, then
    * weight in x's dtype), then RoPE."""
    if fixed_order:
        var = sum_squares(x) * (1.0 / x.shape[-1])
    else:
        var = x.float().square().mean(dim=-1, keepdim=True)
    return apply_rope(x * torch.rsqrt(var + eps).to(x.dtype) * weight.to(x.dtype), cos, sin)


def qk_norm_rope_plain(q, k, wq, wk, positions, theta: float, eps: float,
                       fixed_order: bool = False):
    """Plain version of N1 (and, through autograd, of N2); `fixed_order`:
    the kernels' summation order, the reference N1 is held to bit for bit."""
    cos, sin = rope_cos_sin(positions, q.shape[-1], theta)
    return (norm_rope_plain(q, wq, cos, sin, eps, fixed_order),
            norm_rope_plain(k, wk, cos, sin, eps, fixed_order))


@functools.lru_cache(maxsize=None)
def geometry(head_dim: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """(vec, chunks, lanes) of a row: `vec` elements a lane-chunk (the
    widest power of two of at most 16 bytes that divides head_dim / 2),
    `chunks` chunks a lane, `lanes` lanes a row. Past `MAX_CHUNKS` chunks
    the row takes the wide kernels (one warp a row, walking it), whose
    shared memory holds the padded pair sums and N2's two weight grads;
    raises for a head dim whose row does not fit `WIDE_SMEM_BYTES`."""
    half = head_dim // 2
    vec = 16 // dtype.itemsize
    while half % vec:
        vec //= 2
    padded = 1 << (half - 1).bit_length()  # the pair sums, zero-padded to a power of two
    lanes, chunks = min(32, padded // vec), max(1, padded // vec // 32)
    if chunks > MAX_CHUNKS and 4 * (2 * head_dim + padded) > WIDE_SMEM_BYTES:
        raise ValueError(f"the q/k norm and RoPE kernels take a head dim whose pair sums and "
                         f"weight grads fit {WIDE_SMEM_BYTES} bytes of shared memory, not "
                         f"{head_dim}")
    return vec, chunks, lanes


def _check(q, k, wq, wk, positions) -> None:
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q [B, S, H, D] and k [B, S, Hkv, D], not {tuple(q.shape)} and "
                         f"{tuple(k.shape)}")
    D = q.shape[3]
    if D % 2 or D == 0:
        raise ValueError(f"RoPE takes an even head dim, not {D}")
    if (positions.shape != q.shape[:2] or positions.dtype.is_floating_point
            or positions.is_complex()):
        raise ValueError(f"positions: an integer [B, S] = {tuple(q.shape[:2])}, not "
                         f"{positions.dtype} {tuple(positions.shape)}")
    if q.dtype != k.dtype or (q.device.type == "cuda" and q.dtype not in KERNEL_DTYPES):
        raise TypeError(f"the q/k norm and RoPE kernels take q and k in one of {KERNEL_DTYPES}, "
                        f"not {q.dtype} and {k.dtype}")
    if wq.shape != (D,) or wk.shape != (D,) or wq.dtype != torch.float32 or wk.dtype != wq.dtype:
        raise ValueError(f"the norm weights are fp32 [{D}], not {wq.dtype} {tuple(wq.shape)} and "
                         f"{wk.dtype} {tuple(wk.shape)}")
    if not q.is_contiguous() or not k.is_contiguous():
        raise ValueError("the q/k norm and RoPE kernels take contiguous q and k")
    if len({t.device for t in (q, k, wq, wk, positions)}) != 1:
        raise ValueError("q, k, the weights and the positions must be on one device")
    if q.device.type == "cuda":
        geometry(D, q.dtype)
        if q.shape[0] * q.shape[1] >= 2 ** 32:
            raise ValueError("the q/k norm and RoPE kernels take fewer than 2^32 tokens")


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_uint] + [ctypes.c_int] * 7 + [
    ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]


def _launch(q, k, gq, gk, out_q, out_k, wq, wk, rq, rk, pos, inv_freq, ws, dwq, dwk,
            blocks: int, eps: float) -> None:
    B, S, H, D = q.shape
    vec, chunks, lanes = geometry(D, q.dtype)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        _build.launch("qk_norm_rope", _ARGTYPES, *map(ptr, (
            q, k, gq, gk, out_q, out_k, wq, wk, rq, rk, pos, inv_freq, ws, dwq, dwk)),
            B * S, H, k.shape[2], D, vec, chunks, lanes, blocks, 1.0 / D, eps,
            _build.dtype_code(q), _build.stream_of(q))


def _blocks(tokens: int, D: int, dtype, device) -> int:
    """The most CTAs a launch may take (N2's partials buffer has a row each):
    CTAs of 8 warps, a warp 32 / lanes tokens at a time, or in the wide
    kernels CTAs of one warp, a token at a time."""
    _, chunks, lanes = geometry(D, dtype)
    if chunks > MAX_CHUNKS:
        need = tokens
    else:
        need = -(-tokens // (32 // lanes) // 8)
    return max(1, min(need, _sms(device.index or 0) * BLOCKS_PER_SM))


def qk_norm_rope_fwd(q, k, wq, wk, pos, inv_freq, eps: float, with_rstd: bool):
    """N1: (rotated q, rotated k, rstd of q [B, S, H], of k [B, S, Hkv]), the
    rstds None unless `with_rstd`; `pos` int32 contiguous [B, S], `inv_freq`
    `rope_inv_freq`'s table. CUDA tensors only, checked (and q and k
    `_build.aligned`) by the caller."""
    out_q, out_k = torch.empty_like(q), torch.empty_like(k)
    B, S, H, D = q.shape
    rq = rk = None
    if with_rstd:
        rq = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
        rk = torch.empty((B, S, k.shape[2]), dtype=torch.float32, device=q.device)
    if B * S:
        _launch(q, k, None, None, out_q, out_k, wq, wk, rq, rk, pos, inv_freq, None, None, None,
                _blocks(B * S, D, q.dtype, q.device), eps)
        trace.count("launch.N1")
    return out_q, out_k, rq, rk


def qk_norm_rope_bwd(gq, gk, q, k, wq, wk, rq, rk, pos, inv_freq, eps: float):
    """N2: (grad of the pre-norm q, of k, of wq, of wk) from the grads of
    the rotated q and k and N1's saved inputs and rstds."""
    gq, gk = _build.aligned(gq), _build.aligned(gk)
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    B, S, H, D = q.shape
    # written whole by the kernel, unless there is no token
    dwq, dwk = ((torch.empty if B * S else torch.zeros)(D, dtype=torch.float32, device=q.device)
                for _ in range(2))
    if B * S:
        blocks = _blocks(B * S, D, q.dtype, q.device)
        ws = torch.empty((blocks, 2, D), dtype=torch.float32, device=q.device)
        _launch(q, k, gq, gk, dq, dk, wq, wk, rq, rk, pos, inv_freq, ws, dwq, dwk, blocks, eps)
        trace.count("launch.N2")
    return dq, dk, dwq, dwk


class _QKNormRope(torch.autograd.Function):
    """N1 forward, N2 backward; saves the pre-norm q and k, the weights,
    the positions, the frequency table and the rstds."""

    @staticmethod
    def forward(ctx, q, k, wq, wk, pos, inv_freq, eps):
        out_q, out_k, rq, rk = qk_norm_rope_fwd(q, k, wq, wk, pos, inv_freq, eps, True)
        ctx.save_for_backward(q, k, wq, wk, pos, inv_freq, rq, rk)
        ctx.eps = eps
        return out_q, out_k

    @staticmethod
    def backward(ctx, gq, gk):
        q, k, wq, wk, pos, inv_freq, rq, rk = ctx.saved_tensors
        dq, dk, dwq, dwk = qk_norm_rope_bwd(gq.contiguous(), gk.contiguous(), q, k, wq, wk, rq,
                                            rk, pos, inv_freq, ctx.eps)
        return dq, dk, dwq, dwk, None, None, None


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                 positions: torch.Tensor, theta: float, eps: float):
    """(q, k) normed by the weights wq, wk and rotated at `positions`:
    N1/N2 on the card, `qk_norm_rope_plain` on the CPU; differentiable in
    q, k and the weights."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"qk_norm_rope runs on cuda or cpu, not {q.device}")
    _check(q, k, wq, wk, positions)
    if q.device.type == "cpu":
        return qk_norm_rope_plain(q, k, wq, wk, positions, theta, eps)
    q, k = _build.aligned(q), _build.aligned(k)
    pos = positions.to(torch.int32).contiguous()
    inv_freq = rope_inv_freq(q.shape[3], theta, q.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, wq, wk)):
        return _QKNormRope.apply(q, k, wq, wk, pos, inv_freq, eps)
    return qk_norm_rope_fwd(q, k, wq, wk, pos, inv_freq, eps, with_rstd=False)[:2]
