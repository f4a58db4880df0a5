"""Fused position-routed SwiGLU MoE-FFN: kernel h (forward) and kernel i (backward).

`fused_moe_ffn` is the counterpart of `gamer_tpu/ops/pallas_moe.py`
`fused_moe_ffn`, on the expert-major layout: xp [P, T, D], wgu [P, D, 2F]
(gate | up), wdown [P, F, Dout], btab [P, NB, 2F] per-behavior bias rows,
beh [P, T] int32 bias ids, `seed` and `rate` of the hash dropout on h, keyed
on (seed, expert p, row t, column f); the seed an int or a seed in device
memory (`ops/seeds.DeviceSeed`), which the kernels read on the card. For CUDA tensors it launches
`csrc/fused_moe_fwd.cu` behind a `torch.autograd.Function` whose backward
launches `csrc/fused_moe_bwd.cu` (`fused_moe_ffn_bwd`): dx plus dWgu, dWd and
dbtab summed in fp32 and cast to the weights' dtype, as the TPU kernel does.
The activation is silu, relu, or the tanh approximation of gelu for both
"gelu" and "gelu_new" (`ACTS`, jax.nn.gelu's default, as the TPU kernel
computes it); another name raises ValueError. The C entry points pick the
kernels by dtype before any launch: bf16 runs on the tensor cores (h rounded
to bf16 before the down product, dgu and h_drop before the products that read
them, dbtab summed from the fp32 dgu, as the TPU kernel does), fp32 on the
CUDA cores (full fp32). For CPU tensors it runs `fused_moe_ffn_plain`, whose
backward is autograd.

`fused_moe_ffn_grouped` is MoeAction's launch (`modules/moe.py`): a row of
level l (1..levels) at position p takes expert `first + (l - 1) * P + p` of
the stacked weights [E, ...], so one launch of h and one of i serve every
level. The rows are ordered by level on the device (`level_rows`): each
level's run padded to GROUP_ROWS with -1, a table of each TM-row tile's
level, and a static grid of `row_tiles(T, levels)` tiles a position, the
tiles past the runs exiting at once. A CTA takes its tile's expert (zero
where the weights hold none: another rank's), reads its rows through the
table and writes each row's output, dx, dgu and h_drop at the row's own
place; rows of no level get zero. The dropout hash keys on the row's own t,
so the masks are those of the ungrouped launch. i sums dWgu, dWd and dbtab
of an expert over its level's rows only: the products split each level's
run into a static number of row ranges, one CTA a range, and
`reduce_splits_kernel` adds the ranges; bf16's per-tile dbtab sums are
added over the level's tiles by `moe_bwd_dbtab_sum_kernel`. A template
flag of each kernel selects the grouped code, so the ungrouped kernels
compile as before. For CPU tensors it runs `fused_moe_ffn_grouped_plain`
(a gather, the plain version per level, a scatter).

Widths: every D, F and Dout runs through the kernels. The one rule, in
`_padded`: in bf16 the wrapper zero-pads D, F and Dout to multiples of 16 and
slices the outputs and grads back, which is exact (padded x columns meet zero
weight rows, padded F columns give g = u = 0 and act(0) * 0 = 0, and the
dropout hash keys on the real columns, which do not move); at the flagship
widths nothing is padded or copied. Wide D (over 256 in bf16, over 512 in
fp32) takes the kernels' streamed routes. Unlike the TPU kernel, T needs no
padding to a tile multiple.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.ops import _build
from gamer_tpu_torch.ops.fused_attention import (
    _DROPOUT_ARGTYPES, _dropout_args, hash_keep, keep_fraction)

TM = 64  # row tile of the kernels; the bf16 backward sums dbtab per row tile
# a level's run of rows in the grouped table: two of h's row tiles, one
# 128-row tile of i's dx product, so that no tile of either holds two levels
GROUP_ROWS = 2 * TM

ACTS = {"silu": F.silu, "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_new": lambda x: F.gelu(x, approximate="tanh")}
ACT_CODES = {"silu": 0, "relu": 1, "gelu": 2, "gelu_new": 2}  # moe_tc.cuh gamer::moe::Act


def act_code(act_name: str) -> int:
    if act_name not in ACT_CODES:
        raise ValueError(f"the fused MoE FFN computes {sorted(ACT_CODES)}, not {act_name!r}")
    return ACT_CODES[act_name]


def moe_keep_mask(seed: int, P: int, T: int, F: int, rate: float, device=None) -> torch.Tensor:
    """[P, T, F] keep mask of h: the hash of (seed, expert, row, column)."""
    p = torch.arange(P, dtype=torch.int64, device=device).view(P, 1, 1)
    t = torch.arange(T, dtype=torch.int64, device=device).view(1, T, 1)
    f = torch.arange(F, dtype=torch.int64, device=device).view(1, 1, F)
    return hash_keep(seed, p, t, f, rate)


class LevelRows(NamedTuple):
    """The grouped launch's row table (`level_rows`), int32 on the rows'
    device: `rows` [R], the row t at each place of the level-sorted order
    (-1: a pad place); `tile_level` [R / TM], each TM-row tile's level
    (0-based; -1 past the last run); `level_tile` [levels + 1], the first
    tile of each level's run and, last, the tiles in use."""

    rows: torch.Tensor
    tile_level: torch.Tensor
    level_tile: torch.Tensor


def row_tiles(T: int, levels: int) -> int:
    """The static TM-row tiles of the table of T rows in `levels` levels:
    runs padded to GROUP_ROWS fill at most ceil(T / GROUP_ROWS) + levels - 1
    of them (ceil(a) + ceil(b) <= ceil(a + b) + 1)."""
    return (-(-T // GROUP_ROWS) + levels - 1) * (GROUP_ROWS // TM)


def level_rows(level: torch.Tensor, levels: int) -> LevelRows:
    """The row table of `level` [T] (each row's level in 1..levels; any other
    value is a row of no level), rows in their order within a level, built
    by static-shape ops on level's device: nothing is read on the host, so a
    captured step builds it anew at each replay."""
    T, dev = level.numel(), level.device
    R = row_tiles(T, levels) * TM
    onehot = (level.reshape(1, T).long() == torch.arange(1, levels + 1, device=dev)[:, None])
    onehot = onehot.long()  # [levels, T]
    # rows of each level up to t: one flat scan in level-major order (a
    # scan along T per level runs serially on the card), less the levels
    # before it
    seen = torch.cumsum(onehot.reshape(-1), 0).reshape(levels, T)
    before = torch.cat([seen.new_zeros(1), seen[:-1, -1]])
    rank = seen - before[:, None]
    runs = torch.div(rank[:, -1] + GROUP_ROWS - 1, GROUP_ROWS, rounding_mode="floor") * GROUP_ROWS
    ends = torch.cumsum(runs, 0)
    t = torch.arange(T, device=dev)
    dest = ((rank - 1 + (ends - runs)[:, None]) * onehot).sum(0)
    dest = torch.where(onehot.sum(0) > 0, dest, R + t)  # a row of no level: a slot past R
    rows = torch.full((R + T,), -1, dtype=torch.int32, device=dev)
    rows = rows.scatter(0, dest, t.to(torch.int32))[:R]
    tile_level = (torch.arange(0, R, TM, device=dev)[:, None] >= ends).sum(1)
    tile_level = torch.where(tile_level < levels, tile_level, -1).to(torch.int32)
    level_tile = torch.div(torch.cat([ends.new_zeros(1), ends]), TM, rounding_mode="floor")
    return LevelRows(rows, tile_level, level_tile.to(torch.int32))


def fused_moe_ffn_plain(xp, wgu, wdown, btab, beh, use_bias: bool = False, seed: int = 0,
                        rate: float = 0.0, act_name: str = "silu",
                        keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: fp32 products, bias rows selected by id (ids
    outside [0, NB) add nothing), the same hash dropout (or the keep mask
    `keep` [P, T, F], the grouped version's rows of it), output in xp's
    dtype; differentiable by autograd."""
    act_code(act_name)
    act = ACTS[act_name]
    Fd = wdown.shape[1]
    gu = torch.bmm(xp.float(), wgu.float())  # [P, T, 2F]
    if use_bias:
        onehot = (beh.long()[..., None] == torch.arange(btab.shape[1], device=beh.device))
        gu = gu + torch.bmm(onehot.float(), btab.float())
    h = act(gu[..., :Fd]) * gu[..., Fd:]
    if rate > 0.0:
        if keep is None:
            keep = moe_keep_mask(seed, xp.shape[0], xp.shape[1], Fd, rate, xp.device)
        h = torch.where(keep, h * (1.0 / keep_fraction(rate)), 0.0)
    return torch.bmm(h, wdown.float()).to(xp.dtype)


def fused_moe_ffn_grouped_plain(xp, wgu, wdown, btab, beh, groups: LevelRows, first: int,
                                use_bias: bool = False, seed: int = 0, rate: float = 0.0,
                                act_name: str = "silu") -> torch.Tensor:
    """Plain version of the grouped launch: per level, the table's rows
    gathered (a pad place reads row 0), `fused_moe_ffn_plain` with the
    level's experts at the positions whose expert the weights hold, and the
    outputs of the level's own places added at their rows; zero elsewhere.
    Static shapes, as on the card: nothing is read on the host."""
    act_code(act_name)
    P, T, _ = xp.shape
    E, Fd = wgu.shape[0], wdown.shape[1]
    keep = moe_keep_mask(seed, P, T, Fd, rate, xp.device) if rate > 0.0 else None
    rows = groups.rows.long().clamp(min=0)
    place_level = torch.where(groups.rows >= 0, groups.tile_level.repeat_interleave(TM), -1)
    out = xp.new_zeros((P, T, wdown.shape[2]))
    for lvl in range(groups.level_tile.shape[0] - 1):
        e0 = first + lvl * P  # the expert of position 0
        p0, p1 = max(0, -e0), min(P, E - e0)
        if p1 <= p0:
            continue
        w = slice(e0 + p0, e0 + p1)
        y = fused_moe_ffn_plain(xp[p0:p1, rows], wgu[w], wdown[w], btab[w], beh[p0:p1, rows],
                                use_bias, rate=rate, act_name=act_name,
                                keep=None if keep is None else keep[p0:p1, rows])
        mine = (place_level == lvl).to(y.dtype)[None, :, None]  # each row once, at its place
        out = out.index_put((torch.arange(p0, p1, device=xp.device)[:, None], rows[None]),
                            y * mine, accumulate=True)
    return out


def _check(xp, wgu, wdown, btab, beh, grouped: bool = False):
    """The shapes; the weights hold P experts, or any number when grouped."""
    P, T, D = xp.shape
    Fd, Dout = wdown.shape[1], wdown.shape[2]
    NB = btab.shape[1]
    E = wgu.shape[0] if grouped else P
    if (wgu.shape != (E, D, 2 * Fd) or wdown.shape[0] != E or btab.shape != (E, NB, 2 * Fd)
            or beh.shape != (P, T)):
        raise ValueError(f"bad MoE shapes xp {tuple(xp.shape)} wgu {tuple(wgu.shape)} "
                         f"wdown {tuple(wdown.shape)} btab {tuple(btab.shape)} beh {tuple(beh.shape)}")
    if any(t.dtype != xp.dtype for t in (wgu, wdown, btab)):
        raise TypeError("xp, wgu, wdown and btab must share one dtype")
    return (P, T, D, Fd, Dout, NB, *(_build.aligned(t) for t in (xp, wgu, wdown, btab)),
            beh.to(dtype=torch.int32).contiguous())


def _padded(xp, wdown) -> tuple[int, int, int]:
    """(D, F, Dout) as the kernels take them: multiples of 16 in bf16 (the
    module docstring's one width rule), unchanged in fp32."""
    D, Fd, Dout = xp.shape[2], wdown.shape[1], wdown.shape[2]
    if xp.dtype != torch.bfloat16:
        return D, Fd, Dout
    return tuple(-(-n // 16) * 16 for n in (D, Fd, Dout))


def _pad_gu(t: torch.Tensor, rows: int, Fp: int) -> torch.Tensor:
    """[P, R, 2F] (gate | up) zero-padded to [P, rows, 2 Fp], each half apart."""
    P, R, F2 = t.shape
    t = t.reshape(P, R, 2, F2 // 2)
    return F.pad(t, (0, Fp - F2 // 2, 0, 0, 0, rows - R)).reshape(P, rows, 2 * Fp)


def _unpad_gu(t: torch.Tensor, rows: int, Fd: int) -> torch.Tensor:
    P, R, F2 = t.shape
    return t.reshape(P, R, 2, F2 // 2)[:, :rows, :, :Fd].reshape(P, rows, 2 * Fd)


def weight_grad_splits(T: int, P: int, D: int, F: int, Dout: int, sms: int,
                       bf16: bool) -> tuple[int, int, int, int, int, int]:
    """(n_gu, kc_gu, n_d, kc_d, n_b, kc_b): the splits over T, and the rows a
    split covers, of kernel i's dWgu, dWd and dbtab sums on `sms` SMs
    (`_build.split_rows`: output tiles times splits fit two waves of two CTAs
    an SM, whole 32-row k slices). The products' output tiles are 128 x 128
    in bf16 (tensor cores) and 64 x 64 in fp32; bf16 sums dbtab per 64-row
    tile in pass 1, fp32 in a kernel of 256 columns a CTA. On 132 SMs at the
    flagship (P 5, T 6464, D = Dout 256, F 512) in bf16: dWgu 80 tiles in 6
    splits of 1088 rows (480 CTAs), dWd 40 tiles in 13 splits of 512 (520),
    dbtab in the 101 row tiles."""
    tile = 128 if bf16 else 64
    tiles = lambda m, n: P * math.ceil(m / tile) * math.ceil(n / tile)
    n_gu, kc_gu = _build.split_rows(T, tiles(D, 2 * F), sms, 32)
    n_d, kc_d = _build.split_rows(T, tiles(F, Dout), sms, 32)
    if bf16:
        n_b, kc_b = math.ceil(T / TM), TM
    else:
        n_b, kc_b = _build.split_rows(T, P * math.ceil(2 * F / 256), sms, 1)
    return n_gu, kc_gu, n_d, kc_d, n_b, kc_b


# the row table's arguments, before the stream: rows, tile_level,
# level_tile, then tiles, levels, first, experts (`_groups_args`)
_GROUPS_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
_FWD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + _DROPOUT_ARGTYPES + [
    ctypes.c_int] + _GROUPS_ARGTYPES + [ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + _DROPOUT_ARGTYPES + [
    ctypes.c_int] * 7 + _GROUPS_ARGTYPES + [ctypes.c_void_p]


def _groups_args(groups: Optional[LevelRows], first: int, E: int) -> tuple:
    """The entry points' table arguments: null pointers (the ungrouped
    launch) without `groups`."""
    if groups is None:
        return None, None, None, 0, 0, 0, 0
    if any(t.dtype != torch.int32 or not t.is_contiguous() for t in groups):
        raise TypeError("the row table's tensors are contiguous int32 (`level_rows`)")
    rows, tile_level, level_tile = groups
    return (rows.data_ptr(), tile_level.data_ptr(), level_tile.data_ptr(), tile_level.numel(),
            level_tile.numel() - 1, first, E)


def _launch_fwd(xp, wgu, wdown, btab, beh, seed, rate, use_bias, act_name="silu",
                groups: Optional[LevelRows] = None, first: int = 0):
    act = act_code(act_name)
    P, T, D, Fd, Dout, NB, xp, wgu, wdown, btab, beh = _check(xp, wgu, wdown, btab, beh,
                                                              groups is not None)
    Dp, Fp, Doutp = _padded(xp, wdown)
    if (Dp, Fp, Doutp) != (D, Fd, Dout):
        xp = F.pad(xp, (0, Dp - D))
        wgu, btab = _pad_gu(wgu, Dp, Fp), _pad_gu(btab, NB, Fp)
        wdown = F.pad(wdown, (0, Doutp - Dout, 0, Fp - Fd))
    # grouped: the rows of no level, and the positions of experts held
    # elsewhere, are never written
    out = (torch.empty if groups is None else torch.zeros)((P, T, Doutp), dtype=xp.dtype,
                                                          device=xp.device)
    with torch.cuda.device(xp.device):
        _build.launch("fused_moe_fwd", _FWD_ARGTYPES, xp.data_ptr(), wgu.data_ptr(),
                      wdown.data_ptr(), btab.data_ptr(), beh.data_ptr(), out.data_ptr(),
                      P, T, Dp, Fp, Doutp, NB, int(use_bias), act,
                      *_dropout_args(seed, rate, xp.device), _build.dtype_code(xp),
                      *_groups_args(groups, first, wgu.shape[0]), _build.stream_of(xp))
    trace.count("launch.h")
    if groups is not None:
        trace.count("moe.grouped")
        trace.count("moe.grouped_tiles", groups.tile_level.numel())
    return out if Doutp == Dout else out[..., :Dout]


def fused_moe_ffn_bwd(xp, wgu, wdown, btab, beh, gout, seed: int = 0, rate: float = 0.0,
                      use_bias: bool = False, act_name: str = "silu",
                      groups: Optional[LevelRows] = None, first: int = 0):
    """Kernel i: (dx, dwgu, dwdown, dbtab) of `fused_moe_ffn` (of
    `fused_moe_ffn_grouped` when `groups`) for the incoming gradient gout
    [P, T, Dout] (CUDA tensors only). The weight gradients are summed in
    fp32 and come out in the weights' dtype."""
    if xp.device.type != "cuda":
        raise ValueError(f"fused_moe_ffn_bwd launches a CUDA kernel; got {xp.device}")
    act = act_code(act_name)
    P, T, D, Fd, Dout, NB, xp, wgu, wdown, btab, beh = _check(xp, wgu, wdown, btab, beh,
                                                              groups is not None)
    if gout.shape != (P, T, Dout):
        raise ValueError(f"gout must be [P, T, Dout], got {tuple(gout.shape)}")
    gout = gout.to(xp.dtype)
    real = (D, Fd, Dout)
    D, Fd, Dout = _padded(xp, wdown)
    if (D, Fd, Dout) != real:
        xp = F.pad(xp, (0, D - real[0]))
        wgu, btab = _pad_gu(wgu, D, Fd), _pad_gu(btab, NB, Fd)
        wdown = F.pad(wdown, (0, Dout - real[2], 0, Fd - real[1]))
        gout = F.pad(gout, (0, Dout - real[2]))
    gout = _build.aligned(gout)
    sms = torch.cuda.get_device_properties(xp.device).multi_processor_count
    bf16 = xp.dtype == torch.bfloat16
    E = wgu.shape[0]
    if groups is None:
        n_gu, kc_gu, n_d, kc_d, n_b, kc_b = weight_grad_splits(T, P, D, Fd, Dout, sms, bf16)
        ws_size = max(n_gu * P * D * 2 * Fd, n_d * P * Fd * Dout, n_b * P * NB * 2 * Fd)
    else:
        # the ranges of a level's run, set for a run of the mean length (the
        # kernels size each level's ranges to its own run); bf16 sums dbtab
        # per row tile of the table
        tiles, levels = groups.tile_level.numel(), groups.level_tile.numel() - 1
        n_gu, kc_gu, n_d, kc_d, n_b, kc_b = weight_grad_splits(
            -(-tiles * TM // levels), E, D, Fd, Dout, sms, bf16)
        n_b = tiles if bf16 else n_b
        ws_size = max(n_gu * E * D * 2 * Fd, n_d * E * Fd * Dout,
                      n_b * (P if bf16 else E) * NB * 2 * Fd)
    ws = torch.empty(ws_size, dtype=torch.float32, device=xp.device)
    dgu = torch.empty((P, T, 2 * Fd), dtype=xp.dtype, device=xp.device)
    hdrop = torch.empty((P, T, Fd), dtype=xp.dtype, device=xp.device)
    dx = torch.empty_like(xp) if groups is None else torch.zeros_like(xp)
    dwgu, dwd = torch.empty_like(wgu), torch.empty_like(wdown)
    dbtab = torch.empty_like(btab) if use_bias else torch.zeros_like(btab)
    with torch.cuda.device(xp.device):
        _build.launch("fused_moe_bwd", _BWD_ARGTYPES, xp.data_ptr(), wgu.data_ptr(),
                      wdown.data_ptr(), btab.data_ptr(), beh.data_ptr(), gout.data_ptr(),
                      dx.data_ptr(), dwgu.data_ptr(), dwd.data_ptr(), dbtab.data_ptr(),
                      dgu.data_ptr(), hdrop.data_ptr(), ws.data_ptr(), P, T, D, Fd, Dout, NB,
                      int(use_bias), act, *_dropout_args(seed, rate, xp.device), n_gu, kc_gu,
                      n_d, kc_d, n_b, kc_b, _build.dtype_code(xp),
                      *_groups_args(groups, first, E), _build.stream_of(xp))
    trace.count("launch.i")
    if (D, Fd, Dout) != real:
        dx, dwd = dx[..., :real[0]], dwd[:, :real[1], :real[2]]
        dwgu, dbtab = _unpad_gu(dwgu, real[0], real[1]), _unpad_gu(dbtab, NB, real[1])
    return dx, dwgu, dwd, dbtab


def fused_moe_ffn_bwd_plain(xp, wgu, wdown, btab, beh, gout, seed: int = 0, rate: float = 0.0,
                            use_bias: bool = False, act_name: str = "silu"):
    """Plain version of kernel i: autograd through the plain forward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (xp, wgu, wdown, btab)]
        out = fused_moe_ffn_plain(*leaves, beh, use_bias, seed, rate, act_name)
        return torch.autograd.grad(out, leaves, gout, allow_unused=True, materialize_grads=True)


def fused_moe_ffn_grouped_bwd_plain(xp, wgu, wdown, btab, beh, groups: LevelRows, first: int,
                                    gout, seed: int = 0, rate: float = 0.0,
                                    use_bias: bool = False, act_name: str = "silu"):
    """Plain version of the grouped i: autograd through the grouped plain
    forward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (xp, wgu, wdown, btab)]
        out = fused_moe_ffn_grouped_plain(*leaves, beh, groups, first, use_bias, seed, rate,
                                          act_name)
        return torch.autograd.grad(out, leaves, gout, allow_unused=True, materialize_grads=True)


class _FusedMoE(torch.autograd.Function):
    """Kernel h forward, kernel i backward (grouped when `groups`)."""

    @staticmethod
    def forward(ctx, xp, wgu, wdown, btab, beh, seed, rate, use_bias, act_name, groups, first):
        ctx.save_for_backward(xp, wgu, wdown, btab, beh, *(groups or ()))
        ctx.args = (seed, rate, use_bias, act_name)
        ctx.first = first
        return _launch_fwd(xp, wgu, wdown, btab, beh, seed, rate, use_bias, act_name, groups,
                           first)

    @staticmethod
    def backward(ctx, gout):
        xp, wgu, wdown, btab, beh, *tabs = ctx.saved_tensors
        groups = LevelRows(*tabs) if tabs else None
        grads = fused_moe_ffn_bwd(xp, wgu, wdown, btab, beh, gout, *ctx.args, groups, ctx.first)
        return (*grads, None, None, None, None, None, None, None)


def _fused(xp, wgu, wdown, btab, beh, seed, act_name, rate, use_bias, groups, first):
    """The kernels (h forward, i backward) on the card, the plain versions
    on the CPU; grouped when `groups`."""
    act_code(act_name)
    if xp.device.type == "cpu":
        if groups is None:
            return fused_moe_ffn_plain(xp, wgu, wdown, btab, beh, use_bias, seed, rate, act_name)
        return fused_moe_ffn_grouped_plain(xp, wgu, wdown, btab, beh, groups, first, use_bias,
                                           seed, rate, act_name)
    if xp.device.type != "cuda":
        raise ValueError(f"the fused MoE FFN runs on cuda or cpu, not {xp.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xp, wgu, wdown, btab)):
        return _FusedMoE.apply(xp, wgu, wdown, btab, beh, seed, rate, use_bias, act_name, groups,
                               first)
    return _launch_fwd(xp, wgu, wdown, btab, beh, seed, rate, use_bias, act_name, groups, first)


def fused_moe_ffn(xp, wgu, wdown, btab, beh, seed: int = 0, act_name: str = "silu",
                  rate: float = 0.0, use_bias: bool = False) -> torch.Tensor:
    """xp [P, T, D], wgu [P, D, 2F], wdown [P, F, Dout], btab [P, NB, 2F],
    beh [P, T] int -> [P, T, Dout]; differentiable in xp, wgu, wdown, btab."""
    return _fused(xp, wgu, wdown, btab, beh, seed, act_name, rate, use_bias, None, 0)


def fused_moe_ffn_grouped(xp, wgu, wdown, btab, beh, groups: LevelRows, first: int,
                          seed: int = 0, act_name: str = "silu", rate: float = 0.0,
                          use_bias: bool = False) -> torch.Tensor:
    """xp [P, T, D], wgu [E, D, 2F], wdown [E, F, Dout], btab [E, NB, 2F],
    beh [P, T] int and the row table `groups` of T rows -> [P, T, Dout]: a
    row of level l (0-based in the table) at position p through expert
    first + l * P + p, zero where that is outside [0, E) and at rows of no
    level (module docstring); differentiable in xp, wgu, wdown, btab."""
    return _fused(xp, wgu, wdown, btab, beh, seed, act_name, rate, use_bias, groups, first)
