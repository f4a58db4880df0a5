"""Position-routed mixture-of-experts FFN.

PyTorch counterpart of `gamer_tpu/modules/moe.py`. A token's expert is a pure
function of its position in the item block, so a right-padded batch reshapes
to the expert-major layout [P, b*n, D] and each of the P experts runs one
dense batched product ("periodic" path). Decode uses the general "onehot"
path: every expert runs on every token and a one-hot over the routing picks
the output.

Paths: periodic (plain torch, `use_kernel=False`), fused periodic (the CUDA
kernels of `ops/fused_moe.py`, with behavior injection as a per-behavior bias
table), and onehot. MoeAction (`expert_index` given) routes a token to expert
P*(a-1) + p for its block's action level a (pad/eos blocks, a = 0, output
zero, as in JAX). The fused periodic path runs one grouped launch
(`fused_moe_ffn_grouped`) over the blocks ordered by level, each block
through its own level's P experts, from a row table built on the device
(`moe_action_rows`; the model builds it once a forward and passes it to
every layer as `level_rows`). The plain periodic path runs one pass over
every token per level a, with that level's P experts, and keeps each
block's own level. The onehot path routes by `expert_index`. The enc-dec models' options:
`mlp_type="t5"` is wo(drop(act(wi(x)))) with stacked `experts_wi` [E, d_in,
d_ff] and `experts_wo` [E, d_ff, d_out]; with `shared_expert` a sparse
layer's routed experts emit d_model // 2 and a shared expert (`shared_wi`,
`shared_wo`) the other half, concatenated after them, as in JAX. Neither
takes the fused kernel (JAX's fused path is SwiGLU without a shared expert);
they run on the plain periodic, dense and one-hot paths.

Dropout on the SwiGLU activation (`deterministic=False`): the fused path
passes its seed and rate to the kernel; the plain periodic path draws the
kernel's own hash mask (`ops/fused_moe.moe_keep_mask`), so both paths drop
the same elements for the same seed (every MoeAction pass of the plain path
draws the same mask, and each token keeps one pass; the grouped launch
hashes each row's own coordinates, so it draws that mask too); the dense and one-hot paths use the
residual hash dropout (`modules/dropout.py`), seed + e for expert e and
seed + E for the shared expert. The JAX package draws "bits" dropout from
its rng stream on its plain paths. `row0` (the first global batch row of
this process's rows under a process group) moves each seed so that the
masks are those of the global batch (`modules/dropout.row_seed`).

Expert weights stay stacked with a leading experts axis, in the JAX layout:
gate/up [E, d_in, d_ff], down [E, d_ff, d_out], stored in fp32 and cast to
the input's dtype at use.

Expert parallelism (`model_axis`, set by `core/mesh.MeshContext.shard_params`
when the rules split the experts): rank m keeps experts [m E/n, (m+1) E/n).
Each periodic pass lo..lo+P-1 runs only the positions whose experts the rank
holds (the fused kernels and the plain path alike, on the slices of the
input, weights, bias table and behavior ids), the grouped launch only the
(level, position) pairs whose expert it holds (the others write zero), the
one-hot path only its experts; the rank's output is zero elsewhere, and the ranks' outputs sum
over the model group (`ModelAxis.reduce`). The input and the replicated
behavior table enter through `ModelAxis.copy`, whose backward sums the
ranks' partial grads. A slice that starts at position p0 hashes its local
expert index p - p0, so its dropout seed moves by p0 (`row_seed` with the
hash's expert multiplier) and the masks stay those of one process.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from gamer_tpu_torch.modules.dropout import hash_dropout, row_seed
from gamer_tpu_torch.modules.layers import lookup
from gamer_tpu_torch.ops.fused_attention import _M2, keep_fraction
from gamer_tpu_torch.ops.fused_moe import ACTS as _ACTS
from gamer_tpu_torch.ops.fused_moe import (
    LevelRows, fused_moe_ffn, fused_moe_ffn_grouped, level_rows, moe_keep_mask)


def moe_action_levels(expert_index: torch.Tensor, P: int) -> torch.Tensor:
    """[b, n] the action level of each item block of a [b, n * P] MoeAction
    routing, from its first expert id (0, a pad/eos block: level 0)."""
    b, s = expert_index.shape
    e0 = expert_index.reshape(b, s // P, P)[:, :, 0]
    return torch.where(e0 > 0, torch.div(e0 - 1, P, rounding_mode="floor") + 1, 0)


def moe_action_rows(expert_index: torch.Tensor, P: int, num_behavior: int) -> LevelRows:
    """The grouped launch's row table of a MoeAction routing: its blocks, row
    t = b * n + block, by level (`ops/fused_moe.level_rows`)."""
    return level_rows(moe_action_levels(expert_index, P).reshape(-1), num_behavior)


class PositionRoutedMLP(nn.Module):
    """Sparse (or dense) FFN with deterministic routing. mlp_type "qwen3":
    SwiGLU down(act(gate(x)) * up(x)); "t5": wo(act(wi(x))). The input width
    is d_model + behavior_dim when the behavior embedding is injected."""

    model_axis = None  # distributed.ModelAxis of expert parallelism (module docstring)

    def __init__(self, d_model: int, d_ff: int, num_experts: int, is_sparse: bool = True,
                 mlp_type: str = "qwen3", hidden_act: str = "silu",
                 behavior_injection: bool = False, num_behavior: int = 0,
                 behavior_dim: int = 0, shared_expert: bool = False,
                 use_kernel: bool = True, dropout_rate: float = 0.0):
        super().__init__()
        if mlp_type not in ("qwen3", "t5"):
            raise ValueError(f"unknown mlp_type {mlp_type!r}")
        self.dropout_rate = dropout_rate
        self.d_model, self.d_ff = d_model, d_ff
        self.is_sparse = is_sparse
        self.mlp_type = mlp_type
        self.hidden_act = hidden_act
        self.behavior_injection = behavior_injection
        self.num_behavior = num_behavior
        self.shared_expert = shared_expert and is_sparse
        self.use_kernel = use_kernel and mlp_type == "qwen3" and not self.shared_expert
        d_in = d_model + (behavior_dim if behavior_injection else 0)
        d_out = d_model // 2 if self.shared_expert else d_model
        E = num_experts if is_sparse else 1
        self.num_experts = E
        shapes = {"gate": (d_in, d_ff), "up": (d_in, d_ff), "down": (d_ff, d_out),
                  "wi": (d_in, d_ff), "wo": (d_ff, d_out)}
        for n in self.weight_names:
            self.register_parameter(f"experts_{n}", nn.Parameter(torch.empty(E, *shapes[n])))
        for n in self.weight_names if self.shared_expert else ():
            self.register_parameter(f"shared_{n}", nn.Parameter(torch.empty(*shapes[n])))
        if behavior_injection:
            self.behavior_embedding = nn.Embedding(num_behavior + 1, behavior_dim)

    @property
    def weight_names(self) -> tuple[str, ...]:
        """The stacked expert weights, in the order `_expert` takes them."""
        return (("gate", "up", "down") if self.mlp_type == "qwen3" else ("wi", "wo"))

    def _expert(self, x: torch.Tensor, w: tuple[torch.Tensor, ...], rate: float = 0.0,
                seed: int = 0, row0: int = 0) -> torch.Tensor:
        """x [..., d_in] through one expert's weights `w` (`weight_names`)."""
        act = _ACTS[self.hidden_act]
        if self.mlp_type == "qwen3":
            gate, up, down = w
            gu = x @ torch.cat([gate, up], dim=-1)
            h = act(gu[..., :self.d_ff]) * gu[..., self.d_ff:]
        else:
            h = act(x @ w[0])
        return hash_dropout(h, seed, rate, row0) @ w[-1]

    def _weights(self, dtype: torch.dtype, prefix: str = "experts") -> tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f"{prefix}_{n}").to(dtype) for n in self.weight_names)

    def _expert_range(self) -> tuple[int, int]:
        """[e0, e1): the global experts whose weights this rank holds."""
        local = getattr(self, f"experts_{self.weight_names[0]}").shape[0]
        e0 = self.model_axis.index * local if local < self.num_experts else 0
        return e0, e0 + local

    def _windows(self, P: int, los: list[int]):
        """For each pass lo of `los`: (p0, p1, w0), the positions [p0, p1)
        whose experts lo + p this rank holds, from its local expert w0."""
        e0, e1 = self._expert_range()
        for lo in los:
            p0, p1 = max(0, e0 - lo), min(P, e1 - lo)
            yield p0, max(p0, p1), lo + p0 - e0

    @staticmethod
    def _place(out: torch.Tensor, p0: int, P: int) -> torch.Tensor:
        """A window's [p1 - p0, ...] output in the [P, ...] layout, zero at
        the positions of other ranks."""
        if out.shape[0] == P:
            return out
        return F.pad(out, (0, 0) * (out.dim() - 1) + (p0, P - p0 - out.shape[0]))

    def _fused_operands(self, x: torch.Tensor, behavior_index: Optional[torch.Tensor], P: int,
                        table: Optional[torch.Tensor]):
        """(xp [P, T, d], wgu, down, btab, beh) of the fused kernels, the
        weights this rank's: behavior injection becomes the exactly-equivalent
        per-behavior bias table (concat(x, e_b) @ [Wx; Wb] == x @ Wx + e_b @ Wb)."""
        b, s, d = x.shape
        n = s // P
        T = b * n
        xp = x.reshape(b, n, P, d).permute(2, 0, 1, 3).reshape(P, T, d)
        gate, up, down = self._weights(x.dtype)
        wgu = torch.cat([gate[:, :d], up[:, :d]], dim=-1)
        if self.behavior_injection:
            table = self.behavior_embedding.weight if table is None else table
            wb = torch.cat([gate[:, d:], up[:, d:]], dim=-1)
            btab = torch.einsum("ae,pef->paf", table.to(x.dtype), wb)  # [E, NB+1, 2F]
            beh = behavior_index.reshape(b, n, P).permute(2, 0, 1).reshape(P, T)
            beh = beh.to(torch.int32)
        else:
            btab = torch.zeros((wgu.shape[0], 1, wgu.shape[-1]), dtype=wgu.dtype,
                               device=x.device)
            beh = torch.zeros((P, T), dtype=torch.int32, device=x.device)
        return xp, wgu, down, btab, beh

    @staticmethod
    def _unpermute(out: torch.Tensor, x: torch.Tensor, P: int) -> torch.Tensor:
        """[P, T, d_out] of the fused kernels in x's [b, s] layout and dtype."""
        b, s, _ = x.shape
        return out.reshape(P, b, s // P, -1).permute(1, 2, 0, 3).reshape(b, s, -1).to(x.dtype)

    def _fused_periodic(self, x: torch.Tensor, behavior_index: Optional[torch.Tensor],
                        P: int, rate: float, seed: int,
                        table: Optional[torch.Tensor]) -> torch.Tensor:
        """One periodic pass through the fused FFN kernel with experts 1..P
        (this rank's of them; the others' positions output zero)."""
        xp, wgu, down, btab, beh = self._fused_operands(x, behavior_index, P, table)
        (p0, p1, w0), = self._windows(P, [1])
        if p1 == p0:
            return x.new_zeros((*x.shape[:2], down.shape[-1]))
        w = slice(w0, w0 + p1 - p0)
        out = fused_moe_ffn(xp[p0:p1], wgu[w], down[w], btab[w], beh[p0:p1],
                            row_seed(seed, p0, 1, _M2) if p0 else seed, self.hidden_act, rate,
                            use_bias=self.behavior_injection)
        return self._unpermute(self._place(out, p0, P), x, P)

    def _fused_grouped(self, x: torch.Tensor, behavior_index: Optional[torch.Tensor], P: int,
                       rate: float, seed: int, rows: LevelRows,
                       table: Optional[torch.Tensor]) -> torch.Tensor:
        """MoeAction through one grouped launch of the fused kernels: a block
        of level a takes experts P*(a-1)+1.. (this rank's of them; global
        expert 1 is local expert 1 - e0)."""
        xp, wgu, down, btab, beh = self._fused_operands(x, behavior_index, P, table)
        out = fused_moe_ffn_grouped(xp, wgu, down, btab, beh, rows, 1 - self._expert_range()[0],
                                    seed, self.hidden_act, rate,
                                    use_bias=self.behavior_injection)
        return self._unpermute(out, x, P)

    def _inputs(self, x: torch.Tensor, behavior_index: Optional[torch.Tensor],
                table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The FFN input: x, with the behavior embedding (rows of `table`,
        by default the module's) appended when injected."""
        if not self.behavior_injection:
            return x
        table = self.behavior_embedding.weight if table is None else table
        return torch.cat([x, lookup(behavior_index, table).to(x.dtype)], dim=-1)

    def _periodic(self, x: torch.Tensor, behavior_index: Optional[torch.Tensor], P: int,
                  rate: float, seed: int, los: list[int],
                  table: Optional[torch.Tensor] = None) -> list[torch.Tensor]:
        """Plain periodic passes over every token, one for each lo of `los`:
        token t routes to expert lo + t % P (the positions of this rank's
        experts). Pad/eos rows of a right-padded batch compute with the
        "wrong" expert, but they are masked from every real query's keys and
        from the loss."""
        x_in = self._inputs(x, behavior_index, table)
        w = self._weights(x.dtype)
        w_in = torch.cat(w[:2], dim=-1) if self.mlp_type == "qwen3" else w[0]
        act = _ACTS[self.hidden_act]
        b, s, din = x_in.shape
        xp = x_in.reshape(b, s // P, P, din).permute(2, 0, 1, 3)  # [P, b, n, din]
        outs = []
        for p0, p1, w0 in self._windows(P, los):
            w_sl = slice(w0, w0 + p1 - p0)
            if p1 == p0:
                outs.append(x.new_zeros((b, s, w[-1].shape[-1])))
                continue
            hin = torch.einsum("pbnd,pdf->pbnf", xp[p0:p1], w_in[w_sl])
            if self.mlp_type == "qwen3":
                h = act(hin[..., :self.d_ff]) * hin[..., self.d_ff:]
            else:
                h = act(hin)
            if rate > 0.0:
                keep = moe_keep_mask(row_seed(seed, p0, 1, _M2) if p0 else seed, p1 - p0,
                                     b * (s // P), self.d_ff, rate, x.device)
                h = torch.where(keep.view(h.shape), h * (1.0 / keep_fraction(rate)), 0.0)
            out = torch.einsum("pbnf,pfd->pbnd", h, w[-1][w_sl])
            out = self._place(out, p0, P)
            outs.append(out.permute(1, 2, 0, 3).reshape(b, s, -1).to(x.dtype))
        return outs

    def forward(
        self,
        x: torch.Tensor,  # [B, S, D]
        position_index: torch.Tensor,  # [B, S] expert ids (0 = pad/eos expert)
        behavior_index: Optional[torch.Tensor] = None,  # [B, S]
        expert_index: Optional[torch.Tensor] = None,  # [B, S] MoeAction expert ids
        route_mode: str = "onehot",  # "periodic" | "onehot"
        num_positions: Optional[int] = None,
        deterministic: bool = True,
        dropout_seed: int = 0,
        row0: int = 0,  # first global batch row of x's rows (process groups)
        level_rows: Optional[LevelRows] = None,  # moe_action_rows of expert_index, if built
    ) -> torch.Tensor:
        if self.behavior_injection and behavior_index is None:
            raise ValueError("behavior injection needs behavior_index")
        P = num_positions
        if route_mode == "periodic" and (P is None or x.shape[1] % P):
            raise ValueError("the periodic path needs S % num_positions == 0")

        rate = 0.0 if deterministic else self.dropout_rate
        if not self.is_sparse:
            x_in = self._inputs(x, behavior_index)
            w = tuple(t[0] for t in self._weights(x.dtype))
            return self._expert(x_in, w, rate, dropout_seed, row0).to(x.dtype)
        shared = None
        if self.shared_expert:  # its own mask: seed + E, after the experts' seeds
            shared = self._expert(self._inputs(x, behavior_index), self._weights(x.dtype, "shared"),
                                  rate, dropout_seed + self.num_experts, row0)
        sharded = self._expert_range() != (0, self.num_experts)
        table = self.behavior_embedding.weight if self.behavior_injection else None
        if sharded:  # the replicated inputs enter this rank's experts
            x, *rest = self.model_axis.copy(*((x, table) if table is not None else (x,)))
            table = rest[0] if rest else None
        out = self._routed(x, position_index, behavior_index, expert_index, route_mode, P, rate,
                           dropout_seed, row0, table, level_rows)
        if sharded:  # the ranks' experts' outputs
            out = self.model_axis.reduce(out)
        if shared is not None:
            out = torch.cat([out, shared.to(out.dtype)], dim=-1)
        return out

    def _routed(self, x, position_index, behavior_index, expert_index, route_mode, P, rate,
                dropout_seed, row0=0, table=None, rows=None):
        """This rank's routed experts' output [B, S, d_out] of a sparse layer."""
        if route_mode == "periodic":
            # the periodic hash's row is t = b * n + block: n blocks a batch row
            dropout_seed = row_seed(dropout_seed, row0, x.shape[1] // P) if row0 else dropout_seed
            if expert_index is None:
                if self.use_kernel:
                    return self._fused_periodic(x, behavior_index, P, rate, dropout_seed, table)
                return self._periodic(x, behavior_index, P, rate, dropout_seed, [1], table)[0]
            # MoeAction: the action level a is constant within an item block
            # (from its first expert id; 0 = pad/eos block)
            if self.num_behavior <= 0:
                raise ValueError("MoeAction routing needs num_behavior > 0")
            if self.use_kernel:  # one grouped launch over the blocks ordered by level
                if rows is None:
                    rows = moe_action_rows(expert_index, P, self.num_behavior)
                return self._fused_grouped(x, behavior_index, P, rate, dropout_seed, rows, table)
            # the plain path: each level one pass with its own P experts,
            # gated by the block's level
            a_blk = moe_action_levels(expert_index, P)
            a_tok = a_blk.repeat_interleave(P, dim=1)[..., None]  # [b, s, 1]
            passes = self._periodic(x, behavior_index, P, rate, dropout_seed,
                                    [P * (a - 1) + 1 for a in range(1, self.num_behavior + 1)],
                                    table)
            out = torch.zeros((), dtype=x.dtype, device=x.device)
            for a, level_out in enumerate(passes, start=1):
                out = out + level_out * (a_tok == a).to(x.dtype)
            return out

        if route_mode != "onehot":
            raise ValueError(f"unknown route_mode {route_mode!r}")

        # general path: every expert on every token, selected per token; exact
        # for any routing, used for decode steps and unaligned layouts
        x_in = self._inputs(x, behavior_index, table)
        w = self._weights(x.dtype)
        routing = expert_index if expert_index is not None else position_index
        e0, e1 = self._expert_range()
        # one seed per expert draw: the experts' masks are independent
        stacked = torch.stack([self._expert(x_in, tuple(t[e - e0] for t in w), rate,
                                            dropout_seed + e, row0)
                               for e in range(e0, e1)], dim=0)  # [E, B, S, Dout]
        sel = F.one_hot(routing.long(), self.num_experts)[..., e0:e1].to(stacked.dtype)
        out = torch.einsum("ebsd,bse->bsd", stacked, sel)
        return out.to(x.dtype)
