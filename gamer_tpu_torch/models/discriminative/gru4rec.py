"""GRU4Rec: RNN sequential recommendation.

PyTorch counterpart of `gamer_tpu/models/discriminative/gru4rec.py` (ref:
SeqRec/models/discriminative/GRU4Rec/model.py:52-59): embedding dropout,
multi-layer GRU, dense projection back to the embedding size, last-state
scoring.

The cell is flax's `nn.GRUCell`, not `torch.nn.GRU`: its parameters are
`GRUCell_{i}/{ir,iz,in,hr,hz,hn}`, where `hr` and `hz` carry no bias
(`torch.nn.GRU` has trainable b_hr/b_hz, whose grads equal b_ir's/b_iz's, so
one update would move the effective biases twice as far), and
  r = sigmoid(ir(x) + hr(h)), z = sigmoid(iz(x) + hz(h)),
  n = tanh(in(x) + r * hn(h)), h' = (1 - z) * n + z * h.
As in JAX, the GRU runs over the whole right-padded length and the state
at position seq_len - 1 is read.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from gamer_tpu_torch.core.device import resolve_device
from gamer_tpu_torch.models.discriminative.base import DIS_MODELS, DisModelConfig, gather_last
from gamer_tpu_torch.modules.layers import Embedding
from gamer_tpu_torch.modules.transformer import DropoutSeeds, dense


def _xavier_dense(d_in: int, d_out: int, generator: torch.Generator,
                  bias: bool = True) -> nn.Linear:
    """A Dense with a xavier-uniform kernel and a zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    a = math.sqrt(6.0 / (d_in + d_out))
    with torch.no_grad():
        lin.weight.copy_((torch.rand(d_out, d_in, generator=generator) * 2 - 1) * a)
        if bias:
            lin.bias.zero_()
    return lin


class GRUCell(nn.Module):
    """flax's GRUCell (xavier-uniform kernels as GRU4Rec sets them, zero
    biases)."""

    def __init__(self, d_in: int, hidden: int, generator: torch.Generator):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, _xavier_dense(d_in, hidden, generator))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            self.add_module(name, _xavier_dense(hidden, hidden, generator, bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, d_in] -> [B, L, hidden], from a zero state."""
        xr, xz, xn = self.ir(x), self.iz(x), getattr(self, "in")(x)
        h = x.new_zeros(x.shape[0], xr.shape[-1])
        out = []
        for t in range(x.shape[1]):
            r = torch.sigmoid(xr[:, t] + self.hr(h))
            z = torch.sigmoid(xz[:, t] + self.hz(h))
            n = torch.tanh(xn[:, t] + r * self.hn(h))
            h = (1.0 - z) * n + z * h
            out.append(h)
        return torch.stack(out, dim=1)


@DIS_MODELS.register("GRU4Rec")
class GRU4Rec(nn.Module):
    def __init__(self, cfg: DisModelConfig, n_items: int, max_his_len: int = 0,
                 device: str | torch.device | None = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.n_items, self.max_his_len = cfg, n_items, max_his_len
        g = torch.Generator().manual_seed(seed)
        E = cfg.embedding_size
        self.item_embedding = Embedding(n_items + 1, E)
        with torch.no_grad():  # flax xavier_normal: truncated at 2 std
            std = math.sqrt(2.0 / (n_items + 1 + E)) / 0.87962566103423978
            nn.init.trunc_normal_(self.item_embedding.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=g)
        for i in range(cfg.n_layers):
            self.add_module(f"GRUCell_{i}", GRUCell(E if i == 0 else cfg.hidden_size,
                                                    cfg.hidden_size, g))
        self.dense = dense(cfg.hidden_size, E, g)
        self.to(device)

    @property
    def dropout_sites(self) -> int:
        """Dropout seeds a training forward takes: the embedding's."""
        return 1

    def uniform_shapes(self, B: int, L: int) -> list:
        """Masked-LM draws a training forward takes: none."""
        return []

    def encode_with_table(self, item_seq: torch.Tensor, seq_len: torch.Tensor,
                          batch: dict | None = None,
                          generator: Optional[torch.Generator] = None):
        drop = DropoutSeeds(generator, self.cfg.dropout_prob)
        x = drop(self.item_embedding(item_seq.long()))
        for i in range(self.cfg.n_layers):
            x = getattr(self, f"GRUCell_{i}")(x)
        x = self.dense(x)
        return gather_last(x, seq_len), self.item_embedding.weight

    def forward(self, item_seq, seq_len, batch=None, generator=None):
        return self.encode_with_table(item_seq, seq_len, batch, generator)[0]
