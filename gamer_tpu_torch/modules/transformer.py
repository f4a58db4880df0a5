"""BERT-style post-LN transformer encoder of the discriminative models.

PyTorch counterpart of `gamer_tpu/modules/transformer.py` (ref:
SeqRec/modules/layers/transformer.py: TransformerEncoderLayer/TransformerEncoder
- post-norm residual blocks, additive float mask). Module names follow the
flax tree (`layer_{i}`, `attn`, `q`/`k`/`v`/`o`, `ln1`, `ff1`, `ff2`, `ln2`),
so `convert.py` carries weights both ways; Dense layers are `nn.Linear`s with
flax's lecun-normal init (`dense`).

Dropout (training) is the stateless hash of `modules/dropout.py` at every
site where flax's `nn.Dropout` draws from its rng stream: the attention
probabilities, the attention and FFN residual branches and the FFN
activation, one int32 seed a site in call order (`DropoutSeeds`, passed to
each module as `drop`): drawn from a CPU generator, or read from the step's
seed table in device memory. The additive mask is `ops/masks.NEG_INF`, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gamer_tpu_torch.modules.dropout import hash_dropout, hash_dropout_add
from gamer_tpu_torch.modules.layers import Embedding
from gamer_tpu_torch.ops.masks import NEG_INF
from gamer_tpu_torch.ops.seeds import DeviceSeed


def _act(name: str) -> Callable:
    # flax's nn.gelu is the tanh approximation
    return {"gelu": lambda x: F.gelu(x, approximate="tanh"), "relu": F.relu,
            "silu": F.silu, "swish": F.silu, "tanh": torch.tanh}[name]


class DropoutSeeds:
    """One int32 seed a dropout site, in call order, from `source`: a CPU
    `torch.Generator` (each drawn into Python as the site runs) or the step's
    seed table, an int32 tensor on the model's device whose entry i is site
    i's seed (`ops/seeds.DeviceSeed`, read on the device: the form a captured
    step needs). A table drawn by `ops/seeds.draw` from a generator gives the
    seeds that generator gives here, bit for bit. `None` in place of a source
    means no dropout (`deterministic=True`). Each model states its site count
    (`dropout_sites`); `taken` counts the seeds handed out."""

    def __init__(self, source, rate: float):
        self.source, self.rate = source, rate
        self.taken = 0

    def _seed(self):
        i, self.taken = self.taken, self.taken + 1
        if isinstance(self.source, torch.Tensor):
            return DeviceSeed(self.source, i)
        return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self.source))

    def __call__(self, x: torch.Tensor, rate: Optional[float] = None) -> torch.Tensor:
        """Hash dropout of `x` at `rate` (default: the model's) under the
        next seed; `x` itself when deterministic."""
        if self.source is None:
            return x
        return hash_dropout(x, self._seed(), self.rate if rate is None else rate)

    def add(self, r: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """`r + self(y)` in one pass (a residual site; one K1 launch on the
        card); `r + y` when deterministic."""
        if self.source is None:
            return r + y
        return hash_dropout_add(r, y, self._seed(), self.rate)


DETERMINISTIC = DropoutSeeds(None, 0.0)


def dense(d_in: int, d_out: int, generator: torch.Generator, bias: bool = True) -> nn.Linear:
    """`nn.Linear` initialised as flax's `nn.Dense`: a lecun-normal kernel
    (a normal truncated at 2 std, variance 1 / d_in) and a zero bias."""
    lin = nn.Linear(d_in, d_out, bias=bias)
    std = math.sqrt(1.0 / d_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


def embedding(vocab: int, dim: int, generator: torch.Generator,
              std: Optional[float] = None) -> nn.Embedding:
    """`nn.Embedding` initialised as flax's `nn.Embed`: normal with `std`,
    by default 1/sqrt(dim) (flax's variance scaling over the features)."""
    emb = Embedding(vocab, dim)
    with torch.no_grad():
        emb.weight.copy_(torch.randn(vocab, dim, generator=generator)
                         * (dim ** -0.5 if std is None else std))
    return emb


def normal_param(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    """A raw parameter drawn as flax's `normal(std)` initializer draws it."""
    return nn.Parameter(torch.randn(*shape, generator=generator) * std)


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int, generator: torch.Generator):
        super().__init__()
        self.n_heads = n_heads
        for name in ("q", "k", "v", "o"):
            self.add_module(name, dense(d_model, d_model, generator))

    def forward(self, x: torch.Tensor, allowed: torch.Tensor,
                drop: DropoutSeeds = DETERMINISTIC,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [b, s, d_model]; `allowed` broadcasts to [b, H, s, s_kv]; `kv`
        the cross inputs (default x)."""
        H = self.n_heads
        b, s, d_model = x.shape
        dk = d_model // H
        src = x if kv is None else kv
        q = self.q(x).reshape(b, s, H, dk)
        k = self.k(src).reshape(b, src.shape[1], H, dk)
        v = self.v(src).reshape(b, src.shape[1], H, dk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dk)
        scores = scores + torch.where(allowed, 0.0, NEG_INF)
        probs = drop(torch.softmax(scores, dim=-1))
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, s, d_model)
        return self.o(out)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int, activation: str,
                 layer_norm_eps: float, generator: torch.Generator):
        super().__init__()
        self.act = _act(activation)
        self.attn = MultiHeadAttention(d_model, n_heads, generator)
        self.ln1 = nn.LayerNorm(d_model, eps=layer_norm_eps)
        self.ff1 = dense(d_model, d_ff, generator)
        self.ff2 = dense(d_ff, d_model, generator)
        self.ln2 = nn.LayerNorm(d_model, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor, allowed: torch.Tensor,
                drop: DropoutSeeds = DETERMINISTIC) -> torch.Tensor:
        a = self.attn(x, allowed, drop)
        x = self.ln1(drop.add(x, a))
        f = drop(self.act(self.ff1(x)))
        return self.ln2(drop.add(x, self.ff2(f)))


class TransformerEncoder(nn.Module):
    def __init__(self, n_layers: int, d_model: int, n_heads: int, d_ff: int,
                 activation: str, layer_norm_eps: float, generator: torch.Generator):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layer_{i}", TransformerEncoderLayer(
                d_model, n_heads, d_ff, activation, layer_norm_eps, generator))

    def forward(self, x: torch.Tensor, allowed: torch.Tensor,
                drop: DropoutSeeds = DETERMINISTIC) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, allowed, drop)
        return x


def attention_allowed(item_seq: torch.Tensor, bidirectional: bool = False) -> torch.Tensor:
    """[B, L] padded item ids (0 = pad) -> [B, 1, L, L] boolean allowed mask
    (ref seq_model.py:50-62)."""
    B, L = item_seq.shape
    key_ok = (item_seq != 0)[:, None, None, :].expand(B, 1, L, L)
    if bidirectional:
        return key_ok
    i = torch.arange(L, device=item_seq.device)
    return key_ok & (i[:, None] >= i[None, :])[None, None]
