"""RQ-VAE item tokenizer: residual vector quantization with Sinkhorn
balancing, CF-alignment loss and codebook-diversity loss.

The port's counterpart of `gamer_tpu/models/tokenizer/rqvae.py` (ref:
SeqRec/models/tokenizer/RQVAE/{model.py, vector_quantizer.py,
resiual_vector_quantizer.py}), plain PyTorch as the JAX package's is plain
`jnp` (no kernel). Kept from JAX:

 * MLP encoder [in_dim, *layers, e_dim] / mirrored decoder, ReLU between all
   but the last layer (ref layers.py:7-38); modules named as flax names them
   (`Dense_<i>`, `BatchNorm_<i>`), so `convert.py` maps the trees by name;
 * one stacked codebook parameter [L, max_n, e_dim]; non-uniform level sizes
   are row slices, rows >= num_emb_list[level] never read;
 * per level: L2-distance assignment, Sinkhorn-balanced when sk_epsilon > 0
   (ref vector_quantizer.py:146-163), optional softmax sampling of the last
   level (ref :148-153); the straight-through estimator per level (ref :181);
 * losses: recon + quant_weight * mean_level(codebook + mu * commitment +
   beta * diversity) + alpha * CF InfoNCE (ref model.py:105-150).

Differences, as ROADMAP §3.3 records: BatchNorm follows flax (`BatchNorm`
below: the biased batch variance, E[x^2] - E[x]^2, in both the
normalization and the running variance, momentum 0.9 kept of the old
value), where `torch.nn.BatchNorm1d` keeps the unbiased variance; the
diversity loss's positives come from Gumbel noise that the caller may hand
over (`diversity_noise`), else drawn from a CPU `torch.Generator`, since torch
cannot reproduce `jax.random.gumbel`; `dropout_prob` drops by the stateless
hash (`modules/dropout.py`, one seed a layer), not flax's rng stream.

A training forward draws its dropout seeds, then each level's Gumbel noise,
from its CPU generator; `training_draws` makes the same draws on the host,
for a step whose device part reads them from static buffers (the seed table
as `ops/seeds.DeviceSeed`s, the noise as `diversity_noise`).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from gamer_tpu_torch.core.config import Config, config_field
from gamer_tpu_torch.core.device import resolve_device
from gamer_tpu_torch.modules.dropout import hash_dropout
from gamer_tpu_torch.ops.seeds import draw, site_seeds
from gamer_tpu_torch.ops.sinkhorn import balanced_assign


class RQVAEConfig(Config):
    in_dim: int = 768
    num_emb_list: list = config_field([256, 256, 256, 256])
    e_dim: int = 32
    layers: list = config_field([2048, 1024, 512, 256, 128, 64])
    dropout_prob: float = 0.0
    bn: bool = False  # BatchNorm after each Dense (ref layers.py:19-22)
    loss_type: str = "mse"  # mse | l1
    quant_loss_weight: float = 1.0
    mu: float = 0.25
    sk_epsilons: list = config_field([0.0, 0.0, 0.0, 0.003])
    sk_iters: int = 50
    kmeans_iters: int = 100  # Lloyd iterations for codebook init (ref RQVAE.py:54)
    alpha: float = 0.02  # CF loss weight
    beta: float = 0.0001  # diversity loss weight
    n_clusters: int = 10  # diversity clusters per codebook
    # stored for config parity; the reference threads it through but never
    # branches on it (ref model.py:50, trainers/RQVAE.py uses the default path)
    sample_strategy: str = "all"

    @property
    def num_levels(self) -> int:
        return len(self.num_emb_list)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the batch axis: training normalizes with the
    batch mean and the biased variance max(E[x^2] - E[x]^2, 0) and moves the
    running statistics (`mean`, `var`) to momentum * old + (1 - momentum) *
    batch; eval normalizes with the running statistics."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(dim))  # flax "scale"
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        if train:
            mean = x.mean(dim=0)
            var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class MLPStack(nn.Module):
    """[in_dim, *dims] Dense layers (xavier-normal kernels), each after a
    dropout and followed by BatchNorm when `bn`, ReLU between them."""

    def __init__(self, in_dim: int, dims: Sequence[int], dropout: float = 0.0, bn: bool = False):
        super().__init__()
        self.dropout, self.bn, self.depth = dropout, bn, len(dims)
        for i, (d_in, d_out) in enumerate(zip([in_dim, *dims[:-1]], dims)):
            self.add_module(f"Dense_{i}", nn.Linear(d_in, d_out))
            if bn:
                self.add_module(f"BatchNorm_{i}", BatchNorm(d_out))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.depth):
            dense = getattr(self, f"Dense_{i}")
            d_out, d_in = dense.weight.shape
            std = math.sqrt(2.0 / (d_in + d_out)) / 0.87962566103423978  # truncated at 2 std
            nn.init.trunc_normal_(dense.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(dense.bias)

    def forward(self, x: torch.Tensor, train: bool = False,
                seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """`seeds`: one dropout seed a layer (training with dropout)."""
        for i in range(self.depth):
            if seeds is not None:
                x = hash_dropout(x, seeds[i], self.dropout)
            x = getattr(self, f"Dense_{i}")(x)
            if self.bn:
                x = getattr(self, f"BatchNorm_{i}")(x, train)
            if i != self.depth - 1:
                x = F.relu(x)
        return x


def _sq_dists(x: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    return (x * x).sum(dim=1, keepdim=True) + (book * book).sum(dim=1)[None, :] - 2.0 * x @ book.T


class RQVAE(nn.Module):
    """`device=None` means CUDA and raises without it; the tests pass
    `device="cpu"`. Weights are drawn from a CPU `torch.Generator` seeded with
    `seed`, in fp32."""

    def __init__(self, cfg: RQVAEConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.encoder = MLPStack(cfg.in_dim, [*cfg.layers, cfg.e_dim], cfg.dropout_prob, cfg.bn)
        self.decoder = MLPStack(cfg.e_dim, [*reversed(cfg.layers), cfg.in_dim],
                                cfg.dropout_prob, cfg.bn)
        self.codebooks = nn.Parameter(torch.empty(cfg.num_levels, max(cfg.num_emb_list),
                                                  cfg.e_dim))
        self.reset_parameters(torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.codebooks.device

    @property
    def dropout_sites(self) -> int:
        """Dropout seeds a training forward takes: one a Dense layer of the
        encoder and the decoder, none without dropout."""
        return self.encoder.depth + self.decoder.depth if self.cfg.dropout_prob > 0 else 0

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.encoder.reset_parameters(generator)
        self.decoder.reset_parameters(generator)
        # per-level uniform(-1/n_l, 1/n_l) (ref :36)
        scale = torch.tensor([1.0 / n for n in self.cfg.num_emb_list])[:, None, None]
        u = torch.rand(self.codebooks.shape, generator=generator) * 2.0 - 1.0
        self.codebooks.copy_(u * scale)

    def book(self, level: int) -> torch.Tensor:
        """This level's rows of the stacked codebook."""
        return self.codebooks[level, :self.cfg.num_emb_list[level]]

    # ---- quantization ------------------------------------------------------

    def _assign(self, residual: torch.Tensor, level: int, use_sk: bool, sample_last: bool,
                generator: Optional[torch.Generator],
                sk_epsilons: Optional[Sequence[float]] = None) -> torch.Tensor:
        c = self.cfg
        d = _sq_dists(residual, self.book(level))
        eps = float((c.sk_epsilons if sk_epsilons is None else sk_epsilons)[level])
        if use_sk and eps > 0:
            return balanced_assign(d, eps, c.sk_iters)
        if sample_last and level == c.num_levels - 1 and generator is not None:
            # softmax sampling of the last level (ref vector_quantizer.py:148-153); a CPU
            # multinomial, on no captured path (the task's step and emit never sample)
            probs = torch.softmax(-d.double(), dim=-1).cpu()
            return torch.multinomial(probs, 1, generator=generator)[:, 0].to(d.device)
        return torch.argmin(d, dim=-1)

    def quantize(self, x_e: torch.Tensor, use_sk: bool = True, sample_last: bool = False,
                 generator: Optional[torch.Generator] = None,
                 diversity_labels: Optional[torch.Tensor] = None,
                 diversity_noise: Optional[Sequence[torch.Tensor]] = None,
                 sk_epsilons: Optional[Sequence[float]] = None):
        """Residual quantization: (x_q, rq_loss, indices [B, L]);
        `sk_epsilons` overrides the config's (collision repair). With
        `diversity_labels` [L, max_n] and beta > 0 each level adds the
        diversity loss; its positives are the argmax of Gumbel noise over
        the same-cluster codes: `diversity_noise[level]` [B, n_l], else
        drawn from `generator`."""
        c = self.cfg
        residual = x_e
        x_q = torch.zeros_like(x_e)
        losses, indices = [], []
        for level in range(c.num_levels):
            idx = self._assign(residual, level, use_sk, sample_last, generator, sk_epsilons)
            quant = self.book(level)[idx]
            # per-level VQ losses on the residual target (ref :175-178)
            commitment = ((quant.detach() - residual) ** 2).mean()
            codebook_l = ((quant - residual.detach()) ** 2).mean()
            level_loss = codebook_l + c.mu * commitment
            if c.beta > 0 and diversity_labels is not None and (
                    diversity_noise is not None or generator is not None):
                noise = (diversity_noise[level] if diversity_noise is not None else
                         _gumbel((len(idx), c.num_emb_list[level]), generator, idx.device))
                level_loss = level_loss + c.beta * self._diversity_loss(
                    quant, idx, level, diversity_labels[level], noise)
            losses.append(level_loss)
            # straight-through per level, residual update
            quant_st = residual + (quant - residual).detach()
            residual = residual - quant_st
            x_q = x_q + quant_st
            indices.append(idx)
        return x_q, torch.stack(losses).mean(), torch.stack(indices, dim=-1)

    def _diversity_loss(self, x_q: torch.Tensor, indices: torch.Tensor, level: int,
                        labels: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """InfoNCE pulling each quantized vector toward a same-cluster
        positive code (ref vector_quantizer.py:49-88)."""
        book = self.book(level)
        n_e = book.shape[0]
        labels = labels[:n_e].to(indices.device)
        # positive: same cluster, not self — Gumbel-argmax over the mask
        same = labels[indices][:, None] == labels[None, :]  # [B, n_e]
        is_self = F.one_hot(indices, n_e).bool()
        mask = same & ~is_self
        has_pos = mask.any(dim=1)
        noise = noise.to(x_q.device, torch.float32)
        pos = torch.argmax(torch.where(mask, noise, -torch.inf), dim=1)
        sim = x_q @ book.T - 1e12 * is_self.to(x_q.dtype)  # mask self (ref :67-70)
        logp = torch.log_softmax(sim, dim=-1)
        nll = -logp.gather(1, pos[:, None])[:, 0]
        return torch.where(has_pos, nll, 0.0).mean()

    # ---- public API --------------------------------------------------------

    def forward(self, x: torch.Tensor, use_sk: bool = True, deterministic: bool = True,
                diversity_labels: Optional[torch.Tensor] = None,
                diversity_noise: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None,
                sample_last: bool = False,
                seed_table: Optional[torch.Tensor] = None) -> dict:
        """dict(out, rq_loss, indices, x_e, x_q). `deterministic=False`
        trains: BatchNorm on batch statistics (moving its running ones) and
        dropout at `dropout_prob`, its seeds read from `seed_table` (int32
        [dropout_sites] on the device) or else drawn from `generator`."""
        seeds = None
        if not deterministic and self.cfg.dropout_prob > 0:
            source = seed_table if seed_table is not None else generator
            if source is None:
                raise ValueError("training dropout needs a torch.Generator for its seeds")
            seeds = site_seeds(source, self.dropout_sites, self.device)
        train = not deterministic
        x_e = self.encoder(x, train, None if seeds is None else seeds[:self.encoder.depth])
        x_q, rq_loss, indices = self.quantize(
            x_e, use_sk=use_sk, sample_last=sample_last, generator=generator,
            diversity_labels=diversity_labels, diversity_noise=diversity_noise)
        out = self.decoder(x_q, train, None if seeds is None else seeds[self.encoder.depth:])
        return {"out": out, "rq_loss": rq_loss, "indices": indices, "x_e": x_e, "x_q": x_q}

    @torch.no_grad()
    def get_indices(self, x: torch.Tensor, use_sk: bool = False, sample_last: bool = False,
                    generator: Optional[torch.Generator] = None,
                    sk_epsilons: Optional[Sequence[float]] = None) -> torch.Tensor:
        return self.quantize(self.encoder(x), use_sk=use_sk, sample_last=sample_last,
                             generator=generator, sk_epsilons=sk_epsilons)[2]

    @torch.no_grad()
    def last_level_distances(self, x: torch.Tensor) -> torch.Tensor:
        """[B, n_e] squared distances of the last-level residual to the last
        codebook, with earlier levels assigned greedily (collision repair)."""
        c = self.cfg
        residual = self.encoder(x)
        for level in range(c.num_levels - 1):
            idx = self._assign(residual, level, False, False, None)
            residual = residual - self.book(level)[idx]
        return _sq_dists(residual, self.book(c.num_levels - 1))

    @torch.no_grad()
    def prefix_distances(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """([B, n_{L-2}] squared distances of the second-to-last residual to
        its codebook, [B, n_{L-2}, n_{L-1}] those of the last residual to the
        last codebook after each of its codes), earlier levels assigned
        greedily (collision repair across prefixes; at least two levels)."""
        c = self.cfg
        residual = self.encoder(x)
        for level in range(c.num_levels - 2):
            idx = self._assign(residual, level, False, False, None)
            residual = residual - self.book(level)[idx]
        mid, last = self.book(c.num_levels - 2), self.book(c.num_levels - 1)
        after = residual[:, None, :] - mid[None]  # [B, n_{L-2}, D]
        d_last = _sq_dists(after.reshape(-1, after.shape[-1]), last)
        return _sq_dists(residual, mid), d_last.reshape(len(x), len(mid), len(last))


def training_draws(model: RQVAE, B: int, generator: torch.Generator) -> dict:
    """The host draws of one training forward of `model` on B rows with
    the diversity loss on, from `generator` in the order the forward draws
    them: the dropout seed table ("seeds", int32, with dropout), then each
    level's Gumbel noise ("noise_<level>", [B, n_level] float32, when beta
    > 0). CPU tensors, to be staged."""
    c = model.cfg
    out = {}
    if model.dropout_sites:
        out["seeds"] = draw(generator, model.dropout_sites).to(torch.int32)
    if c.beta > 0:
        for level, n in enumerate(c.num_emb_list):
            out[f"noise_{level}"] = _gumbel((B, n), generator, "cpu")
    return out


def _gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel noise from a CPU generator."""
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    return (-torch.log(-torch.log(u.clamp(min=1e-300)))).float().to(device)


def rqvae_loss(cfg: RQVAEConfig, outputs: dict, x: torch.Tensor,
               cf_emb: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, dict]:
    """Total loss = recon + quant_weight * rq + alpha * CF (ref
    model.py:121-150). The CF InfoNCE compares the quantized representation
    with the items' collaborative-filtering embeddings batch-wise (ref
    model.py:105-110: logits = x_q @ cf^T over the batch, label = own row)."""
    out = outputs["out"]
    if cfg.loss_type == "mse":
        recon = ((out - x) ** 2).mean()
    elif cfg.loss_type == "l1":
        recon = (out - x).abs().mean()
    else:
        raise ValueError(cfg.loss_type)
    total = recon + cfg.quant_loss_weight * outputs["rq_loss"]
    cf_loss = torch.zeros((), device=out.device)
    if cfg.alpha > 0 and cf_emb is not None:
        logp = torch.log_softmax(outputs["x_q"] @ cf_emb.T, dim=-1)
        cf_loss = -logp.diagonal().mean()
        total = total + cfg.alpha * cf_loss
    return total, {"recon_loss": recon, "quant_loss": outputs["rq_loss"], "cf_loss": cf_loss}
