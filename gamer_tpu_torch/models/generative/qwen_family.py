"""The Qwen3 generative decoder family as one parametric architecture.

PyTorch counterpart of `gamer_tpu/models/generative/qwen_family.py`: the seven
reference decoders are one model plus a preset table of six switches

  self_mask_kind            "causal" | "session"       (ops/masks.py)
  cross_attention_layers    behavior cross-attention with gating + per-action
                            qkv embeddings (Qwen3Multi)
  sparse_layers             position-routed MoE (modules/moe.py)
  behavior_injection_layers behavior embedding injected into the FFN input
  rope_on_extended_session  RoPE positions = extended_session_ids
  moe_action                expert id also indexed by behavior (MoeAction)

Masks, routing and rope positions come from `prepare_train_inputs` (training
and scoring) or the beam-search loop (`decode/beam.py`); KV caches are passed
in and returned. The training forward (`deterministic=False`) drops attention
probabilities, the MoE activation and the three residual branches by the
stateless hash, one int32 seed per site drawn in a fixed order from a
caller-given `torch.Generator`; `cfg.remat` recomputes each layer in the
backward (`torch.utils.checkpoint`), which the hash masks make exact, keeping
what `cfg.remat_policy` says: nothing ("full"), the attention cores' outputs
and saved tensors ("attn": the attention kernel never runs again), or the
dense products' results ("dots", by selective checkpointing). MoeAction passes
`expert_index` to the MLPs; for their fused periodic path the forward builds
the row table of the blocks' levels once (`modules/moe.moe_action_rows`) and
every layer's one grouped launch reads it (`modules/moe.py`).

Parameters are stored in fp32, as the JAX package stores them; the modules
cast them to `cfg.dtype` at use, so a bf16 run updates fp32 master weights.

While `core/trace.marking()` is on, a forward with grad marks its device
sections on the residual stream (`trace.boundary`): `embed` (the token
table), then in each layer `self_attn`, `cross_attn` and `mlp` (each
residual sub-block, its dropout-add included), then `head` (the final norm
onward); their backwards are marked where the gradient crosses the same
boundaries.

On a model axis (`core/mesh.MeshContext.shard_params`) the padded token
table is split by rows and the experts by expert (`modules/moe.py`). A rank
looks up the ids in its rows (0 for the others) and the ranks' rows sum; its
tied head is its real rows (the padded rows >= `vocab_size` never enter a
logit or the CE), the training CE is `losses.vocab_parallel_ce_rows`, and the
logits are the ranks' columns gathered over the vocab.

`attention_impl`, `moe_impl` and `ce_impl` keep the JAX config's names and
values: "jnp" selects the plain PyTorch path (materialized masks, einsum MoE,
[B, S, V] logits); any other value ("auto", "pallas", "pallas_interpret")
selects the fused path, which is the hand-written CUDA kernel for CUDA tensors
and the kernel's plain version for CPU tensors.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.core.config import Config, config_field
from gamer_tpu_torch.core.device import resolve_device
from gamer_tpu_torch.modules.dropout import attention_row_seed, hash_dropout_add
from gamer_tpu_torch.modules.layers import GQAAttention, RMSNorm, dense, embed, lookup
from gamer_tpu_torch.modules.moe import PositionRoutedMLP, moe_action_rows
from gamer_tpu_torch.ops import masks as mask_ops
from gamer_tpu_torch.ops import router as router_ops
from gamer_tpu_torch.ops.seeds import site_seeds


REMAT_POLICIES = ("full", "attn", "dots")
# Every `torch.utils.checkpoint` here passes preserve_rng_state=False: the
# forward draws no torch random numbers on the card (every dropout mask is a
# hash of its seed), so there is no RNG state to stash and restore, and
# stashing the CUDA RNG state is refused while a CUDA graph is captured
# (`train/loop.Trainer`'s compiled step).
# what the backward keeps under remat, besides each layer's input. "full":
# nothing, the whole layer runs again (kernels a and h with it). "dots": the
# results of the dense products without batch dims (aten mm/addmm: the
# q/k/v/o and gating projections, the plain path's dense MLPs), selected by
# `torch.utils.checkpoint`'s selective checkpointing, which sees aten ops
# only: the attention kernel a and the MoE kernel h are no dots and run
# again. "attn" is `DecoderLayer`'s `keep_attention`: only kernel h runs again.
_REMAT_CONTEXT = {
    "full": {},
    "dots": {"context_fn": functools.partial(
        torch.utils.checkpoint.create_selective_checkpoint_contexts,
        [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])},
}


class QwenFamilyConfig(Config):
    # core transformer (defaults = the flagship GAMER scale,
    # ref config/s2s-models/Qwen3Multi/config.json)
    vocab_size: int = 14
    hidden_size: int = 256
    num_hidden_layers: int = 8
    num_attention_heads: int = 6
    num_key_value_heads: int = 3
    head_dim: int = 64
    intermediate_size: int = 512
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    dropout_rate: float = 0.2
    # attention-prob dropout; -1 = follow dropout_rate
    attention_dropout: float = -1.0
    attention_bias: bool = False
    hidden_act: str = "silu"
    tie_word_embeddings: bool = True
    temperature: float = 1.0
    # family switches
    self_mask_kind: str = "causal"
    cross_mask_kind: str = "multi"
    cross_attention_layers: list = config_field([])
    sparse_layers: list = config_field([])
    behavior_injection_layers: list = config_field([])
    moe_action: bool = False
    rope_on_extended_session: bool = False
    mlp_type: str = "qwen3"
    # token geometry (set at task-build time from the dataset)
    num_positions: int = 5  # tokens per item block (sole_item_len + behavior token)
    num_experts: int = 6  # normally num_positions + 1
    num_behavior: int = 3
    behavior_embedding_dim: int = 64
    behavior_base: int = 14  # first behavior-token id in the vocab
    model_max_length: int = 1024
    dtype: str = "float32"
    # "jnp" = plain PyTorch path; anything else = the fused kernel path (see
    # the module docstring). The port's default is the kernel path.
    attention_impl: str = "auto"
    moe_impl: str = "auto"
    ce_impl: str = "auto"
    # residual dropout mask source of the JAX package ("bits" | "hash"); kept
    # for config round-trips: the port always uses the hash
    dropout_impl: str = "hash"
    # embed-table row count, >= vocab_size (0 = vocab_size); padded rows are
    # never looked up and never produce logits
    padded_vocab_size: int = 0
    # recompute each layer in the backward (gradient checkpointing); what the
    # backward may keep instead (REMAT_POLICIES, the JAX package's names):
    #   "full" — nothing: the whole layer is recomputed
    #   "attn" — the attention cores' outputs and saved tensors: no attention
    #            kernel re-run; norms, projections, MoE and dropout re-run
    #   "dots" — every dense product's result; the rest is recomputed
    remat: bool = False
    remat_policy: str = "attn"

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.dtype]

    @property
    def attn_dropout_rate(self) -> float:
        return self.dropout_rate if self.attention_dropout < 0 else self.attention_dropout

    @property
    def total_experts(self) -> int:
        if self.moe_action:
            return (self.num_experts - 1) * self.num_behavior + 1
        return self.num_experts


# Family presets: the switch settings reproducing each reference model.
# "all"/"half_lo"/"half_hi" resolve against num_hidden_layers in build_config.
QWEN_FAMILY_PRESETS: dict[str, dict] = {
    "Qwen3": dict(),
    "Qwen3Session": dict(self_mask_kind="session", rope_on_extended_session=True),
    "Qwen3Moe": dict(sparse="all", injection="all"),
    "Qwen3MoeAction": dict(sparse="all", injection="all", moe_action=True),
    "Qwen3SessionMoe": dict(self_mask_kind="session", rope_on_extended_session=True,
                            sparse="all", injection="all"),
    "Qwen3Multi": dict(sparse="all", injection="half_lo", cross="half_hi",
                       cross_mask_kind="multi"),
    "Qwen3SessionMulti": dict(self_mask_kind="session", rope_on_extended_session=True,
                              sparse="all", injection="half_lo", cross="half_hi",
                              cross_mask_kind="session_multi"),
}


def build_config(backbone: str, **overrides: Any) -> QwenFamilyConfig:
    """Resolve a preset name + overrides into a concrete config."""
    preset = dict(QWEN_FAMILY_PRESETS[backbone])
    n_layers = overrides.get("num_hidden_layers", QwenFamilyConfig.num_hidden_layers)
    ranges = {
        "all": list(range(n_layers)),
        "half_lo": list(range(n_layers // 2)),
        "half_hi": list(range(n_layers // 2, n_layers)),
        "none": [],
    }
    for key, field in (("sparse", "sparse_layers"), ("injection", "behavior_injection_layers"),
                       ("cross", "cross_attention_layers")):
        if key in preset:
            preset[field] = ranges[preset.pop(key)]
    preset.update(overrides)
    cfg = QwenFamilyConfig.from_dict(preset)
    cfg.extra["backbone"] = backbone
    return cfg


class DecoderLayer(nn.Module):
    """Self-attention, optional behavior cross-attention, routed MLP; each
    sub-block pre-normed and residual (with hash dropout in training)."""

    def __init__(self, cfg: QwenFamilyConfig, i: int):
        super().__init__()
        self.is_cross = i in cfg.cross_attention_layers
        attn = lambda is_cross: GQAAttention(
            cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
            rope_theta=cfg.rope_theta, rms_eps=cfg.rms_norm_eps,
            attention_bias=cfg.attention_bias, is_cross=is_cross,
            num_behavior=cfg.num_behavior, use_kernel=cfg.attention_impl != "jnp",
            dropout_rate=cfg.attn_dropout_rate)
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = attn(False)
        if self.is_cross:
            self.post_self_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            self.cross_attn = attn(True)
        self.post_cross_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = PositionRoutedMLP(
            cfg.hidden_size, cfg.intermediate_size, cfg.total_experts,
            is_sparse=i in cfg.sparse_layers, mlp_type=cfg.mlp_type,
            hidden_act=cfg.hidden_act, behavior_injection=i in cfg.behavior_injection_layers,
            num_behavior=cfg.num_behavior, behavior_dim=cfg.behavior_embedding_dim,
            use_kernel=cfg.moe_impl != "jnp", dropout_rate=cfg.dropout_rate)
        self.dropout_rate = cfg.dropout_rate
        # dropout sites, in seed order: self-attention probs and residual,
        # cross-attention probs and residual, MLP activation and residual
        self.dropout_sites = 6 if self.is_cross else 4
        self.self_mask_kind = cfg.self_mask_kind
        self.cross_mask_kind = cfg.cross_mask_kind
        self.num_positions = cfg.num_positions
        self.moe_action = cfg.moe_action

    def forward(self, x, rope_positions, self_allowed, cross_allowed, position_index,
                behavior_index, action_index, expert_index, streams, caches, cache_index,
                route_mode, seeds=None, keep_attention=False, row0=0, level_rows=None):
        """`seeds`: this layer's `dropout_sites` dropout seeds, or None for
        the deterministic forward. `level_rows`: the MoeAction row table of
        the grouped MoE launch (`modules/moe.moe_action_rows`), or None.
        `keep_attention` (remat policy "attn"):
        the stages between the attention cores run under
        `torch.utils.checkpoint`, so the backward recomputes the norms,
        projections, dropout and MLP and keeps what each attention core
        saved (its kernel does not run again). `row0`: the first global
        batch row of x's rows under a process group; it moves every dropout
        seed so that the masks are the global batch's
        (`modules/dropout.row_seed`)."""
        det = seeds is None
        s = [0] * self.dropout_sites if det else list(seeds)
        # r + dropout(y), one K1 launch on the card
        drop_add = (lambda r, y, seed: r + y if det
                    else hash_dropout_add(r, y, seed, self.dropout_rate, row0))
        attn_seed = lambda seed: attention_row_seed(seed, row0, self.self_attn.num_heads)
        stage = (functools.partial(torch.utils.checkpoint.checkpoint, use_reentrant=False,
                                   preserve_rng_state=False)
                 if keep_attention else (lambda fn, *a: fn(*a)))
        caches = caches or {}

        def mlp(x):
            h = self.mlp(self.post_cross_attention_layernorm(x), position_index, behavior_index,
                         expert_index=expert_index if self.moe_action else None,
                         route_mode=route_mode, num_positions=self.num_positions,
                         deterministic=det, dropout_seed=s[-2], row0=row0,
                         level_rows=level_rows)
            return drop_add(x, h, s[-1])

        qkv = stage(lambda x: self.self_attn.qkv(self.input_layernorm(x), rope_positions), x)
        o, new_self = self.self_attn.core(*qkv, self_allowed, caches.get("self"), cache_index,
                                          self.self_mask_kind, streams, det, attn_seed(s[0]))
        if not self.is_cross:
            x = stage(lambda x, o: mlp(trace.boundary(
                drop_add(x, self.self_attn.output(x, o), s[1]), "self_attn", "mlp")), x, o)
            return x, new_self, None

        def after_self(x, o):
            x = trace.boundary(drop_add(x, self.self_attn.output(x, o), s[1]),
                               "self_attn", "cross_attn")
            h = self.post_self_attention_layernorm(x)  # also the gate's input
            return (x, h, *self.cross_attn.qkv(h, rope_positions, action_index))

        x, h, *qkv = stage(after_self, x, o)
        o, new_cross = self.cross_attn.core(*qkv, cross_allowed, caches.get("cross"),
                                            cache_index, self.cross_mask_kind, streams, det,
                                            attn_seed(s[2]))
        x = stage(lambda x, h, o: mlp(trace.boundary(
            drop_add(x, self.cross_attn.output(h, o), s[3]), "cross_attn", "mlp")), x, h, o)
        return x, new_self, new_cross


class QwenFamilyModel(nn.Module):
    """The decoder family's forward.

    `device=None` means CUDA and raises without it; the tests pass
    `device="cpu"`. Weights are drawn from a CPU `torch.Generator` seeded with
    `seed` (the same values on every device) and stored in fp32; the forward
    computes in `cfg.dtype`.
    """

    model_axis = None  # distributed.ModelAxis of a row-split token table
    # the parameters that run split on a model axis (core/mesh.shard_params)
    model_axis_params = r"embed_tokens\.weight|layers\.\d+\.mlp\.experts_(gate|up|down)"
    mesh_ctx = None  # the core/mesh.MeshContext that sharded the parameters

    def __init__(self, cfg: QwenFamilyConfig, device: str | torch.device | None = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.embed_tokens = nn.Embedding(cfg.padded_vocab_size or cfg.vocab_size,
                                             cfg.hidden_size)
            self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                        for i in range(cfg.num_hidden_layers))
            self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
            if not cfg.tie_word_embeddings:
                self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)
        self.to_empty(device=device)
        self.reset_parameters(torch.Generator().manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.embed_tokens.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Lecun-normal linears and experts (std 1/sqrt(fan_in)), embeddings
        with std 1/sqrt(width), unit norms, zero biases, as the JAX
        package's initializers."""
        def fill(p, std):
            p.copy_(torch.randn(p.shape, generator=generator) * std)

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fill(mod.weight, 1.0 / math.sqrt(mod.in_features))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                fill(mod.weight, 1.0 / math.sqrt(mod.embedding_dim))
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)
            elif isinstance(mod, PositionRoutedMLP):
                for w in mod.parameters(recurse=False):  # [(E,) d_in, d_out]
                    fill(w, 1.0 / math.sqrt(w.shape[-2]))

    @property
    def dropout_sites(self) -> int:
        """Dropout seeds a training forward draws: each layer's sites."""
        return sum(layer.dropout_sites for layer in self.layers)

    def vocab_block(self) -> tuple[int, int] | None:
        """(first row, rows) of this rank's block of a row-split token table,
        None when the table is whole."""
        rows = self.embed_tokens.weight.shape[0]
        if rows == (self.cfg.padded_vocab_size or self.cfg.vocab_size):
            return None
        return self.model_axis.index * rows, rows

    def lm_table(self) -> torch.Tensor:
        """The tied head: embedding rows of the real vocab (padded rows never
        produce logits); of a row-split table, this rank's real rows."""
        block = self.vocab_block()
        real = self.cfg.vocab_size if block is None else max(0, min(block[1],
                                                                    self.cfg.vocab_size - block[0]))
        return self.embed_tokens.weight[:real]

    def _embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        block = self.vocab_block()
        if block is None:
            return embed(self.embed_tokens, input_ids, self.cfg.torch_dtype)
        local = input_ids.long() - block[0]
        inside = (local >= 0) & (local < block[1])
        rows = lookup(torch.where(inside, local, 0), self.embed_tokens.weight)
        rows = torch.where(inside[..., None], rows, 0.0).to(self.cfg.torch_dtype)
        return self.model_axis.reduce(rows)

    def _tied_logits(self, x: torch.Tensor) -> torch.Tensor:
        table = self.lm_table()
        logits = x @ table.to(x.dtype).T
        block = self.vocab_block()
        if block is None:
            return logits
        logits = torch.nn.functional.pad(logits, (0, block[1] - table.shape[0]))
        return self.model_axis.gather(logits, -1)[..., :self.cfg.vocab_size]

    def forward(
        self,
        input_ids: torch.Tensor,  # [B, S]
        rope_positions: torch.Tensor,  # [B, S]
        self_allowed: Optional[torch.Tensor] = None,  # [B or 1, 1, S, K] bool
        cross_allowed: Optional[torch.Tensor] = None,
        position_index: Optional[torch.Tensor] = None,  # [B, S]
        behavior_index: Optional[torch.Tensor] = None,
        action_index: Optional[torch.Tensor] = None,
        expert_index: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        route_mode: str = "periodic",
        caches: Optional[dict] = None,  # {"self": [L dicts], "cross": [L dicts|None]}
        cache_index: Optional[int] = None,
        logits_last_only: bool = False,
        return_hidden: bool = False,
        streams: Optional[dict] = None,  # fused-attention integer mask streams
        generator=None,  # dropout seeds (training): a torch.Generator or the seed table
        row0: int = 0,  # first global batch row of this process's rows
    ) -> dict:
        """`deterministic=False` (training) draws one int32 dropout seed a
        site from `generator` (a CPU generator), in layer order, or reads
        them from `generator` given as the step's [dropout_sites] int32 seed
        table on the model's device (`ops/seeds.site_seeds`: the compiled
        step's, whose kernels read the seeds on the card; the same masks).
        Under a process group `row0` makes every dropout mask that of the
        global batch (`modules/dropout.row_seed`)."""
        cfg = self.cfg
        seeds = None
        if not deterministic:
            seeds = iter(site_seeds(generator, self.dropout_sites, self.device))
        trace.mark("embed", self.device, grad_only=True)
        x = self._embed_tokens(input_ids)
        new_caches = {"self": [], "cross": []} if caches is not None else None
        level_rows = None
        if (cfg.moe_action and route_mode == "periodic" and expert_index is not None
                and cfg.moe_impl != "jnp"):  # the fused MLPs' one grouped launch a layer
            level_rows = moe_action_rows(expert_index, cfg.num_positions, cfg.num_behavior)
        remat = cfg.remat and caches is None and torch.is_grad_enabled()
        if remat and cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; one of {REMAT_POLICIES}")
        for i, layer in enumerate(self.layers):
            layer_caches = None
            if caches is not None:
                layer_caches = {"self": caches["self"][i], "cross": caches["cross"][i]}
            layer_seeds = None
            if seeds is not None:
                layer_seeds = [next(seeds) for _ in range(layer.dropout_sites)]
            x = trace.boundary(x, "mlp" if i else "embed", "self_attn")
            args = (x, rope_positions, self_allowed, cross_allowed, position_index,
                    behavior_index, action_index, expert_index, streams, layer_caches,
                    cache_index, route_mode, layer_seeds)
            if not remat:
                x, new_self, new_cross = layer(*args, False, row0, level_rows)
            elif cfg.remat_policy == "attn":
                x, new_self, new_cross = layer(*args, True, row0, level_rows)
            else:
                x, new_self, new_cross = torch.utils.checkpoint.checkpoint(
                    layer, *args, False, row0, level_rows, use_reentrant=False,
                    preserve_rng_state=False,
                    **_REMAT_CONTEXT[cfg.remat_policy])
            if new_caches is not None:
                new_caches["self"].append(new_self)
                new_caches["cross"].append(new_cross)
        x = self.norm(trace.boundary(x, "mlp", "head"))
        if return_hidden:
            return {"hidden": x, "caches": new_caches}
        if logits_last_only:
            x = x[:, -1:, :]
        if self.cfg.tie_word_embeddings:
            logits = self._tied_logits(x)
        else:
            logits = dense(self.lm_head, x)
        return {"logits": logits, "caches": new_caches}


def prepare_train_inputs(cfg: QwenFamilyConfig, batch: dict) -> dict:
    """Masks or mask streams, routing and rope positions for a right-padded
    scoring batch of tensors. The fused attention path gets the integer
    streams; the plain path ("jnp") gets the materialized boolean masks."""
    input_ids = batch["input_ids"]
    attn = batch["attention_mask"]
    B, S = input_ids.shape
    rel = router_ops.rel_positions(attn)
    block_ids = torch.where(rel >= 0, torch.div(rel, cfg.num_positions, rounding_mode="floor"),
                            -1).to(torch.int32)

    streams = self_allowed = cross_allowed = None
    zeros = torch.zeros_like(attn)
    if cfg.attention_impl != "jnp":
        streams = dict(attention_mask=attn, session_ids=batch.get("session_ids", zeros),
                       actions=batch.get("actions", zeros), block_ids=block_ids)
    else:
        self_allowed = mask_ops.self_mask(
            cfg.self_mask_kind, S, attention_mask=attn, session_ids=batch.get("session_ids"),
            actions=batch.get("actions"), block_ids=block_ids)
        if cfg.cross_attention_layers:
            cross_allowed = mask_ops.cross_mask(
                cfg.cross_mask_kind, S, attention_mask=attn,
                session_ids=batch.get("session_ids"), actions=batch.get("actions"))

    pos_idx, beh_idx, act_idx = router_ops.route_tokens(
        input_ids, rel, cfg.num_positions, cfg.behavior_base, cfg.num_behavior)
    expert_index = None
    if cfg.moe_action:
        expert_index = router_ops.moe_action_expert_index(pos_idx, act_idx, cfg.num_experts)

    if cfg.rope_on_extended_session:
        rope_positions = batch["extended_session_ids"]
    else:
        rope_positions = torch.arange(S, dtype=torch.int32,
                                      device=input_ids.device)[None].expand(B, S)

    return dict(
        input_ids=input_ids,
        rope_positions=rope_positions,
        self_allowed=self_allowed,
        cross_allowed=cross_allowed,
        position_index=pos_idx,
        behavior_index=beh_idx,
        action_index=act_idx,
        expert_index=expert_index,
        streams=streams,
    )
