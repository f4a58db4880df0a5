"""Trie-constrained beam search for fixed-length semantic IDs (decoder-only).

PyTorch counterpart of the decoder-only search of `gamer_tpu/decode/beam.py`:

  prefill(prompt)  -> last-position logits + KV caches for both streams
  L-1 decode steps -> per-level logits sliced to the level's contiguous token
                      range, masked by the LeveledTrie tables, renormalized
                      (log_softmax over allowed), top-K beam transition,
                      generated KV reordered by parent beam

Level 0 comes from the trie root. Decode mask rows are beam-invariant over the
prompt, so the prompt KV is computed once per example and shared by its
beams; only the KV of generated tokens is per beam. Scores are accumulated in
fp32 whatever the model dtype. With `behavior_emb_id=None` level 0 of the
trie is the behavior token itself (test_MB_decoder's BEHAVIOR_ITEM mode):
each beam's behavior embedding id is its level-0 code + 1, reordered with
the beams. MoeAction models get their expert ids from (position, behavior)
at every step.

The enc-dec search (`constrained_beam_search_encdec`, TIGER and
PBATransformer) runs the encoder once and the decoder prefix
[decoder_start(, behavior token)], projects the encoder's cross k/v once,
shared by the beams ([B, Senc]), and keeps a per-beam decoder self cache of
P0 + L positions, of which each step moves only the generated slice.

`make_beam_search_fn` and `make_beam_search_encdec_fn` return the compiled
searches, the counterparts of the JAX package's jitted ones: on the card the
search (prefill and every step) is one CUDA graph a key, replayed
(`_CompiledSearch`); `constrained_beam_search` and
`constrained_beam_search_encdec` run the same device part eagerly. A call is
the trace step `search.call`; its device part marks the sections `prefill`
(the prompt's, or the encoder's, forward) and `decode` (level 0 and the
L - 1 steps) while `core/trace.marking()` is on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.core.graphs import StagedGraphs, model_axis_of
from gamer_tpu_torch.decode.trie import LeveledTrie
from gamer_tpu_torch.models.generative.encdec import EncDecModel
from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig, QwenFamilyModel
from gamer_tpu_torch.ops import masks as mask_ops
from gamer_tpu_torch.ops import router as router_ops
from gamer_tpu_torch.train.staging import as_array

NEG = -1e30


@dataclass(frozen=True)
class BeamSearchConfig:
    num_beams: int = 20
    # "auto" = bfloat16 on CUDA, float32 on the CPU
    cache_dtype: str = "auto"


def resolve_cache_dtype(name: str, device: torch.device) -> torch.dtype:
    if name == "auto":
        name = "bfloat16" if device.type == "cuda" else "float32"
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def prepare_prefill(cfg: QwenFamilyConfig, batch: dict) -> tuple[dict, dict]:
    """Model inputs for the prompt forward, plus decode-time constants.

    Caches cover the prompt only ([B, S]); generated-token KV lives in small
    per-beam side caches (see `constrained_beam_search`)."""
    input_ids = batch["input_ids"]
    attn = batch["attention_mask"]
    B, S = input_ids.shape
    rel = router_ops.rel_positions(attn)
    block_ids = torch.where(rel >= 0, torch.div(rel, cfg.num_positions, rounding_mode="floor"),
                            -1)

    self_allowed = mask_ops.self_mask(
        cfg.self_mask_kind, S, attention_mask=attn, session_ids=batch.get("session_ids"),
        actions=batch.get("actions"), block_ids=block_ids).expand(B, 1, S, S)
    cross_allowed = cross_row = None
    if cfg.cross_attention_layers:
        cross_allowed = mask_ops.cross_mask(
            cfg.cross_mask_kind, S, attention_mask=attn, session_ids=batch.get("session_ids"),
            actions=batch.get("actions"))
        cross_row = cross_allowed[:, 0, -1, :]  # last prompt token's row [B, S]

    pos_idx, beh_idx, act_idx = router_ops.route_tokens(
        input_ids, rel, cfg.num_positions, cfg.behavior_base, cfg.num_behavior)
    expert_index = None
    if cfg.moe_action:
        expert_index = router_ops.moe_action_expert_index(pos_idx, act_idx, cfg.num_experts)

    if cfg.rope_on_extended_session:
        rope_positions = batch["extended_session_ids"]
        max_esid = batch["extended_session_ids"].amax(dim=-1)  # [B]
    else:
        rope_positions = torch.arange(S, dtype=torch.int32,
                                      device=input_ids.device)[None].expand(B, S)
        max_esid = None

    inputs = dict(input_ids=input_ids, rope_positions=rope_positions,
                  self_allowed=self_allowed, cross_allowed=cross_allowed,
                  position_index=pos_idx, behavior_index=beh_idx, action_index=act_idx,
                  expert_index=expert_index)
    consts = dict(cross_row=cross_row, max_esid=max_esid, prompt_attn=attn)
    return inputs, consts


def init_caches(cfg: QwenFamilyConfig, batch_size: int, k_total: int, dtype,
                device) -> dict:
    shape = (batch_size, k_total, cfg.num_key_value_heads, cfg.head_dim)
    mk = lambda: {"k": torch.zeros(shape, dtype=dtype, device=device),
                  "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {
        "self": [mk() for _ in range(cfg.num_hidden_layers)],
        "cross": [mk() if i in cfg.cross_attention_layers else None
                  for i in range(cfg.num_hidden_layers)],
    }


def _level_logp(logits: torch.Tensor, allowed: torch.Tensor) -> torch.Tensor:
    """log_softmax over the allowed codes; disallowed codes score NEG."""
    masked = torch.where(allowed, logits.float(), NEG)
    return torch.where(allowed, torch.log_softmax(masked, dim=-1), NEG)


@torch.no_grad()
def constrained_beam_search(
    model: QwenFamilyModel,
    batch: dict,
    trie: LeveledTrie,
    behavior_emb_id,
    search_cfg: BeamSearchConfig = BeamSearchConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (codes [B, num_beams, L] 0-based per-level codes sorted by
    score desc, scores [B, num_beams] fp32 sums of log-probs), eagerly.

    `batch` holds the left-padded prompt ([B, S] `input_ids`,
    `attention_mask`, per preset `session_ids`, `actions`,
    `extended_session_ids`) and `prompt_len` [B], as tensors or numpy arrays.
    `behavior_emb_id` is an int, a per-example [B] array, or None: level 0
    of the trie then decodes the behavior token, and each beam's behavior
    embedding id is its level-0 code + 1 (behavior tokens are a contiguous
    vocab range)."""
    return BeamSearch(model, trie, search_cfg, graphed=False)(batch, behavior_emb_id)


def _search(model: QwenFamilyModel, batch: dict, trie: LeveledTrie, tables, beh,
            search_cfg: BeamSearchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The device part of `constrained_beam_search`: prefill and the L - 1
    steps on the device tensors of `batch` (the prompt keys), the trie's
    device `tables` (`_trie_tables`) and `beh`, the [B] int32 behavior ids
    or None (the behavior-token decode). Reads nothing into Python and
    copies nothing from the host."""
    cfg = model.cfg
    device = model.device
    L = trie.num_levels
    K = search_cfg.num_beams
    B, S = batch["input_ids"].shape
    cache_dtype = resolve_cache_dtype(search_cfg.cache_dtype, device)
    allowed_tables, child_tables = tables

    trace.mark("prefill", device)
    inputs, consts = prepare_prefill(cfg, batch)
    out = model(**inputs, caches=init_caches(cfg, B, S, cache_dtype, device), cache_index=0,
                logits_last_only=True, route_mode="onehot")
    caches = out["caches"]
    logits0 = out["logits"][:, 0, :]  # [B, V]
    trace.mark("decode", device)

    # step 0: level-0 codes from the trie root
    scores, gen_codes, nodes = _first_level(logits0, trie, allowed_tables, child_tables, K)
    codes0 = gen_codes[:, :, 0]

    # prompt KV stays [B, S], shared by the beams; generated KV is per beam
    Tg = max(L - 1, 1)
    gen_shape = (B * K, Tg, cfg.num_key_value_heads, cfg.head_dim)
    caches = {
        "self": [dict(k_prompt=c["k"], v_prompt=c["v"],
                      k=torch.zeros(gen_shape, dtype=cache_dtype, device=device),
                      v=torch.zeros(gen_shape, dtype=cache_dtype, device=device))
                 for c in caches["self"]],
        "cross": [None if c is None else dict(k_prompt=c["k"], v_prompt=c["v"])
                  for c in caches["cross"]],
    }
    prompt_self_row = (consts["prompt_attn"] == 1)[:, None, None, :]  # [B, 1, 1, S]
    cross_row = None
    if consts["cross_row"] is not None:
        cross_row = consts["cross_row"][:, None, None, :]
    max_esid_t = None
    if consts["max_esid"] is not None:
        max_esid_t = consts["max_esid"].repeat_interleave(K)
    prompt_len_t = batch["prompt_len"].to(torch.int32).repeat_interleave(K)

    if beh is None:  # from the decoded behavior tokens
        beh_bk = (codes0 + 1).to(torch.int32)
    else:
        beh_bk = beh[:, None].expand(B, K).contiguous()

    for step in range(1, L):
        # token processed now = code chosen at level step-1
        prev_codes = gen_codes[:, :, step - 1].reshape(B * K)
        tok = (prev_codes + trie.level_token_base[step - 1]).to(torch.int32)[:, None]
        rel_g = prompt_len_t + step - 1  # relative position of this token
        pos_index = (torch.remainder(rel_g, cfg.num_positions) + 1)[:, None]
        if cfg.rope_on_extended_session:
            rope_pos = (max_esid_t + step)[:, None]
        else:
            rope_pos = torch.full((B * K, 1), S + step - 1, dtype=torch.int32, device=device)
        beh_col = beh_bk.reshape(B * K, 1)
        expert_index = None
        if cfg.moe_action:
            expert_index = router_ops.moe_action_expert_index(pos_index, beh_col,
                                                              cfg.num_experts)

        out = model(input_ids=tok, rope_positions=rope_pos, self_allowed=prompt_self_row,
                    cross_allowed=cross_row, position_index=pos_index,
                    behavior_index=beh_col, action_index=beh_col, expert_index=expert_index,
                    route_mode="onehot", caches=caches, cache_index=step - 1)
        caches = out["caches"]
        logits = out["logits"][:, 0, :]  # [B*K, V]

        base, size = trie.level_token_base[step], trie.level_sizes[step]
        flat_nodes = nodes.reshape(B * K)
        allowed = allowed_tables[step][flat_nodes.clamp(min=0)] & (flat_nodes >= 0)[:, None]
        logp = _level_logp(logits[:, base:base + size], allowed)

        total = scores[:, :, None] + logp.reshape(B, K, size)
        scores, idx = torch.topk(total.reshape(B, K * size), K, dim=-1)  # [B, K]
        parent = torch.div(idx, size, rounding_mode="floor")
        code = idx % size

        # reorder beam state by parent
        gen_codes = torch.cat([torch.gather(gen_codes, 1, parent[:, :, None].expand(-1, -1, step)),
                               code[:, :, None]], dim=2)
        parent_nodes = torch.gather(nodes, 1, parent).reshape(B * K)
        nodes = child_tables[step][parent_nodes.clamp(min=0), code.reshape(B * K)].reshape(B, K)
        beh_bk = torch.gather(beh_bk, 1, parent)
        # the shared prompt KV never moves; cross caches hold no per-beam state
        flat_parent = (torch.arange(B, device=device)[:, None] * K + parent).reshape(B * K)
        caches = {
            "self": [{**c, "k": c["k"][flat_parent], "v": c["v"][flat_parent]}
                     for c in caches["self"]],
            "cross": caches["cross"],
        }

    trace.mark(trace.UNMARKED, device)
    return gen_codes, scores


PROMPT_KEYS = ("input_ids", "attention_mask", "session_ids", "actions", "extended_session_ids",
               "prompt_len")


def _trie_tables(trie: LeveledTrie, device) -> tuple[list, list]:
    """The trie's per-level `allowed` and (int64) `child` tables on `device`."""
    return ([torch.as_tensor(a, device=device) for a in trie.allowed],
            [torch.as_tensor(c, device=device).long() for c in trie.child])


class _CompiledSearch:
    """A search bound to one model, trie and search config, in two parts
    (JAX jits the whole search, `gamer_tpu/decode/beam.py`
    `make_beam_search_fn`). The trie's tables move to the device once, here.
    The host part (`stage`) writes a call's arrays into static device buffers;
    the device part (`device_part`) runs the search on them, reading nothing
    into Python and holds no collective. On CUDA, and `graphed`, the device
    part is captured as a CUDA graph once per key (the staged arrays' names,
    shapes and dtypes) and replayed (`core/graphs.StagedGraphs`, a memory
    pool a search object: the prefill's peak stays reserved while the object
    lives), its codes and scores cloned out of the graph's memory; else it
    runs eagerly. It is captured under any process group (each process
    searches its own rows), but not for a model with a live model axis,
    whose forward holds the model group's collectives."""

    name = "beam search"

    def __init__(self, model, trie: LeveledTrie, search_cfg: BeamSearchConfig, graphed: bool):
        self.model, self.trie, self.search_cfg = model, trie, search_cfg
        self.device = torch.device(model.device)
        self.tables = _trie_tables(trie, self.device)
        self.staged = StagedGraphs(self.device, self.name, graphed, model_axis=model_axis_of(model))

    @property
    def captures(self) -> bool:
        """On the card and `graphed`, unless the model has a live model axis
        (`core/graphs.capture_enabled`)."""
        return self.staged.captures

    @property
    def graphs(self) -> int:
        """CUDA graphs captured: one per key."""
        return self.staged.graphs

    @torch.no_grad()
    def __call__(self, batch: dict, arg) -> tuple[torch.Tensor, torch.Tensor]:
        with trace.step("search.call", self.device):
            key, static = self.stage(batch, arg)
            return self.staged.run(key, self.device_part, static)


class BeamSearch(_CompiledSearch):
    """`search(batch, behavior_emb_id) -> (codes, scores)`: the decoder-only
    search (`constrained_beam_search`'s arguments and results). An int
    behavior id is staged as the [B] array of that id, so the scalar and
    per-example modes share one key; `None` (the behavior-token decode) is
    a key of its own."""

    def stage(self, batch: dict, behavior_emb_id) -> tuple[tuple, dict]:
        arrays = {k: as_array(batch[k]) for k in PROMPT_KEYS if k in batch}
        if behavior_emb_id is not None:
            rows = arrays["input_ids"].shape[0]
            arrays["behavior_emb_id"] = np.array(np.broadcast_to(
                np.asarray(behavior_emb_id, np.int32), (rows,)))
        return self.staged.stage(arrays)

    @torch.no_grad()
    def device_part(self, static: dict) -> tuple[torch.Tensor, torch.Tensor]:
        batch = {k: t for k, t in static.items() if k != "behavior_emb_id"}
        return _search(self.model, batch, self.trie, self.tables,
                       static.get("behavior_emb_id"), self.search_cfg)


def make_beam_search_fn(model: QwenFamilyModel, trie: LeveledTrie,
                        search_cfg: BeamSearchConfig = BeamSearchConfig(),
                        graphed: bool = True) -> BeamSearch:
    """search(batch, behavior_emb_id) -> (codes, scores) bound to one model,
    trie and search config: JAX's jitted closure as a CUDA graph a key on
    the card (`graphed=False`: the same device part, eagerly)."""
    return BeamSearch(model, trie, search_cfg, graphed)


def _first_level(logits0: torch.Tensor, trie: LeveledTrie, allowed_tables, child_tables,
                 K: int):
    """(scores [B, K], codes [B, K, 1], trie nodes [B, K]) of level 0 from the
    trie root; beams past the level's codes are dead (score NEG)."""
    base0, size0 = trie.level_token_base[0], trie.level_sizes[0]
    logp = _level_logp(logits0[:, base0:base0 + size0], allowed_tables[0][0][None, :])
    k0 = min(K, size0)
    scores, codes0 = torch.topk(logp, k0, dim=-1)  # [B, k0]
    if k0 < K:  # more beams than level-0 codes: pad with dead beams
        scores = torch.nn.functional.pad(scores, (0, K - k0), value=NEG)
        codes0 = torch.nn.functional.pad(codes0, (0, K - k0))
    return scores, codes0[:, :, None], child_tables[0][0, codes0]


@torch.no_grad()
def constrained_beam_search_encdec(
    model: EncDecModel,
    batch: dict,
    trie: LeveledTrie,
    decoder_prefix,
    search_cfg: BeamSearchConfig = BeamSearchConfig(),
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam search of the enc-dec family (TIGER/PBATransformer), eagerly.

    `batch` holds the right-padded encoder `input_ids` and `attention_mask`
    [B, Se] (tensors or numpy arrays). `decoder_prefix` is the [P0] (or
    per-row [B, P0]) decoder input fed before the first item level,
    [decoder_start(, behavior_token)], as the reference seeds generation
    (ref test_SMB_decoder.py:188-195). Decoder tokens route by their
    absolute decoder position. Returns (codes [B, num_beams, L], fp32
    scores [B, num_beams])."""
    return EncDecBeamSearch(model, trie, search_cfg, graphed=False)(batch, decoder_prefix)


def _search_encdec(model: EncDecModel, batch: dict, trie: LeveledTrie, tables, prefix,
                   search_cfg: BeamSearchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """The device part of `constrained_beam_search_encdec` on the device
    tensors of `batch` (encoder `input_ids`, `attention_mask`), the trie's
    device `tables` and the [B, P0] int32 `prefix`."""
    cfg = model.cfg
    device = model.device
    L = trie.num_levels
    K = search_cfg.num_beams
    B = batch["input_ids"].shape[0]
    P0 = prefix.shape[1]
    cache_dtype = resolve_cache_dtype(search_cfg.cache_dtype, device)
    allowed_tables, child_tables = tables
    routing = lambda pos, rows: ((pos % cfg.num_positions) + 1)[None].expand(rows, -1)

    # prefill: the encoder, the decoder prefix, the encoder's cross k/v
    trace.mark("prefill", device)
    shape = (B, P0 + L, cfg.num_heads, cfg.d_kv)
    caches = [{"self": {"k": torch.zeros(shape, dtype=cache_dtype, device=device),
                        "v": torch.zeros(shape, dtype=cache_dtype, device=device)}}
              for _ in range(cfg.num_decoder_layers)]
    pos0 = torch.arange(P0, device=device)
    enc_rel = router_ops.rel_positions(batch["attention_mask"])
    enc_pos, enc_beh, _ = router_ops.route_tokens(
        batch["input_ids"], enc_rel, cfg.num_positions, cfg.behavior_base, cfg.num_behavior)
    pidx = routing(pos0, B)
    out = model(encoder_input_ids=batch["input_ids"],
                encoder_attention_mask=batch["attention_mask"], decoder_input_ids=prefix,
                enc_position_index=enc_pos, enc_behavior_index=enc_beh,
                dec_position_index=pidx, dec_behavior_index=torch.zeros_like(pidx),
                caches=caches, cache_index=0, dec_positions=pos0, logits_last_only=True,
                emit_cross_kv=True)
    # the cross k/v stay [B, Senc], shared by the beams; only the decoder's
    # self cache is per beam
    cross_kv = [c["cross"] for c in out["caches"]]
    caches = [{"self": {k: v.repeat_interleave(K, dim=0) for k, v in c["self"].items()}}
              for c in out["caches"]]
    trace.mark("decode", device)
    scores, gen_codes, nodes = _first_level(out["logits"][:, 0, :], trie, allowed_tables,
                                            child_tables, K)

    for step in range(1, L):
        prev = gen_codes[:, :, step - 1].reshape(B * K)
        tok = (prev + trie.level_token_base[step - 1]).to(torch.int32)[:, None]
        dpos = P0 + step - 1
        dpos_t = torch.full((1,), dpos, dtype=torch.int64, device=device)
        pidx = routing(dpos_t, B * K)
        out = model(cross_kv=cross_kv, encoder_attention_mask=batch["attention_mask"],
                    decoder_input_ids=tok, dec_position_index=pidx,
                    dec_behavior_index=torch.zeros_like(pidx), caches=caches,
                    cache_index=dpos, dec_positions=dpos_t, logits_last_only=True)
        caches = out["caches"]
        logits = out["logits"][:, 0, :]

        base, size = trie.level_token_base[step], trie.level_sizes[step]
        flat_nodes = nodes.reshape(B * K)
        allowed = allowed_tables[step][flat_nodes.clamp(min=0)] & (flat_nodes >= 0)[:, None]
        logp = _level_logp(logits[:, base:base + size], allowed)
        total = scores[:, :, None] + logp.reshape(B, K, size)
        scores, idx = torch.topk(total.reshape(B, K * size), K, dim=-1)
        parent = torch.div(idx, size, rounding_mode="floor")
        code = idx % size
        gen_codes = torch.cat([torch.gather(gen_codes, 1, parent[:, :, None].expand(-1, -1, step)),
                               code[:, :, None]], dim=2)
        parent_nodes = torch.gather(nodes, 1, parent).reshape(B * K)
        nodes = child_tables[step][parent_nodes.clamp(min=0), code.reshape(B * K)].reshape(B, K)
        # the decoder-prefix positions [0, P0) are beam-invariant: move only
        # the generated slice by parent beam
        flat_parent = (torch.arange(B, device=device)[:, None] * K + parent).reshape(B * K)

        def move(x):
            x = x.clone()
            x[:, P0:P0 + step] = x[flat_parent, P0:P0 + step]
            return x

        caches = [{"self": {k: move(v) for k, v in c["self"].items()}} for c in caches]

    trace.mark(trace.UNMARKED, device)
    return gen_codes, scores


class EncDecBeamSearch(_CompiledSearch):
    """`search(batch, decoder_prefix) -> (codes, scores)`: the enc-dec
    search (`constrained_beam_search_encdec`'s arguments and results); a
    [P0] prefix is staged as its [B, P0] rows."""

    name = "enc-dec beam search"

    def stage(self, batch: dict, decoder_prefix) -> tuple[tuple, dict]:
        arrays = {k: as_array(batch[k]) for k in ("input_ids", "attention_mask")}
        prefix = np.asarray(decoder_prefix, np.int32)
        if prefix.ndim == 1:
            prefix = np.array(np.broadcast_to(prefix, (arrays["input_ids"].shape[0],
                                                       prefix.shape[0])))
        return self.staged.stage({**arrays, "decoder_prefix": prefix})

    @torch.no_grad()
    def device_part(self, static: dict) -> tuple[torch.Tensor, torch.Tensor]:
        batch = {k: t for k, t in static.items() if k != "decoder_prefix"}
        return _search_encdec(self.model, batch, self.trie, self.tables,
                              static["decoder_prefix"], self.search_cfg)


def make_beam_search_encdec_fn(model: EncDecModel, trie: LeveledTrie,
                               search_cfg: BeamSearchConfig = BeamSearchConfig(),
                               graphed: bool = True) -> EncDecBeamSearch:
    """search(batch, decoder_prefix) -> (codes, scores) bound to one
    enc-dec model, trie and search config, compiled as `make_beam_search_fn`."""
    return EncDecBeamSearch(model, trie, search_cfg, graphed)
