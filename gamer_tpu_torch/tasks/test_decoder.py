"""test_decoder — single-behavior constrained beam-search eval.

The port's counterpart of `gamer_tpu/tasks/test_decoder.py` (ref:
SeqRec/tasks/test_decoder.py): the all-items trie, beam search,
hit/recall/ndcg over the leave-one-out target, collision accounting.
`load_generative_model` (which `test_SMB_decoder` and `test_MB_decoder` use
too) loads either family from its `config.json` ("family"), and
`run_seq_eval` searches with the decoder-only search (the prompt ends in the
behavior token) or, for TIGER and PBATransformer, the enc-dec one (the
history is the encoder input, the decoder prefix [decoder_start(,
behavior_token)]), as in the JAX package; one process.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gamer_tpu_torch.core.checkpoint import CheckpointManager
from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.batching import DecodeBatcher, EncDecBatcher
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.seq import SeqCorpus, SeqExampleBuilder
from gamer_tpu_torch.data.vocab import SemanticVocab
from gamer_tpu_torch.decode.beam import (
    BeamSearchConfig, make_beam_search_encdec_fn, make_beam_search_fn)
from gamer_tpu_torch.decode.trie import LeveledTrie
from gamer_tpu_torch.evaluation.ranking import hits_matrix, metrics_from_hits
from gamer_tpu_torch.models.generative.encdec import EncDecConfig, EncDecModel
from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig, QwenFamilyModel
from gamer_tpu_torch.tasks.base import Task, add_dataset_args, add_global_args, task_device

logger = get_logger("tasks.test_decoder")


def load_generative_model(ckpt_path: str, ckpt_tag: str = "best", device=None):
    """(model, cfg, vocab, family) of a training output directory: its
    config.json, the checkpoint `ckpt_tag` and vocab.json."""
    with open(os.path.join(ckpt_path, "config.json")) as f:
        raw = json.load(f)
    family = raw.get("family", "decoder_only")
    if family == "encdec":
        cfg = EncDecConfig.from_dict(raw)
        model = EncDecModel(cfg, device=device)
    else:
        cfg = QwenFamilyConfig.from_dict(raw)
        model = QwenFamilyModel(cfg, device=device)
    model.load_state_dict(CheckpointManager(ckpt_path).restore(ckpt_tag, map_location=model.device))
    vocab = SemanticVocab.load(os.path.join(ckpt_path, "vocab.json"))
    return model, cfg, vocab, family


def strip_behavior(targets: np.ndarray, sole_item_len: int, vocab) -> np.ndarray:
    """Target blocks without their behavior-token column (first or last) ->
    [n, sole_item_len] item tokens."""
    if targets.shape[1] == sole_item_len:
        return targets
    first = targets[:, 0]
    if np.all((first >= vocab.behavior_base) & (first < vocab.code_base)):
        return targets[:, 1:]
    return targets[:, :-1]


def beam_eval(search_fn, examples, batch_size: int, metric_list, batch_of, targets):
    """(metric sums, count) of a beam search over `examples` in chunks of
    `batch_size`, the last padded with its first row (whose results are
    dropped): `batch_of(chunk)` gives a chunk's (batch, behavior_emb_id),
    `targets(example)` an example's target code rows."""
    totals = {m: 0.0 for m in metric_list}
    count = 0
    for s in range(0, len(examples), batch_size):
        chunk = examples[s:s + batch_size]
        n_real = len(chunk)
        if n_real < batch_size:
            chunk = list(chunk) + [chunk[0]] * (batch_size - n_real)
        codes, _ = search_fn(*batch_of(chunk))
        codes = codes.cpu().numpy()[:n_real]
        hits, n_t = hits_matrix(codes, [targets(ex) for ex in chunk[:n_real]])
        for k, v in metrics_from_hits(hits, n_t, metric_list).items():
            totals[k] += v
        count += n_real
    return totals, count


def run_seq_eval(model, vocab, corpus, examples, num_beams, batch_size, metric_list,
                 cache_dtype="auto", behavior_token=None, action_level=None,
                 behavior_emb_id=0, trie=None):
    """Beam-search eval over single-target examples; returns (metric sums,
    count) (the caller normalizes). Decoder-only models: `behavior_token` /
    `action_level` are appended to every prompt, `behavior_emb_id` seeds the
    search. Enc-dec models: the decoder prefix is [decoder_start(,
    behavior_token)]. The trie defaults to every item without a colliding
    code row."""
    if trie is None:
        trie = LeveledTrie.from_token_rows(corpus.item_codes[~corpus.collision_rows], vocab)
    search = BeamSearchConfig(num_beams=num_beams, cache_dtype=cache_dtype)
    if isinstance(model, EncDecModel):
        prefix = [model.cfg.decoder_start_token_id]
        if behavior_token is not None:
            prefix.append(behavior_token)
        search_fn = make_beam_search_encdec_fn(model, trie, search)
        batcher = EncDecBatcher.for_examples(examples)
        batch_of = lambda chunk: (batcher.collate(chunk), np.asarray(prefix, np.int32))
    else:
        search_fn = make_beam_search_fn(model, trie, search)
        batcher = DecodeBatcher.for_examples(examples, extra=1 if behavior_token is not None else 0)
        batch_of = lambda chunk: (batcher.collate(chunk, append_behavior_token=behavior_token,
                                                  append_action_level=action_level),
                                  behavior_emb_id)
    return beam_eval(
        search_fn, examples, batch_size, metric_list, batch_of,
        lambda ex: vocab.decode_tokens(strip_behavior(ex.targets, trie.num_levels, vocab)))


def filter_collision_targets(corpus, examples, apply_filter: bool):
    """Collision accounting over test targets (ref test_decoder.py:65-90):
    a sample 'collides' when its target's semantic-id row is shared by more
    than one item. With apply_filter, those samples are dropped."""
    uniq, counts = np.unique(corpus.item_codes, axis=0, return_counts=True)
    colliding = {tuple(int(v) for v in r) for r, c in zip(uniq, counts) if c > 1}
    is_coll = [tuple(int(v) for v in strip_behavior(ex.targets, corpus.sole_item_len,
                                                    corpus.vocab)[0]) in colliding
               for ex in examples]
    info = {"total": len(examples), "collision_items": len(colliding),
            "collision_samples": int(sum(is_coll)),
            "collision_ratio": float(sum(is_coll)) / max(len(examples), 1)}
    if apply_filter:
        examples = [ex for ex, c in zip(examples, is_coll) if not c]
        logger.info("filtered collision targets: %d -> %d examples",
                    info["total"], len(examples))
    return examples, info


def seq_inter_type(task: str | None, inter_type: str | None) -> str | None:
    """The interaction-file variant: --inter_type, else the `<type>` of a
    'seqrec_<type>' task (ref loading.py:17-41)."""
    t = (task or "seqrec").split(",")[0].lower()
    if t.startswith("seqrec_") and inter_type is None:
        return t[len("seqrec_"):]
    return inter_type


@TASKS.register("test_decoder")
class TestDecoder(Task):
    name = "test_decoder"
    help = "Evaluate a single-behavior generative decoder."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        g = parser.add_argument_group("test")
        g.add_argument("--inter_type", type=str, default=None)
        g.add_argument("--test_task", type=str, default="SeqRec",
                       help="'SeqRec' or 'seqrec_<type>' (selects the "
                            "interaction-file variant, ref test_decoder.py:58)")
        g.add_argument("--filter", action="store_true",
                       help="drop test samples whose target semantic id "
                            "collides (ref test_decoder.py:65-90)")
        g.add_argument("--ckpt_path", type=str, default="./checkpoint")
        g.add_argument("--ckpt_tag", type=str, default="best")
        g.add_argument("--results_file", type=str, default="./results/test_decoder.json")
        g.add_argument("--test_batch_size", type=int, default=128)
        g.add_argument("--num_beams", type=int, default=20)
        g.add_argument("--metrics", type=str,
                       default="hit@1,hit@5,hit@10,recall@1,recall@5,recall@10,ndcg@5,ndcg@10")
        g.add_argument("--cache_dtype", type=str, default="auto",
                       choices=["auto", "float32", "bfloat16"],
                       help="auto = bfloat16 on CUDA, float32 on the CPU")
        return parser

    def run(self, *, dataset, data_path, index_file, max_his_len, inter_type,
            ckpt_path, ckpt_tag, results_file, test_batch_size, num_beams,
            metrics, cache_dtype="auto", test_task="SeqRec", filter=False,
            device="cuda", **_):
        inter_type = seq_inter_type(test_task, inter_type)
        model, _, vocab, _ = load_generative_model(ckpt_path, ckpt_tag, task_device(device))
        corpus = SeqCorpus(DataFiles(data_path, dataset), index_file,
                           multi_behavior=False, inter_type=inter_type)
        examples = SeqExampleBuilder(corpus, max_his_len).build("test")
        examples, collision_info = filter_collision_targets(corpus, examples, filter)
        metric_list = metrics.split(",")
        totals, count = run_seq_eval(model, vocab, corpus, examples, num_beams, test_batch_size,
                                     metric_list, cache_dtype)
        results = {m: v / max(count, 1) for m, v in totals.items()}
        out = {"metrics": results, "count": count,
               "collision_info": collision_info,
               "config": {"dataset": dataset, "num_beams": num_beams, "ckpt": ckpt_path}}
        os.makedirs(os.path.dirname(results_file) or ".", exist_ok=True)
        with open(results_file, "w") as f:
            json.dump(out, f, indent=2)
        logger.info("metrics: %s", {k: round(v, 4) for k, v in results.items()})
        return out
