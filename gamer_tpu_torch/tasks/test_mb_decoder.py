"""test_MB_decoder — multi-behavior eval over three evaluation modes.

The port's counterpart of `gamer_tpu/tasks/test_mb_decoder.py` (ref:
SeqRec/tasks/test_MB_decoder.py:218-232; enum ref MB_dataset.py:12-16):

  TARGET_BEHAVIOR   target-behavior examples; the prompt ends in the target
                    behavior token (and its action level), searched with its
                    embedding id over the all-items trie
  BEHAVIOR_SPECIFIC all examples; each prompt ends in its row's true behavior
                    token, searched with per-row embedding ids
  BEHAVIOR_ITEM     all examples; the behavior token and the item decoded
                    jointly over the behavior+item trie (`behavior_emb_id=None`:
                    per-beam behavior ids from the decoded level-0 token, see
                    decode/beam.py)

`--filter` drops the examples whose target code row collides. The enc-dec
family (TIGER, PBATransformer) runs the first two modes, with the behavior
token as the second token of the decoder prefix, as in JAX; BEHAVIOR_ITEM is
decoder-only. One process.
"""

from __future__ import annotations

import json
import os

import numpy as np

from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.batching import DecodeBatcher, EncDecBatcher
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.seq import EvaluationType, MBExampleBuilder, SeqCorpus, filter_mb_examples
from gamer_tpu_torch.data.vocab import EOS_ID
from gamer_tpu_torch.decode.beam import (
    BeamSearchConfig, make_beam_search_encdec_fn, make_beam_search_fn)
from gamer_tpu_torch.decode.trie import LeveledTrie
from gamer_tpu_torch.models.generative.encdec import EncDecModel
from gamer_tpu_torch.tasks.base import Task, add_dataset_args, add_global_args, task_device
from gamer_tpu_torch.tasks.test_decoder import (
    beam_eval, load_generative_model, run_seq_eval, strip_behavior)
from gamer_tpu_torch.tasks.train_mb_decoder import layout_for_mb_task

logger = get_logger("tasks.test_mb_decoder")


@TASKS.register("test_MB_decoder")
class TestMBDecoder(Task):
    name = "test_MB_decoder"
    help = "Evaluate a multi-behavior decoder (3 evaluation modes)."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        g = parser.add_argument_group("test")
        g.add_argument("--ckpt_path", type=str, default="./checkpoint")
        g.add_argument("--ckpt_tag", type=str, default="best")
        g.add_argument("--results_file", type=str, default="./results/test_mb.json")
        g.add_argument("--test_batch_size", type=int, default=128)
        g.add_argument("--num_beams", type=int, default=20)
        g.add_argument("--metrics", type=str,
                       default="hit@1,hit@5,hit@10,recall@1,recall@5,recall@10,ndcg@5,ndcg@10")
        g.add_argument("--test_task", type=str, default="mb_explicit")
        g.add_argument("--filter", action="store_true",
                       help="drop collision-target samples (ref :66-94)")
        g.add_argument("--cache_dtype", type=str, default="auto",
                       choices=["auto", "float32", "bfloat16"],
                       help="auto = bfloat16 on CUDA, float32 on the CPU")
        return parser

    def run(self, *, dataset, data_path, index_file, max_his_len, test_task,
            ckpt_path, ckpt_tag, results_file, test_batch_size, num_beams,
            metrics, filter, cache_dtype="auto", device="cuda", **_):
        model, _, vocab, family = load_generative_model(ckpt_path, ckpt_tag,
                                                        task_device(device))
        corpus = SeqCorpus(DataFiles(data_path, dataset), index_file, multi_behavior=True)
        layout = layout_for_mb_task(test_task)
        examples = MBExampleBuilder(corpus, layout, max_his_len).build("test")
        metric_list = metrics.split(",")

        if filter:
            coll_rows = {tuple(r) for r in corpus.item_codes[corpus.collision_rows].tolist()}
            item_row = lambda ex: tuple(
                strip_behavior(ex.targets, corpus.sole_item_len, vocab)[0].tolist())
            kept = [ex for ex in examples if item_row(ex) not in coll_rows]
            logger.info("filtered collision targets: %d -> %d", len(examples), len(kept))
            examples = kept

        item_trie = LeveledTrie.from_token_rows(corpus.item_codes[~corpus.collision_rows], vocab)
        search = BeamSearchConfig(num_beams=num_beams, cache_dtype=cache_dtype)
        results = []
        tgt = corpus.target_behavior_idx
        totals, count = run_seq_eval(
            model, vocab, corpus, filter_mb_examples(examples, tgt), num_beams, test_batch_size,
            metric_list, cache_dtype, behavior_token=vocab.behavior_token(corpus.target_behavior),
            action_level=int(corpus.behavior_levels[tgt]), behavior_emb_id=tgt + 1,
            trie=item_trie)
        results.append({"eval_type": EvaluationType.TARGET_BEHAVIOR.value,
                        **{m: v / max(count, 1) for m, v in totals.items()}})
        totals, count = self._behavior_specific(model, vocab, corpus, examples, item_trie,
                                                search, test_batch_size, metric_list)
        results.append({"eval_type": EvaluationType.BEHAVIOR_SPECIFIC.value,
                        **{m: v / max(count, 1) for m, v in totals.items()}})
        if family != "encdec":  # the joint behavior + item decode is decoder-only
            totals, count = self._behavior_item(model, vocab, corpus, examples, search,
                                                test_batch_size, metric_list)
            results.append({"eval_type": EvaluationType.BEHAVIOR_ITEM.value,
                            **{m: v / max(count, 1) for m, v in totals.items()}})

        os.makedirs(os.path.dirname(results_file) or ".", exist_ok=True)
        with open(results_file, "w") as f:
            json.dump(results, f, indent=2)
        for r in results:
            logger.info("%s: %s", r["eval_type"],
                        {k: round(v, 4) for k, v in r.items() if k != "eval_type"})
        return results

    @staticmethod
    def _behavior_specific(model, vocab, corpus, examples, trie, search, batch_size,
                           metric_list):
        """(metric sums, count): each row's prompt ends in its true behavior
        token and action level, and the search takes per-row embedding ids;
        for an enc-dec model each row's decoder prefix is [decoder_start,
        behavior token]."""
        encdec = isinstance(model, EncDecModel)
        if encdec:
            search_fn = make_beam_search_encdec_fn(model, trie, search)
            batcher = EncDecBatcher.for_examples(examples, eos_id=EOS_ID)
        else:
            search_fn = make_beam_search_fn(model, trie, search)
            batcher = DecodeBatcher.for_examples(examples, extra=1)

        def batch_of(chunk):
            behs = np.array([int(ex.target_behaviors[0]) for ex in chunk])
            btoks = np.array([vocab.behavior_token(corpus.behavior_names[b]) for b in behs])
            if encdec:
                start = np.full_like(btoks, model.cfg.decoder_start_token_id)
                return batcher.collate(chunk), np.stack([start, btoks], axis=1)
            batch = batcher.collate(chunk, append_behavior_token=btoks,
                                    append_action_level=corpus.behavior_levels[behs])
            return batch, behs + 1

        targets = lambda ex: vocab.decode_tokens(
            strip_behavior(ex.targets, corpus.sole_item_len, vocab))
        return beam_eval(search_fn, examples, batch_size, metric_list, batch_of, targets)

    @staticmethod
    def _behavior_item(model, vocab, corpus, examples, search, batch_size, metric_list):
        """(metric sums, count) of the joint behavior + item decode over the
        combined trie: level 0 is the behavior token (codes 0..n_behaviors-1),
        then the item levels."""
        item_codes = corpus.item_codes[~corpus.collision_rows]
        n_items, L = item_codes.shape
        n_beh = len(corpus.behavior_names)
        combined = np.zeros((n_items * n_beh, L + 1), dtype=np.int64)
        for b in range(n_beh):
            rows = slice(b * n_items, (b + 1) * n_items)
            combined[rows, 0] = b
            combined[rows, 1:] = vocab.decode_tokens(item_codes)
        sizes = [n_beh] + list(vocab.level_sizes[:L])
        bases = [vocab.behavior_base] + [vocab.code_token(lvl, 0) for lvl in range(L)]
        trie = LeveledTrie.build(combined, sizes, bases)
        search_fn = make_beam_search_fn(model, trie, search)
        batcher = DecodeBatcher.for_examples(examples, extra=0)

        def targets(ex):  # the behavior as level 0, then the item's codes
            item = vocab.decode_tokens(strip_behavior(ex.targets, corpus.sole_item_len, vocab))
            return np.concatenate([np.asarray(ex.target_behaviors)[:, None], item], axis=1)

        return beam_eval(search_fn, examples, batch_size, metric_list,
                         lambda chunk: (batcher.collate(chunk), None), targets)

