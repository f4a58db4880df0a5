"""test_SMB_decoder — trie-constrained beam-search evaluation.

The port's counterpart of `gamer_tpu/tasks/test_smb_decoder.py`:
per-behavior filtered eval views, behavior token and action level appended
to the prompt (ref :113-119; an enc-dec model gets the behavior token as the
second token of its decoder prefix, ref :188-195), beam search returning all
beams (ref :122-195), hit/recall/ndcg with session-target normalization,
duplicate-vs-history ratio (ref :217-223), merged-behavior weighted metrics
(ref :287-304), collision reporting (ref :66-88), and a --valid_loss mode
(ref :306-322). Every behavior's rows go through one mixed-behavior search
per chunk of `--test_batch_size` rows, the last chunk padded to the batch
with its first row (ref :168-170), so the compiled search (`decode/beam.py`,
a CUDA graph on the card) captures once. Under a
process group (`core/distributed.py`) each process searches every
process_count-th row through its own captured search (the search holds no
collective), the fixed-shape metric sums are added up with one all-reduce
(ref :232-255 gathers pickled lists), and process 0 writes the results.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gamer_tpu_torch.core import distributed, trace
from gamer_tpu_torch.core.graphs import model_axis_of
from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.batching import (
    DecodeBatcher, DecoderBatcher, EncDecBatcher, iterate_batches)
from gamer_tpu_torch.data.loading_smb import load_smb_test, load_smb_train
from gamer_tpu_torch.data.smb import filter_examples_by_behavior
from gamer_tpu_torch.data.vocab import EOS_ID
from gamer_tpu_torch.decode.beam import (
    BeamSearchConfig, make_beam_search_encdec_fn, make_beam_search_fn)
from gamer_tpu_torch.decode.trie import LeveledTrie
from gamer_tpu_torch.evaluation.ranking import (
    hits_matrix, merge_behavior_metrics, metrics_from_hits)
from gamer_tpu_torch.models.generative.encdec_utils import encdec_loss_fn
from gamer_tpu_torch.models.generative.qwen_family import prepare_train_inputs
from gamer_tpu_torch.modules.losses import causal_lm_loss
from gamer_tpu_torch.tasks.base import Task, add_dataset_args, add_global_args, task_device
from gamer_tpu_torch.tasks.test_decoder import load_generative_model, strip_behavior
from gamer_tpu_torch.train.loop import EvalStep

logger = get_logger("tasks.test_smb_decoder")


@TASKS.register("test_SMB_decoder")
class TestSMBDecoder(Task):
    name = "test_SMB_decoder"
    help = "Evaluate a SMB decoder with constrained beam search."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        g = parser.add_argument_group("test")
        g.add_argument("--ckpt_path", type=str, default="./checkpoint")
        g.add_argument("--ckpt_tag", type=str, default="best",
                       help="best | last | epoch_<N>")
        g.add_argument("--results_file", type=str, default="./results/test.json")
        g.add_argument("--test_batch_size", type=int, default=128)
        g.add_argument("--num_beams", type=int, default=20)
        g.add_argument("--metrics", type=str,
                       default="hit@1,hit@5,hit@10,recall@1,recall@5,recall@10,ndcg@5,ndcg@10")
        g.add_argument("--test_task", type=str, default="smb_explicit")
        g.add_argument("--behaviors", type=str, nargs="+", default=None)
        g.add_argument("--valid_loss", action="store_true")
        g.add_argument("--cache_dtype", type=str, default="auto",
                       choices=["auto", "float32", "bfloat16"],
                       help="auto = bfloat16 on CUDA, float32 on the CPU")
        return parser

    def run(self, *, dataset, data_path, index_file, max_his_len, test_task,
            ckpt_path, ckpt_tag, results_file, test_batch_size, num_beams,
            metrics, behaviors, valid_loss, cache_dtype="auto", device="cuda", **_):
        model, cfg, vocab, self.family = load_generative_model(ckpt_path, ckpt_tag,
                                                               task_device(device))
        if valid_loss:
            return self._valid_loss(model, cfg, dataset, data_path, max_his_len, index_file,
                                    results_file)
        data = load_smb_test(dataset, data_path, max_his_len, index_file, test_task)
        corpus = data.corpus
        metric_list = metrics.split(",")
        behaviors = behaviors or list(corpus.behavior_names)
        # candidates: pure item code rows (the behavior token is in the prompt
        # or the decoder prefix), one trie for every behavior, collision rows
        # deduplicated (ref get_all_items set semantics)
        trie = LeveledTrie.from_token_rows(corpus.item_codes[~corpus.collision_rows], vocab)
        search = BeamSearchConfig(num_beams=num_beams, cache_dtype=cache_dtype)
        self._device = model.device
        if self.family == "encdec":
            self._batcher = EncDecBatcher.for_examples(data.test, eos_id=EOS_ID)
            self._search = make_beam_search_encdec_fn(model, trie, search)
            self._start = cfg.decoder_start_token_id
        else:
            self._batcher = DecodeBatcher.for_examples(data.test, extra=1)
            self._search = make_beam_search_fn(model, trie, search)

        collision = self._collision_report(corpus, data.test)
        # ONE mixed-behavior example stream -> one batched search per chunk
        # (the reference loops whole eval passes per behavior, ref :362-380)
        rows: list[tuple[str, int, object]] = []
        for behavior in behaviors:
            b_idx = corpus.behavior_names.index(behavior)
            for ex in filter_examples_by_behavior(data.test, b_idx, corpus.target_behavior_idx):
                rows.append((behavior, b_idx, ex))
        acc = self._eval_mixed(corpus, vocab, trie, rows, behaviors, test_batch_size,
                               metric_list)
        logger.info("the search captured %d CUDA graphs; graphs by owner: %s",
                    self._search.graphs, trace.graph_summary() or "none")
        per_behavior: dict[str, dict] = {}
        counts: dict[str, int] = {}
        dup_ratios: dict[str, float] = {}
        for behavior in behaviors:
            a = acc[behavior]
            if not a["count"]:
                continue
            per_behavior[behavior] = a["totals"]
            counts[behavior] = a["count"]
            dup_ratios[behavior] = a["dup_sum"] / max(a["dup_n"], 1)
            logger.info("behavior %s (%d examples): %s", behavior, a["count"],
                        {k: round(v / a["count"], 4) for k, v in a["totals"].items()})

        merged = merge_behavior_metrics(per_behavior, counts)
        results = {
            "per_behavior": {
                b: {k: v / counts[b] for k, v in m.items()} for b, m in per_behavior.items()
            },
            "merged": merged,
            "counts": counts,
            "duplicate_ratio": dup_ratios,
            "collision": collision,
            "config": {"test_task": test_task, "num_beams": num_beams,
                       "dataset": dataset, "ckpt": ckpt_path},
        }
        if distributed.is_main_process():
            os.makedirs(os.path.dirname(results_file) or ".", exist_ok=True)
            with open(results_file, "w") as f:
                json.dump(results, f, indent=2)
        logger.info("merged: %s", {k: round(v, 4) for k, v in merged.items()})
        return results

    # ------------------------------------------------------------------ eval

    def _eval_mixed(self, corpus, vocab, trie, rows, behaviors, batch_size, metric_list):
        """Evaluate a mixed-behavior row stream ((behavior, b_idx, example)
        tuples) in one search a chunk; returns per-behavior accumulators
        {totals, count, dup_sum, dup_n}. Needs `self._batcher`, `self._search`
        and, under a process group, `self._device` (set by `run`; for an
        enc-dec model, `self.family` "encdec" and `self._start`, the decoder
        start token)."""
        L = trie.num_levels
        n_proc = distributed.process_count()
        if n_proc > 1:  # stride rows over processes; sums merged at the end
            rows = rows[distributed.process_index()::n_proc]
        acc = {b: {"totals": {m: 0.0 for m in metric_list}, "count": 0,
                   "dup_sum": 0.0, "dup_n": 0} for b in behaviors}
        for batch_rows in _chunks(rows, batch_size):
            n_real = len(batch_rows)
            if n_real < batch_size:  # pad to the batch with its first row: one graph key
                batch_rows = list(batch_rows) + [batch_rows[0]] * (batch_size - n_real)
            btoks = np.asarray([vocab.behavior_token(r[0]) for r in batch_rows], np.int32)
            examples = [r[2] for r in batch_rows]
            if getattr(self, "family", "decoder_only") == "encdec":
                # the decoder starts from [start, behavior token] a row (ref :188-195)
                prefix = np.stack([np.full_like(btoks, self._start), btoks], axis=1)
                codes, _ = self._search(self._batcher.collate(examples), prefix)
            else:
                levels = np.asarray([int(corpus.behavior_levels[r[1]]) for r in batch_rows],
                                    np.int32)
                beh_emb_ids = np.asarray([r[1] + 1 for r in batch_rows], np.int32)
                batch = self._batcher.collate(examples, append_behavior_token=btoks,
                                              append_action_level=levels)
                codes, _ = self._search(batch, beh_emb_ids)
            codes = codes.cpu().numpy()[:n_real]  # [B, K, L] 0-based level codes
            batch_rows = batch_rows[:n_real]
            # targets: strip the behavior token column -> per-level codes
            target_codes = [vocab.decode_tokens(strip_behavior(r[2].targets, L, vocab))
                            for r in batch_rows]
            hits, n_targets = hits_matrix(codes, target_codes)
            row_behaviors = np.asarray([r[0] for r in batch_rows])
            for behavior in set(row_behaviors.tolist()):
                mask = row_behaviors == behavior
                bm = metrics_from_hits(hits[mask], n_targets[mask], metric_list)
                a = acc[behavior]
                for k, v in bm.items():
                    a["totals"][k] += v
                a["count"] += int(mask.sum())
            # duplicate-vs-history ratio (ref :217-223)
            for i, (behavior, _, ex) in enumerate(batch_rows):
                hist = {tuple(r) for r in vocab.decode_tokens(
                    corpus.item_codes[corpus.item_rows(ex.history_item_ids)]).tolist()}
                gen = {tuple(r) for r in codes[i].tolist()}
                acc[behavior]["dup_sum"] += len(gen & hist) / max(len(gen), 1)
                acc[behavior]["dup_n"] += 1
        if distributed.is_initialized():
            acc = _sum_over_processes(acc, behaviors, metric_list, self._device)
        return acc

    def _valid_loss(self, model, cfg, dataset, data_path, max_his_len, index_file,
                    results_file):
        """The training objective on the valid split (ref :306-322), through
        the one-hot route (the enc-dec CE for an enc-dec model), batches of 32
        weighted by their real rows; each batch through the eval step
        (`train/loop.EvalStep`, compiled on the card as JAX jits it), the
        sums in float64 as the reference sums on the host."""
        tdata = load_smb_train(dataset, data_path, max_his_len, index_file, "smb_explicit")
        if getattr(self, "family", "decoder_only") == "encdec":
            batcher = EncDecBatcher.for_examples(tdata.valid, eos_id=EOS_ID)
            loss_of = encdec_loss_fn(model, cfg, deterministic=True)
        else:
            batcher = DecoderBatcher.for_examples(
                tdata.valid, behavior_token_ids=tdata.corpus.vocab.behavior_token_ids)

            def loss_of(batch):
                out = model(**prepare_train_inputs(cfg, batch), route_mode="onehot")
                return causal_lm_loss(out["logits"], batch["labels"], cfg.temperature,
                                      batch.get("row_valid")), {}
        step = EvalStep(loss_of, model.device, dtype=torch.float64, by_rows=True,
                        model_axis=model_axis_of(model))
        for batch in iterate_batches(tdata.valid, 32, batcher.collate):
            step.add(batch)
        total, n = step.sums.tolist()
        loss = total / max(n, 1)
        logger.info("valid loss: %.4f (%d CUDA graphs)", loss, step.graphs)
        results = {"valid_loss": loss}
        os.makedirs(os.path.dirname(results_file) or ".", exist_ok=True)
        with open(results_file, "w") as f:
            json.dump(results, f, indent=2)
        return results

    @staticmethod
    def _collision_report(corpus, examples):
        """ref test_SMB_decoder.py:66-88."""
        n_coll_items = int(corpus.collision_rows.sum())
        coll_rows = {tuple(r) for r in corpus.item_codes[corpus.collision_rows].tolist()}
        coll_samples = 0
        for ex in examples:
            L = corpus.sole_item_len
            tgt = strip_behavior(ex.targets, L, corpus.vocab)
            for row in tgt.reshape(-1, L).tolist():
                if tuple(row) in coll_rows:
                    coll_samples += 1
        return {"total": len(examples), "collision_items": n_coll_items,
                "collision_samples": coll_samples,
                "collision_ratio": coll_samples / max(len(examples), 1)}


def _sum_over_processes(acc: dict, behaviors, metric_list, device) -> dict:
    """`_eval_mixed`'s per-behavior accumulators summed over the process
    group: one float64 [behaviors, metrics + 3] all-reduce."""
    M = len(metric_list)
    vec = torch.zeros((len(behaviors), M + 3), dtype=torch.float64)
    for j, b in enumerate(behaviors):
        a = acc[b]
        vec[j, :M] = torch.tensor([a["totals"][m] for m in metric_list], dtype=torch.float64)
        vec[j, M:] = torch.tensor([a["count"], a["dup_sum"], a["dup_n"]], dtype=torch.float64)
    summed = distributed.all_reduce_sum(vec.to(device)).cpu()
    return {b: {"totals": {m: float(summed[j, i]) for i, m in enumerate(metric_list)},
                "count": int(summed[j, M]), "dup_sum": float(summed[j, M + 1]),
                "dup_n": int(summed[j, M + 2])} for j, b in enumerate(behaviors)}


def _chunks(seq, n):
    for i in range(0, len(seq), n):
        yield seq[i:i + n]
