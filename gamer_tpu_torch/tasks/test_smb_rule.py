"""test_SMB_rule — rule-based repeat-history baseline.

The port's copy of `gamer_tpu/tasks/test_smb_rule.py`.

Predicts the last-N (optionally unique) history items, most recent first, as
the ranked list (ref: SeqRec/tasks/test_SMB_rule.py:84-130). Serves as the
sanity floor every trained model must beat (SURVEY.md section 4).
"""

from __future__ import annotations

import json
import os

import numpy as np

from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.core.registry import TASKS
from gamer_tpu_torch.data.loading_smb import load_smb_test
from gamer_tpu_torch.evaluation.ranking import hits_matrix, metrics_from_hits
from gamer_tpu_torch.tasks.base import Task, add_dataset_args, add_global_args, task_device

logger = get_logger("tasks.test_smb_rule")


@TASKS.register("test_SMB_rule")
class TestSMBRule(Task):
    name = "test_SMB_rule"
    help = "Rule-based repeat-history baseline evaluation."

    @classmethod
    def add_args(cls, parser):
        add_global_args(parser)
        add_dataset_args(parser)
        g = parser.add_argument_group("test")
        g.add_argument("--results_file", type=str, default="./results/rule.json")
        g.add_argument("--num_items", type=int, default=20,
                       help="ranked-list length (the num_beams analog)")
        g.add_argument("--unique", action="store_true",
                       help="deduplicate history before ranking")
        g.add_argument("--metrics", type=str,
                       default="hit@1,hit@5,hit@10,recall@1,recall@5,recall@10,ndcg@5,ndcg@10")
        g.add_argument("--test_task", type=str, default="smb_explicit")
        return parser

    def run(self, *, dataset, data_path, index_file, max_his_len, test_task,
            results_file, num_items, unique, metrics, device="cuda", **_):
        task_device(device)  # host-side numpy, but the CLI's device rule holds for every task
        data = load_smb_test(dataset, data_path, max_his_len, index_file, test_task)
        corpus = data.corpus
        metric_list = metrics.split(",")
        L = corpus.sole_item_len

        # per-(example, behavior) evaluation over the session targets
        behavior_results: dict[str, dict[str, float]] = {}
        counts: dict[str, int] = {}
        for ex in data.test:
            hist_rows = corpus.item_codes[corpus.item_rows(ex.history_item_ids)]
            ranked = hist_rows[::-1]  # most recent first
            if unique:
                _, first = np.unique(ranked, axis=0, return_index=True)
                ranked = ranked[np.sort(first)]
            ranked = ranked[:num_items]
            if len(ranked) < num_items:  # pad with an impossible row
                pad = np.full((num_items - len(ranked), L), -1, ranked.dtype)
                ranked = np.concatenate([ranked, pad]) if len(ranked) else pad
            tgt_item_cols = ex.targets[:, 1:] if ex.targets.shape[1] > L else ex.targets
            for b_idx in np.unique(ex.target_behaviors):
                behavior = corpus.behavior_names[int(b_idx)]
                mask = ex.target_behaviors == b_idx
                hits, n_t = hits_matrix(ranked[None], [tgt_item_cols[mask]])
                res = metrics_from_hits(hits, n_t, metric_list)
                bucket = behavior_results.setdefault(behavior, {m: 0.0 for m in metric_list})
                for m, v in res.items():
                    bucket[m] += v
                counts[behavior] = counts.get(behavior, 0) + 1

        per_behavior = {
            b: {m: v / counts[b] for m, v in ms.items()}
            for b, ms in behavior_results.items()
        }
        total = sum(counts.values())
        merged = {
            m: sum(behavior_results[b][m] for b in behavior_results) / max(total, 1)
            for m in metric_list
        }
        results = {"per_behavior": per_behavior, "merged": merged, "counts": counts}
        os.makedirs(os.path.dirname(results_file) or ".", exist_ok=True)
        with open(results_file, "w") as f:
            json.dump(results, f, indent=2)
        for b, ms in per_behavior.items():
            logger.info("behavior %s: %s", b, {k: round(v, 4) for k, v in ms.items()})
        logger.info("merged: %s", {k: round(v, 4) for k, v in merged.items()})
        return results
