"""Ranking metrics: hit@k / recall@k / ndcg@k with multi-target sessions.

Numerically identical to the reference implementation
(ref: SeqRec/evaluation/ranking.py:5-90) but operating on integer code rows
instead of decoded strings:

 * hit@k:     1 if any of the top-k predictions is a target
 * recall@k:  min(#hits in top-k, |targets|) / |targets|
 * ndcg@k:    DCG over the top-k hit flags — counting stops after |targets|
   hits (ref :41-46) — normalized by the ideal DCG of min(k, |targets|) ones
 * predictions arrive sorted by beam score (the reference re-sorts HF output;
   our beam search returns sorted sequences).

Discriminative full-sort eval uses `rank_metrics` on target ranks
(ref: SeqRec/trainers/SMBRec.py:96-143).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def hits_matrix(pred_codes: np.ndarray, targets: Sequence[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """pred_codes [B, K, L] sorted by score; targets: per-example [T_b, L] arrays.

    Returns (hits [B, K] 0/1, n_targets [B]). A prediction hits if its code row
    equals any target row (set semantics, ref ranking.py:19-29 with list targets).
    """
    B, K, L = pred_codes.shape
    hits = np.zeros((B, K), dtype=np.int32)
    n_targets = np.zeros(B, dtype=np.int32)
    for b in range(B):
        tset = {tuple(r) for r in np.asarray(targets[b]).reshape(-1, L).tolist()}
        n_targets[b] = len(tset)
        for k in range(K):
            if tuple(pred_codes[b, k].tolist()) in tset:
                hits[b, k] = 1
    return hits, n_targets


def _dcg_weights(k: int) -> np.ndarray:
    return 1.0 / np.log2(np.arange(k) + 2)


def metrics_from_hits(
    hits: np.ndarray,  # [B, K] 0/1, sorted by score desc
    n_targets: np.ndarray,  # [B]
    metrics: Sequence[str] = ("hit@1", "hit@5", "hit@10", "recall@1", "recall@5",
                              "recall@10", "ndcg@5", "ndcg@10"),
) -> dict[str, float]:
    """Sum (not mean) per metric over the batch — callers divide by total count
    when merging across batches/behaviors (ref test_SMB_decoder.py:287-304)."""
    B, K = hits.shape
    out: dict[str, float] = {}
    for m in metrics:
        name, k = m.split("@")
        k = int(k)
        res = hits[:, :k]
        if name.lower() == "hit":
            out[m] = float((res.sum(axis=1) > 0).sum())
        elif name.lower() == "recall":
            out[m] = float((np.minimum(res.sum(axis=1), n_targets) / np.maximum(n_targets, 1)).sum())
        elif name.lower() == "ndcg":
            w = _dcg_weights(k)
            total = 0.0
            for b in range(B):
                cnt, dcg = 0, 0.0
                for j in range(min(k, K)):
                    if res[b, j] == 1:
                        cnt += 1
                    dcg += res[b, j] * w[j]
                    if cnt == n_targets[b]:
                        break
                ideal = w[: min(k, max(int(n_targets[b]), 1))].sum()
                total += dcg / ideal
            out[m] = float(total)
        else:
            raise NotImplementedError(m)
    return out


def merge_behavior_metrics(per_behavior: dict[str, dict[str, float]],
                           counts: dict[str, int]) -> dict[str, float]:
    """Weighted merge across behaviors (ref test_SMB_decoder.py:287-304):
    metric sums divided by total example count."""
    total = sum(counts.values())
    merged: dict[str, float] = {}
    for beh, ms in per_behavior.items():
        for k, v in ms.items():
            merged[k] = merged.get(k, 0.0) + v
    return {k: v / max(total, 1) for k, v in merged.items()}


def rank_metrics(ranks: np.ndarray, ks: Sequence[int] = (1, 5, 10)) -> dict[str, float]:
    """Discriminative eval: `ranks` [B] is the 0-based rank of the target item
    in the sorted score list. Returns mean hit/ndcg per k (single-target, so
    recall == hit; ref trainers/SMBRec.py:96-143)."""
    out = {}
    for k in ks:
        hit = (ranks < k).astype(np.float64)
        out[f"hit@{k}"] = float(hit.mean())
        out[f"recall@{k}"] = float(hit.mean())
        out[f"ndcg@{k}"] = float((hit / np.log2(ranks + 2)).mean())
    return out
