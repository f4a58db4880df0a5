"""SMB discriminative datasets: raw item-id sequences with behavior streams.

The port's copy of `gamer_tpu/data/smb_dis.py` (numpy; its generators give
the same examples byte for byte). It re-implements the reference's SMBDis dataset family
(ref: SeqRec/datasets/SMB_dis_dataset.py) on top of SMBCorpus' session split:
item ids are +1 shifted (0 = padding); `diff=True` disambiguates by behavior
(id = behavior_idx * n_items + item + 1, ref :370-374); train targets come from
session-start-cut prefixes (ref :200-228); eval targets are the held-out
session's events; variants add negative sampling (BPR, ref :489-535), a
forced-target history (ref :391-420), 1000-negative sampled eval (ref :574-634)
and the mask-slot eval for BERT4Rec-style models (ref :636-702).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Sequence

import numpy as np

from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.data.smb import SMBCorpus

logger = get_logger("data.smb_dis")


@dataclass
class DisExample:
    inters: np.ndarray  # [T] shifted item ids
    inter_behaviors: np.ndarray  # [T] behavior idx (0-based)
    targets: np.ndarray  # [n] shifted item ids (train: n=1)
    target_behaviors: np.ndarray  # [n]
    session_ids: np.ndarray
    actions: np.ndarray
    time: np.ndarray
    split: str
    neg_item: int = 0
    uid: int = 0
    item_range: tuple | None = None
    all_item: np.ndarray | None = None  # sampled-eval candidate ids


class SMBDisBuilder:
    """Example builder over an SMBCorpus (shares the session split)."""

    def __init__(self, corpus: SMBCorpus, max_his_len: int = 20, diff: bool = False,
                 add_uid: bool = False):
        self.c = corpus
        self.max_his_len = max_his_len
        self.diff = diff
        self.add_uid = add_uid
        self.n_raw_items = int(corpus.item_ids.max()) + 1

    @property
    def num_items(self) -> int:
        """Table size minus padding (ref :350-355)."""
        n = self.n_raw_items
        return len(self.c.behavior_names) * n if self.diff else n

    def shift(self, items: np.ndarray, behaviors: np.ndarray) -> np.ndarray:
        """ref :369-374 (+1 for padding index 0)."""
        if self.diff:
            return behaviors.astype(np.int64) * self.n_raw_items + items + 1
        return items + 1

    def _cut(self, *arrs):
        if self.max_his_len > 0:
            return [a[-self.max_his_len:] for a in arrs]
        return list(arrs)

    def _streams(self, sids, behs, times, extra: bool):
        mh = self.max_his_len
        lim = mh + (1 if extra else 0)
        s = sids[-lim:] if mh > 0 else sids
        a = self.c.behavior_levels[behs[-lim:] if mh > 0 else behs]
        if len(times):
            t = np.abs(times - times[-1])
            t = (t[-(mh + 1):] if mh > 0 else t)[:-1]
        else:
            t = times
        return s, a, t

    # ---- train -------------------------------------------------------------

    def build_train(self, variant: str = "base", seed: int = 42) -> list[DisExample]:
        """variant: base | target (history includes the target event, ref :391-420)
        | neg (adds sampled negative for BPR, ref :489-535) | user (one
        user-level example, random window, ref SMBDisUserLevelDataset :538-572)."""
        rng = np.random.default_rng(seed)
        out: list[DisExample] = []
        for u in range(len(self.c.users)):
            vp = int(self.c.valid_pos[u])
            if vp <= 0:
                continue
            items = self.c.user_items[u][:vp]
            behs = self.c.user_behaviors[u][:vp]
            sids = self.c.user_sessions[u][:vp]
            times = self.c.user_times[u][:vp]
            if variant == "user":
                if len(items) > self.max_his_len and rng.random() > 0.8:
                    b0 = rng.integers(0, len(items) - self.max_his_len)
                    items, behs = items[b0:b0 + self.max_his_len], behs[b0:b0 + self.max_his_len]
                    sids, times = sids[b0:b0 + self.max_his_len], times[b0:b0 + self.max_his_len]
                h_items, h_behs = self._cut(items, behs)
                s, a, t = self._streams(sids, behs, times, extra=False)
                out.append(DisExample(
                    inters=self.shift(h_items, h_behs),
                    inter_behaviors=h_behs.copy(),
                    targets=self.shift(items[-1:], behs[-1:]),
                    target_behaviors=behs[-1:].copy(),
                    session_ids=s, actions=a, time=t, split="train",
                    uid=u + 1 if self.add_uid else 0,
                ))
                continue
            negs = None
            if variant == "neg":
                pool = np.setdiff1d(np.arange(self.n_raw_items), np.unique(items))
                if len(pool) == 0:
                    pool = np.arange(self.n_raw_items)
                negs = rng.choice(pool, size=len(items), replace=len(pool) < len(items))
            poss = np.zeros(len(items), dtype=np.int64)
            for i in range(1, len(items)):
                poss[i] = i if sids[i] > sids[i - 1] else poss[i - 1]
            for i in range(1, len(items)):
                pos = int(poss[i])
                if pos == 0:
                    continue  # empty history skipped (ref :210-211)
                if variant == "target":
                    h_items = np.concatenate([items[:pos], items[i:i + 1]])
                    h_behs = np.concatenate([behs[:pos], behs[i:i + 1]])
                else:
                    h_items, h_behs = items[:pos], behs[:pos]
                h_items, h_behs = self._cut(h_items, h_behs)
                s, a, t = self._streams(sids[:pos + 1],
                                        np.concatenate([behs[:pos], behs[i:i + 1]]),
                                        times[:pos + 1], extra=True)
                out.append(DisExample(
                    inters=self.shift(h_items, h_behs),
                    inter_behaviors=h_behs.copy(),
                    targets=self.shift(items[i:i + 1], behs[i:i + 1]),
                    target_behaviors=behs[i:i + 1].copy(),
                    session_ids=s, actions=a, time=t, split="train",
                    neg_item=int(self.shift(negs[i:i + 1], behs[i:i + 1])[0]) if negs is not None else 0,
                    uid=u + 1 if self.add_uid else 0,
                ))
        return out

    # ---- eval --------------------------------------------------------------

    def build_eval(self, mode: str = "test", append_mask_slot: bool = False,
                   num_neg: int = 0, seed: int = 42) -> list[DisExample]:
        """One example per user; targets = held-out session events.

        append_mask_slot adds the BERT4Rec/PBAT/MBHT mask position
        (item id = num_items + 1, behavior filled by filter_by_behavior;
        ref :438-440,636-702). num_neg > 0 attaches the sampled-eval candidate
        pool (targets + negatives excluding the user's history, ref :574-634).
        """
        rng = np.random.default_rng(seed)
        out: list[DisExample] = []
        for u in range(len(self.c.users)):
            if mode == "test":
                cut = int(self.c.test_pos[u])
                items, behs = self.c.user_items[u], self.c.user_behaviors[u]
                sids, times = self.c.user_sessions[u], self.c.user_times[u]
            else:
                cut = int(self.c.valid_pos[u])
                tp = int(self.c.test_pos[u])
                items, behs = self.c.user_items[u][:tp], self.c.user_behaviors[u][:tp]
                sids, times = self.c.user_sessions[u][:tp], self.c.user_times[u][:tp]
                if cut < 0:
                    continue
            tgt_items, tgt_behs = items[cut:], behs[cut:]
            mh = self.max_his_len - (1 if append_mask_slot else 0)
            h_items = items[:cut][-mh:] if mh > 0 else items[:cut]
            h_behs = behs[:cut][-mh:] if mh > 0 else behs[:cut]
            inters = self.shift(h_items, h_behs)
            inter_behaviors = h_behs.copy()
            if append_mask_slot:
                inters = np.concatenate([inters, [self.num_items + 1]])
                inter_behaviors = np.concatenate([inter_behaviors, [-1]])
            s, a, t = self._streams(sids[:cut], behs[:cut],
                                    times[:cut + 1] if cut < len(times) else times[:cut],
                                    extra=False)
            all_item = None
            if num_neg > 0:
                hist_set = np.unique(items)
                pool = np.setdiff1d(np.arange(self.n_raw_items), hist_set)
                n = min(num_neg, len(pool))
                negs = rng.choice(pool, size=n, replace=False)
                # candidates under the target behavior (ref :614-622)
                tb = np.full(n, self.c.target_behavior_idx, dtype=np.int32)
                all_item = self.shift(negs, tb)
            out.append(DisExample(
                inters=inters, inter_behaviors=inter_behaviors,
                targets=self.shift(tgt_items, tgt_behs),
                target_behaviors=tgt_behs.copy(),
                session_ids=s, actions=a, time=t, split=mode,
                uid=u + 1 if self.add_uid else 0, all_item=all_item,
            ))
        return out

    def filter_by_behavior(self, examples: list[DisExample], behavior_idx: int) -> list[DisExample]:
        """ref :285-343 + diff item_range (:376-385) + mask-slot behavior fill
        (:482-487). Per-behavior targets are deduplicated (set semantics)."""
        out = []
        for ex in examples:
            m = ex.target_behaviors == behavior_idx
            if not m.any():
                continue
            tgts = np.unique(ex.targets[m])
            new = replace(ex, targets=tgts,
                          target_behaviors=np.full(len(tgts), behavior_idx))
            if (new.inter_behaviors[-1:] == -1).any():
                ib = new.inter_behaviors.copy()
                ib[-1] = behavior_idx
                new = replace(new, inter_behaviors=ib)
            if self.diff:
                new = replace(new, item_range=(
                    behavior_idx * self.n_raw_items + 1,
                    (behavior_idx + 1) * self.n_raw_items + 1))
            out.append(new)
        return out


@dataclass
class DisBatcher:
    """Right-padded fixed-shape batches (ref collator_traditional.py):
    inter_behaviors are +1 shifted so 0 = padding."""

    seq_len: int
    max_targets: int = 1

    @classmethod
    def for_examples(cls, examples: Sequence[DisExample], seq_len: int | None = None):
        L = seq_len or max((len(e.inters) for e in examples), default=4)
        mt = max((len(e.targets) for e in examples), default=1)
        return cls(seq_len=L, max_targets=mt)

    def collate(self, examples: Sequence[DisExample]) -> dict[str, np.ndarray]:
        B, L = len(examples), self.seq_len
        out = {
            "inputs": np.zeros((B, L), dtype=np.int32),
            "behaviors": np.zeros((B, L), dtype=np.int32),
            "seq_len": np.zeros(B, dtype=np.int32),
            "target": np.zeros(B, dtype=np.int32),
            "behavior": np.zeros(B, dtype=np.int32),
            "neg_item": np.zeros(B, dtype=np.int32),
            "uid": np.zeros(B, dtype=np.int32),
            "targets_padded": np.zeros((B, self.max_targets), dtype=np.int32),
            "n_targets": np.zeros(B, dtype=np.int32),
            "row_valid": np.ones(B, dtype=np.int32),
        }
        if examples and examples[0].all_item is not None:
            C = max(len(e.all_item) for e in examples)
            out["all_item"] = np.zeros((B, C), dtype=np.int32)
            for i, ex in enumerate(examples):
                out["all_item"][i, :len(ex.all_item)] = ex.all_item
        for i, ex in enumerate(examples):
            T = min(len(ex.inters), L)
            out["inputs"][i, :T] = ex.inters[-L:]
            out["behaviors"][i, :T] = ex.inter_behaviors[-L:] + 1  # 0 = pad
            out["seq_len"][i] = T
            out["target"][i] = ex.targets[0]
            out["behavior"][i] = ex.target_behaviors[0]
            out["neg_item"][i] = ex.neg_item
            out["uid"][i] = ex.uid
            n = min(len(ex.targets), self.max_targets)
            out["targets_padded"][i, :n] = ex.targets[:n]
            out["n_targets"][i] = n
        return out
