"""Session-wise multi-behavior (SMB) data engine.

Re-implements the behavior of the reference's SMB dataset family
(ref: SeqRec/datasets/SMB_dataset.py — BaseSMBDataset and subclasses) with an
integer-array representation designed for device batching:

 * item "tokens" are rows of a precomputed [n_items, L] token-id matrix
   (data/vocab.py) — no string joins/splits anywhere;
 * examples carry per-token integer streams (session_ids, extended_session_ids,
   actions, time) exactly as the reference derives them
   (ref: SMB_dataset.py:194-248), ready to pad into static-shape batches;
 * the session split matches the reference: last session = test, second-last =
   valid, earlier = train (ref: SMB_dataset.py:101-114).

Dataset variants (ref class → here):
  SMBDataset                     → layout = TokenLayout(explicit=False)
  SMBExplicitDataset             → layout = TokenLayout(explicit=True, behavior_first=...)
  SMBExplicitDatasetForDecoder   → build_decoder_train_examples(augment=N)
  SMBAugmentDataset              → build_decoder_train_examples(all_prefix=True)
  BaseSMBDataset train/valid     → build_prefix_train_examples / build_valid_examples
  test / valid_test              → build_session_eval_examples(mode)
  SMBAugmentEvaluationDataset    → build_session_eval_examples(drop_ratio=r)
  SMBDropGTEvaluationDataset     → build_drop_gt_eval_examples
  filter_by_behavior             → filter_examples_by_behavior
"""

from __future__ import annotations

import hashlib
import os
import pickle
from dataclasses import dataclass, replace
from datetime import datetime
from typing import Sequence

import numpy as np

from gamer_tpu_torch.core.logging import get_logger, process_index
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.vocab import SemanticVocab, find_collisions

logger = get_logger("data.smb")

# Padding value for the `actions` stream (ref: SeqRec/datasets/collator.py:99).
ACTION_PAD = 100
TIME_PAD = -1.0


@dataclass(frozen=True)
class TokenLayout:
    """How an (item, behavior) pair becomes a token block.

    explicit=False: [item tokens]                  (ref SMBDataset)
    explicit=True, behavior_first=True:  [<behavior>, item tokens]
    explicit=True, behavior_first=False: [item tokens, <behavior>]
    """

    explicit: bool = True
    behavior_first: bool = True

    def token_count(self, sole_item_len: int) -> int:
        return sole_item_len + (1 if self.explicit else 0)


class SMBCorpus:
    """Loaded + session-split SMB dataset in array form (one instance per dataset)."""

    def __init__(
        self,
        files: DataFiles,
        index_file: str = ".index.json",
        cache: bool = True,
    ):
        self.files = files
        self.index_file = index_file

        indices = files.load_index(index_file)
        levels_map = files.load_behavior_level()
        self.behavior_names: list[str] = list(levels_map.keys())
        self.behavior_levels = np.array([levels_map[b] for b in self.behavior_names], dtype=np.int32)
        self.max_behavior_level = int(self.behavior_levels.max())
        target_idx = np.flatnonzero(self.behavior_levels == self.max_behavior_level)
        assert len(target_idx) == 1, f"expected unique target behavior, got {target_idx}"
        self.target_behavior_idx = int(target_idx[0])
        self.target_behavior = self.behavior_names[self.target_behavior_idx]

        self.vocab = SemanticVocab.from_index_json(indices, behaviors=self.behavior_names)
        self.item_ids, self.item_codes = self.vocab.item_code_table(indices)
        # Map raw item id -> row in item_codes (contract allows arbitrary int keys).
        self._item_row = np.full(int(self.item_ids.max()) + 1, -1, dtype=np.int64)
        self._item_row[self.item_ids] = np.arange(len(self.item_ids))
        self.sole_item_len = self.item_codes.shape[1]
        self.collision_rows = find_collisions(self.item_codes)

        cached = self._load_user_cache() if cache else None
        if cached is not None:
            (self.users, self.user_items, self.user_behaviors, self.user_sessions,
             self.user_times, self.valid_pos, self.test_pos) = cached
        else:
            self._build_user_arrays()
            if cache and process_index() == 0:
                self._save_user_cache()

    # ------------------------------------------------------------------ load

    def _build_user_arrays(self) -> None:
        inters = self.files.load_smb_inter()
        behaviors = self.files.load_smb_behavior()
        sessions = self.files.load_smb_session()
        times = self.files.load_smb_time() if self.files.has(".SMB.time.json") else None
        b_index = {b: i for i, b in enumerate(self.behavior_names)}

        self.users: list[str] = list(inters.keys())
        self.user_items: list[np.ndarray] = []
        self.user_behaviors: list[np.ndarray] = []
        self.user_sessions: list[np.ndarray] = []
        self.user_times: list[np.ndarray] = []
        self.valid_pos: np.ndarray = np.zeros(len(self.users), dtype=np.int64)
        self.test_pos: np.ndarray = np.zeros(len(self.users), dtype=np.int64)

        for u, uid in enumerate(self.users):
            items = np.asarray(inters[uid], dtype=np.int64)
            behs = np.array([b_index[b] for b in behaviors[uid]], dtype=np.int32)
            sids = np.asarray(sessions[uid], dtype=np.int64)
            sids = sids - sids.min()  # normalize to start at 0 (ref :103)
            if times is not None:
                ts = np.array(
                    [datetime.strptime(t, "%Y-%m-%d %H:%M:%S").timestamp() for t in times[uid]]
                )
                halfhours = (ts - ts[0]) / 1800.0  # ref :119-123
            else:
                halfhours = np.zeros(len(items), dtype=np.float64)
            uniq = np.unique(sids)
            # last session -> test, second-last -> valid (ref :104-114)
            self.test_pos[u] = int(np.argmax(sids == uniq[-1]))
            self.valid_pos[u] = int(np.argmax(sids == uniq[-2])) if len(uniq) >= 2 else -1
            self.user_items.append(items)
            self.user_behaviors.append(behs)
            self.user_sessions.append(sids)
            self.user_times.append(halfhours)

    # ----------------------------------------------------------------- cache

    def _cache_path(self) -> str:
        # The same file name as the JAX package's corpus cache: the pickle holds
        # only lists and numpy arrays, so either package reads the other's.
        key = hashlib.md5(self.index_file.encode()).hexdigest()[:8]
        return self.files.path(f".smb_corpus.{key}.npz.pkl")

    def _save_user_cache(self) -> None:
        tmp = self._cache_path() + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(
                (self.users, self.user_items, self.user_behaviors, self.user_sessions,
                 self.user_times, self.valid_pos, self.test_pos),
                f,
            )
        os.replace(tmp, self._cache_path())  # atomic: fixes the reference's cache write race

    def _load_user_cache(self):
        p = self._cache_path()
        if not os.path.exists(p):
            return None
        try:
            with open(p, "rb") as f:
                return pickle.load(f)
        except Exception:
            return None

    # ------------------------------------------------------------- token ops

    def item_rows(self, item_ids: np.ndarray) -> np.ndarray:
        rows = self._item_row[np.asarray(item_ids, dtype=np.int64)]
        assert (rows >= 0).all(), "unknown item id in interactions"
        return rows

    def blocks(self, item_ids: np.ndarray, behaviors: np.ndarray, layout: TokenLayout) -> np.ndarray:
        """[n] item ids + [n] behavior indices -> [n, tc] token blocks."""
        n = len(item_ids)
        codes = self.item_codes[self.item_rows(item_ids)]
        if not layout.explicit:
            return codes
        btok = np.array([self.vocab.behavior_token(self.behavior_names[b]) for b in behaviors],
                        dtype=codes.dtype)[:, None]
        if layout.behavior_first:
            return np.concatenate([btok, codes], axis=1)
        return np.concatenate([codes, btok], axis=1)

    def all_item_blocks(self, layout: TokenLayout, behavior_idx: int | None = None) -> np.ndarray:
        """Token blocks for the full catalog under one behavior (decode candidates).

        ref: BaseSMBDataset.get_all_items / _get_all_items_by_behavior
        (SMB_dataset.py:370-408). Collision rows are de-duplicated like the
        reference's set() semantics.
        """
        keep = ~self.collision_rows
        items = self.item_ids[keep]
        if behavior_idx is None or not layout.explicit:
            return self.item_codes[keep]
        behs = np.full(len(items), behavior_idx, dtype=np.int32)
        return self.blocks(items, behs, layout)


# ---------------------------------------------------------------------------
# Per-token stream derivation (ref: SMB_dataset.py:194-248)
# ---------------------------------------------------------------------------


def session_id_stream(sids: np.ndarray, tc: int, max_his: int, extra: bool) -> np.ndarray:
    lim = max_his + (1 if extra else 0)
    if max_his > 0:
        sids = sids[-lim:]
    return np.repeat(sids, tc)


def extended_session_id_stream(sids: np.ndarray, tc: int, max_his: int, extra: bool) -> np.ndarray:
    lim = max_his + (1 if extra else 0)
    if max_his > 0:
        sids = sids[-lim:]
    if len(sids) == 0:
        return np.zeros(0, dtype=np.int64)
    # dense re-rank of session ids, then position = rank*tc + offset-in-block
    change = np.concatenate([[True], sids[1:] != sids[:-1]])
    rank = np.cumsum(change) - 1
    return (np.repeat(rank, tc) * tc) + np.tile(np.arange(tc), len(sids))


def action_stream(behavior_levels: np.ndarray, behs: np.ndarray, tc: int, max_his: int, extra: bool) -> np.ndarray:
    lim = max_his + (1 if extra else 0)
    if max_his > 0:
        behs = behs[-lim:]
    return np.repeat(behavior_levels[behs], tc)


def time_stream(times: np.ndarray, tc: int, max_his: int) -> np.ndarray:
    if len(times) == 0:
        return np.zeros(0, dtype=np.float64)
    t = np.abs(times - times[-1])
    if max_his > 0:
        t = t[-(max_his + 1):]
    t = t[:-1]  # drop the base (target) entry (ref :245)
    return np.repeat(t, tc)


# ---------------------------------------------------------------------------
# Examples
# ---------------------------------------------------------------------------


@dataclass
class SMBExample:
    """One training/eval example in integer form.

    prompt: [T] history token stream (already truncated to max_his_len blocks).
    targets: [n_targets, tc] target token blocks (train: n_targets == 1).
    target_behaviors: [n_targets] behavior indices.
    session_ids / extended_session_ids / actions: per-token streams. For train
    and valid they cover prompt+target; for test they cover only the prompt
    (the decode loop appends the to-be-generated block, matching the
    reference's test collator, ref collator.py:176-202).
    time: per-token float stream over the prompt.
    history_item_ids: raw item ids of the (truncated) history, for the
    duplicate-vs-history ratio metric (ref test_SMB_decoder.py:217-223).
    """

    prompt: np.ndarray
    targets: np.ndarray
    target_behaviors: np.ndarray
    session_ids: np.ndarray
    extended_session_ids: np.ndarray
    actions: np.ndarray
    time: np.ndarray
    history_item_ids: np.ndarray
    split: str


def _truncate(arrs: Sequence[np.ndarray], max_his: int) -> list[np.ndarray]:
    if max_his > 0:
        return [a[-max_his:] for a in arrs]
    return list(arrs)


class SMBExampleBuilder:
    """Builds example lists from an SMBCorpus under a TokenLayout."""

    def __init__(self, corpus: SMBCorpus, layout: TokenLayout, max_his_len: int = 20):
        self.c = corpus
        self.layout = layout
        self.max_his_len = max_his_len
        self.tc = layout.token_count(corpus.sole_item_len)

    # -- shared pieces ------------------------------------------------------

    def _prompt(self, items: np.ndarray, behs: np.ndarray) -> np.ndarray:
        items, behs = _truncate([items, behs], self.max_his_len)
        if len(items) == 0:
            return np.zeros(0, dtype=self.c.item_codes.dtype)
        return self.c.blocks(items, behs, self.layout).reshape(-1)

    def _streams(self, sids: np.ndarray, behs: np.ndarray, times: np.ndarray, extra: bool):
        tc, mh = self.tc, self.max_his_len
        return (
            session_id_stream(sids, tc, mh, extra),
            extended_session_id_stream(sids, tc, mh, extra),
            action_stream(self.c.behavior_levels, behs, tc, mh, extra),
            time_stream(times, tc, mh),
        )

    # -- augmentation (ref SMBExplicitDatasetForDecoder._augment_interactions,
    #    SMB_dataset.py:540-584; SMBAugmentDataset variant :627-671) ---------

    def _augment(
        self,
        rng: np.random.Generator,
        items: np.ndarray,
        behs: np.ndarray,
        sids: np.ndarray,
        times: np.ndarray,
        augment: int,
        denom_offset: int = 0,
    ):
        """Yield the original + N downsampled copies.

        Copy k (k=1..N) drops ratio_k/(level+1) of each non-target behavior's
        events at random, ratio_k = k/(N+denom_offset). denom_offset=0 matches
        ForDecoder (ratios up to 1), 1 matches SMBAugmentDataset.
        """
        out = [(items, behs, sids, times)]
        if not augment:
            return out
        levels = self.c.behavior_levels
        for k in range(1, augment + 1):
            ratio = k / (augment + denom_offset)
            drop = np.zeros(len(items), dtype=bool)
            for b in range(len(levels)):
                if b == self.c.target_behavior_idx:
                    continue
                idx = np.flatnonzero(behs == b)
                n_drop = int(len(idx) * ratio / (levels[b] + 1))
                if n_drop > 0:
                    drop[rng.choice(idx, n_drop, replace=False)] = True
            keep = ~drop
            if keep.sum() < 2:
                continue
            out.append((items[keep], behs[keep], sids[keep], times[keep]))
        return out

    # -- train --------------------------------------------------------------

    def build_decoder_train_examples(self, augment: int | None = None, all_prefix: bool = False,
                                     seed: int = 42) -> list[SMBExample]:
        """ref: SMBExplicitDatasetForDecoder._process_train_data (last-item target
        per augmented copy) and SMBAugmentDataset (all-prefix expansion)."""
        rng = np.random.default_rng(seed)
        examples: list[SMBExample] = []
        for u in range(len(self.c.users)):
            vp = int(self.c.valid_pos[u])
            if vp <= 0:
                continue
            items = self.c.user_items[u][:vp]
            behs = self.c.user_behaviors[u][:vp]
            sids = self.c.user_sessions[u][:vp]
            times = self.c.user_times[u][:vp]
            copies = self._augment(rng, items, behs, sids, times, augment or 0,
                                   denom_offset=1 if all_prefix else 0)
            for it, bh, sd, tm in copies:
                if all_prefix:
                    examples.extend(self._prefix_examples(it, bh, sd, tm))
                else:
                    examples.append(self._last_item_example(it, bh, sd, tm))
        return examples

    def _last_item_example(self, items, behs, sids, times) -> SMBExample:
        s, e, a, t = self._streams(sids, behs, times, extra=True)
        return SMBExample(
            prompt=self._prompt(items[:-1], behs[:-1]),
            targets=self.c.blocks(items[-1:], behs[-1:], self.layout),
            target_behaviors=behs[-1:].copy(),
            session_ids=s, extended_session_ids=e, actions=a, time=t,
            history_item_ids=_truncate([items[:-1]], self.max_his_len)[0],
            split="train",
        )

    def _prefix_examples(self, items, behs, sids, times) -> list[SMBExample]:
        """All-prefix expansion: target = event i, history = session-start cut
        (ref BaseSMBDataset._process_train_data, SMB_dataset.py:250-278)."""
        out = []
        # session start position for each event (ref SMBAugmentDataset poss logic)
        poss = np.zeros(len(items), dtype=np.int64)
        for i in range(1, len(items)):
            poss[i] = i if sids[i] > sids[i - 1] else poss[i - 1]
        for i in range(1, len(items)):
            pos = int(poss[i])
            s, e, _, t = self._streams(sids[: pos + 1], behs[: pos + 1], times[: pos + 1], extra=True)
            a = action_stream(self.c.behavior_levels,
                              np.concatenate([behs[:pos], behs[i:i + 1]]),
                              self.tc, self.max_his_len, extra=True)
            out.append(SMBExample(
                prompt=self._prompt(items[:pos], behs[:pos]),
                targets=self.c.blocks(items[i:i + 1], behs[i:i + 1], self.layout),
                target_behaviors=behs[i:i + 1].copy(),
                session_ids=s, extended_session_ids=e, actions=a, time=t,
                history_item_ids=_truncate([items[:pos]], self.max_his_len)[0],
                split="train",
            ))
        return out

    def build_prefix_train_examples(self) -> list[SMBExample]:
        """ref: BaseSMBDataset._process_train_data — every event in every train
        session is a target; history is cut at its session start."""
        examples: list[SMBExample] = []
        for u in range(len(self.c.users)):
            vp = int(self.c.valid_pos[u])
            if vp <= 0:
                continue
            examples.extend(self._prefix_examples(
                self.c.user_items[u][:vp], self.c.user_behaviors[u][:vp],
                self.c.user_sessions[u][:vp], self.c.user_times[u][:vp]))
        return examples

    # -- valid (ref :280-303) ------------------------------------------------

    def build_valid_examples(self) -> list[SMBExample]:
        examples: list[SMBExample] = []
        for u in range(len(self.c.users)):
            vp = int(self.c.valid_pos[u])
            if vp < 0:
                continue
            tp = int(self.c.test_pos[u])
            items = self.c.user_items[u][:tp]
            behs = self.c.user_behaviors[u][:tp]
            sids = self.c.user_sessions[u][:tp]
            times = self.c.user_times[u][:tp]
            s, e, _, t = self._streams(sids[: vp + 1], behs[: vp + 1], times[: vp + 1], extra=True)
            for i in range(vp, len(items)):
                a = action_stream(self.c.behavior_levels,
                                  np.concatenate([behs[:vp], behs[i:i + 1]]),
                                  self.tc, self.max_his_len, extra=True)
                examples.append(SMBExample(
                    prompt=self._prompt(items[:vp], behs[:vp]),
                    targets=self.c.blocks(items[i:i + 1], behs[i:i + 1], self.layout),
                    target_behaviors=behs[i:i + 1].copy(),
                    session_ids=s, extended_session_ids=e, actions=a, time=t,
                    history_item_ids=_truncate([items[:vp]], self.max_his_len)[0],
                    split="valid",
                ))
        return examples

    # -- test / valid_test (ref :305-355) ------------------------------------

    def build_session_eval_examples(self, mode: str = "test", drop_ratio: float | None = None,
                                    seed: int = 42) -> list[SMBExample]:
        """One example per user; targets = all events of the held-out session.

        With drop_ratio set, also computes a dropped-history variant used for
        the target behavior (ref SMBAugmentEvaluationDataset :717-933); here the
        dropped view replaces the original only in filter_examples_by_behavior.
        """
        assert mode in ("test", "valid_test")
        rng = np.random.default_rng(seed)
        examples: list[SMBExample] = []
        for u in range(len(self.c.users)):
            if mode == "test":
                cut = int(self.c.test_pos[u])
                items_all = self.c.user_items[u]
                behs_all = self.c.user_behaviors[u]
                sids_all = self.c.user_sessions[u]
                times_all = self.c.user_times[u]
            else:
                cut = int(self.c.valid_pos[u])
                tp = int(self.c.test_pos[u])
                items_all = self.c.user_items[u][:tp]
                behs_all = self.c.user_behaviors[u][:tp]
                sids_all = self.c.user_sessions[u][:tp]
                times_all = self.c.user_times[u][:tp]
                if cut < 0:
                    continue
            tgt_items = items_all[cut:]
            tgt_behs = behs_all[cut:]
            assert len(tgt_items) > 0
            hist = (items_all[:cut], behs_all[:cut], sids_all[:cut], times_all[:cut])
            ex = self._session_eval_example(*hist, tgt_items, tgt_behs,
                                            times_all[: cut + 1], mode)
            if drop_ratio is not None:
                it, bh, sd, tm = self._drop_for_eval(rng, *hist, drop_ratio)
                ex_dropped = self._session_eval_example(
                    it, bh, sd, tm, tgt_items, tgt_behs,
                    np.concatenate([tm, times_all[cut:cut + 1]]), mode)
                ex.dropped = ex_dropped  # type: ignore[attr-defined]
            examples.append(ex)
        return examples

    def _session_eval_example(self, items, behs, sids, times, tgt_items, tgt_behs,
                              times_incl_next, mode) -> SMBExample:
        tc, mh = self.tc, self.max_his_len
        return SMBExample(
            prompt=self._prompt(items, behs),
            targets=self.c.blocks(tgt_items, tgt_behs, self.layout),
            target_behaviors=tgt_behs.copy(),
            # prompt-only streams; decode appends the generated block (ref :321)
            session_ids=session_id_stream(sids, tc, mh, extra=False),
            extended_session_ids=extended_session_id_stream(sids, tc, mh, extra=False),
            actions=action_stream(self.c.behavior_levels, behs, tc, mh, extra=False),
            time=time_stream(times_incl_next, tc, mh),
            history_item_ids=_truncate([items], mh)[0],
            split=mode,
        )

    def _drop_for_eval(self, rng, items, behs, sids, times, drop_ratio):
        levels = self.c.behavior_levels
        drop = np.zeros(len(items), dtype=bool)
        for b in range(len(levels)):
            if b == self.c.target_behavior_idx:
                continue
            idx = np.flatnonzero(behs == b)
            n_drop = int(len(idx) * drop_ratio / (levels[b] + 1))
            if n_drop > 0:
                drop[rng.choice(idx, n_drop, replace=False)] = True
        keep = ~drop
        if keep.sum() < 1:
            return items, behs, sids, times
        return items[keep], behs[keep], sids[keep], times[keep]

    # -- drop-GT eval (ref SMBDropGTEvaluationDataset :936-977) ---------------

    def build_drop_gt_eval_examples(self) -> list[SMBExample]:
        examples: list[SMBExample] = []
        drop_ratios = []
        for u in range(len(self.c.users)):
            cut = int(self.c.test_pos[u])
            items = self.c.user_items[u]
            behs = self.c.user_behaviors[u]
            sids = self.c.user_sessions[u]
            times = self.c.user_times[u]
            tgt_items = items[cut:]
            tgt_behs = behs[cut:]
            gt = np.isin(items[:cut], tgt_items) & (behs[:cut] != self.c.target_behavior_idx)
            if cut > 0:
                drop_ratios.append(gt.sum() / cut)
            if cut > 0 and gt.all():
                continue
            keep = ~gt
            examples.append(self._session_eval_example(
                items[:cut][keep], behs[:cut][keep], sids[:cut][keep], times[:cut][keep],
                tgt_items, tgt_behs,
                np.concatenate([times[:cut][keep], times[cut:cut + 1]]), "test"))
        if drop_ratios:
            logger.warning("Average drop ratio of ground-truth items: %.4f", float(np.mean(drop_ratios)))
        return examples


def filter_examples_by_behavior(examples: list[SMBExample], behavior_idx: int,
                                target_behavior_idx: int | None = None) -> list[SMBExample]:
    """Per-behavior eval view (ref: BaseSMBDataset.filter_by_behavior :410-439;
    for drop-ratio datasets the dropped history replaces the original when
    filtering to the target behavior, ref :892-933)."""
    out = []
    for ex in examples:
        mask = ex.target_behaviors == behavior_idx
        if not mask.any():
            continue
        base = ex
        if target_behavior_idx is not None and behavior_idx == target_behavior_idx:
            base = getattr(ex, "dropped", ex)
        out.append(replace(
            base,
            targets=ex.targets[mask],
            target_behaviors=ex.target_behaviors[mask],
        ))
    return out
