"""Single-behavior and (non-session) multi-behavior datasets.

The port's copy of `gamer_tpu/data/seq.py`. Integer-array re-implementations
of the reference's SeqRecDataset (ref: SeqRec/datasets/seq_dataset.py —
leave-two-out split: train=items[:-2], valid=items[-2], test=items[-1]) and
the MB dataset family
(ref: SeqRec/datasets/MB_dataset.py — behavior tokens, `filter_target`,
ForDecoder augmentation). Examples are SMBExample records (streams empty) so
the existing batchers/decode stack apply unchanged.
"""

from __future__ import annotations

from enum import Enum

import numpy as np

from gamer_tpu_torch.core.logging import get_logger
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.smb import SMBExample, TokenLayout
from gamer_tpu_torch.data.vocab import SemanticVocab, find_collisions

logger = get_logger("data.seq")


class EvaluationType(Enum):
    """ref MB_dataset.py:12-16."""

    TARGET_BEHAVIOR = "Target Behavior"
    BEHAVIOR_SPECIFIC = "Behavior Specific"
    BEHAVIOR_ITEM = "Behavior Item"
    FIXED_BEHAVIOR = "Fixed Behavior"


class SeqCorpus:
    """Loads interactions + semantic index for the seq/MB families."""

    def __init__(self, files: DataFiles, index_file: str = ".index.json",
                 multi_behavior: bool = False, inter_type: str | None = None):
        self.files = files
        indices = files.load_index(index_file)
        self.multi_behavior = multi_behavior
        if multi_behavior:
            inters = files.load_mb_inter()
            behaviors_raw = files.load_mb_behavior()
            levels_map = files.load_behavior_level()
            self.behavior_names = list(levels_map.keys())
            self.behavior_levels = np.array([levels_map[b] for b in self.behavior_names],
                                            dtype=np.int32)
            tgt = np.flatnonzero(self.behavior_levels == self.behavior_levels.max())
            assert len(tgt) == 1
            self.target_behavior_idx = int(tgt[0])
            self.target_behavior = self.behavior_names[self.target_behavior_idx]
        else:
            inters = files.load_inter(inter_type)
            behaviors_raw = None
            self.behavior_names = []
            self.behavior_levels = np.zeros(0, np.int32)
            self.target_behavior_idx = -1

        self.vocab = SemanticVocab.from_index_json(indices, behaviors=self.behavior_names)
        self.item_ids, self.item_codes = self.vocab.item_code_table(indices)
        self._item_row = np.full(int(self.item_ids.max()) + 1, -1, dtype=np.int64)
        self._item_row[self.item_ids] = np.arange(len(self.item_ids))
        self.sole_item_len = self.item_codes.shape[1]
        self.collision_rows = find_collisions(self.item_codes)

        b_index = {b: i for i, b in enumerate(self.behavior_names)}
        self.users = list(inters.keys())
        self.user_items = [np.asarray(inters[u], dtype=np.int64) for u in self.users]
        if behaviors_raw is not None:
            self.user_behaviors = [
                np.array([b_index[b] for b in behaviors_raw[u]], dtype=np.int32)
                for u in self.users
            ]
        else:
            self.user_behaviors = [np.zeros(len(v), np.int32) for v in self.user_items]

    def item_rows(self, ids: np.ndarray) -> np.ndarray:
        rows = self._item_row[np.asarray(ids, dtype=np.int64)]
        assert (rows >= 0).all()
        return rows

    def blocks(self, item_ids: np.ndarray, behaviors: np.ndarray, layout: TokenLayout) -> np.ndarray:
        codes = self.item_codes[self.item_rows(item_ids)]
        if not layout.explicit:
            return codes
        btok = np.array([self.vocab.behavior_token(self.behavior_names[b]) for b in behaviors],
                        dtype=codes.dtype)[:, None]
        if layout.behavior_first:
            return np.concatenate([btok, codes], axis=1)
        return np.concatenate([codes, btok], axis=1)


def _empty_streams():
    z = np.zeros(0, dtype=np.int64)
    return dict(session_ids=z, extended_session_ids=z, actions=z,
                time=np.zeros(0, dtype=np.float64))


def _example(corpus, layout, hist_items, hist_behs, tgt_items, tgt_behs, split) -> SMBExample:
    prompt = (corpus.blocks(hist_items, hist_behs, layout).reshape(-1)
              if len(hist_items) else np.zeros(0, dtype=corpus.item_codes.dtype))
    return SMBExample(
        prompt=prompt,
        targets=corpus.blocks(tgt_items, tgt_behs, layout),
        target_behaviors=np.asarray(tgt_behs, dtype=np.int32),
        history_item_ids=np.asarray(hist_items),
        split=split,
        **_empty_streams(),
    )


class SeqExampleBuilder:
    """Leave-two-out single-behavior examples (ref seq_dataset.py:96-137)."""

    def __init__(self, corpus: SeqCorpus, max_his_len: int = 20):
        self.c = corpus
        self.max_his_len = max_his_len
        self.layout = TokenLayout(explicit=False)

    def _cut(self, items):
        return items[-self.max_his_len:] if self.max_his_len > 0 else items

    def build(self, mode: str) -> list[SMBExample]:
        out = []
        zero = np.zeros(1, np.int32)
        for u, items in enumerate(self.c.user_items):
            behs = np.zeros(len(items), np.int32)
            if mode == "train":
                train_items = items[:-2]
                for i in range(1, len(train_items)):
                    out.append(_example(self.c, self.layout,
                                        self._cut(train_items[:i]), behs[:i],
                                        train_items[i:i + 1], zero, "train"))
            elif mode == "valid":
                if len(items) < 2:
                    continue
                out.append(_example(self.c, self.layout, self._cut(items[:-2]), behs,
                                    items[-2:-1], zero, "valid"))
            elif mode == "test":
                out.append(_example(self.c, self.layout, self._cut(items[:-1]), behs,
                                    items[-1:], zero, "test"))
            else:
                raise NotImplementedError(mode)
        return out


class MBExampleBuilder:
    """Multi-behavior leave-two-out examples (ref MB_dataset.py:117-156,281-341)."""

    def __init__(self, corpus: SeqCorpus, layout: TokenLayout, max_his_len: int = 20,
                 filter_target: bool = False):
        self.c = corpus
        self.layout = layout
        self.max_his_len = max_his_len
        self.filter_target = filter_target

    def _history(self, items, behs, tgt_item, tgt_beh):
        """ref _get_inters (MB_dataset.py:101-115): last max_his_len events
        before the target; filter_target drops lower-level duplicates of it."""
        if self.max_his_len > 0:
            items = items[-self.max_his_len:]
            behs = behs[-self.max_his_len:]
        if self.filter_target:
            lvl = self.c.behavior_levels
            keep = (items != tgt_item) | (lvl[behs] >= lvl[tgt_beh])
            items, behs = items[keep], behs[keep]
        return items, behs

    def build(self, mode: str) -> list[SMBExample]:
        out = []
        for u in range(len(self.c.users)):
            items = self.c.user_items[u]
            behs = self.c.user_behaviors[u]
            if mode == "train":
                ti, tb = items[:-2], behs[:-2]
                for i in range(1, len(ti)):
                    h_i, h_b = self._history(ti[:i], tb[:i], ti[i], tb[i])
                    out.append(_example(self.c, self.layout, h_i, h_b,
                                        ti[i:i + 1], tb[i:i + 1], "train"))
            elif mode == "valid":
                if len(items) < 2:
                    continue
                h_i, h_b = self._history(items[:-2], behs[:-2], items[-2], behs[-2])
                out.append(_example(self.c, self.layout, h_i, h_b,
                                    items[-2:-1], behs[-2:-1], "valid"))
            elif mode == "test":
                h_i, h_b = self._history(items[:-1], behs[:-1], items[-1], behs[-1])
                out.append(_example(self.c, self.layout, h_i, h_b,
                                    items[-1:], behs[-1:], "test"))
            else:
                raise NotImplementedError(mode)
        return out

    def build_decoder_train(self, augment: int | None = None, seed: int = 42) -> list[SMBExample]:
        """ForDecoder: last-item target per augmented copy (ref :324-341)."""
        rng = np.random.default_rng(seed)
        out = []
        lvl = self.c.behavior_levels
        for u in range(len(self.c.users)):
            items = self.c.user_items[u][:-2]
            behs = self.c.user_behaviors[u][:-2]
            if len(items) < 2:
                continue
            copies = [(items, behs)]
            for k in range(1, (augment or 0) + 1):
                ratio = k / augment
                drop = np.zeros(len(items), dtype=bool)
                for b in range(len(lvl)):
                    if b == self.c.target_behavior_idx:
                        continue
                    idx = np.flatnonzero(behs == b)
                    n_drop = int(len(idx) * ratio / (lvl[b] + 1))
                    if n_drop > 0:
                        drop[rng.choice(idx, n_drop, replace=False)] = True
                keep = ~drop
                if keep.sum() >= 2:
                    copies.append((items[keep], behs[keep]))
            for it, bh in copies:
                h_i, h_b = self._history(it[:-1], bh[:-1], it[-1], bh[-1])
                out.append(_example(self.c, self.layout, h_i, h_b,
                                    it[-1:], bh[-1:], "train"))
        return out


def filter_mb_examples(examples: list[SMBExample], behavior_idx: int) -> list[SMBExample]:
    """ref MB_dataset.py:211-218 (single-target examples)."""
    return [e for e in examples if int(e.target_behaviors[0]) == behavior_idx]
