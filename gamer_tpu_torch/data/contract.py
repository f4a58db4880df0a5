"""Readers/writers for the on-disk dataset contract.

File layout is byte-compatible with the reference framework's data contract
(ref: docs/datasets.md; loaders in SeqRec/datasets/seq_dataset.py:82-88 and
SeqRec/datasets/SMB_dataset.py:73-147), so datasets prepared for either
framework interoperate:

  <ds>/<ds>.inter.json          uid -> [item_id, ...]   (time ordered)
  <ds>/<ds>.item.json           item_id -> metadata dict
  <ds>/<ds>.index[.v].json      item_id -> ["<a_1>", "<b_2>", ...]
  <ds>/<ds>.MB.inter.json       all-behavior interactions
  <ds>/<ds>.MB.behavior.json    uid -> [behavior, ...]
  <ds>/<ds>.SMB.{inter,behavior,session,time}.json
  <ds>/<ds>.behavior_level.json behavior -> level (unique max = target behavior)
  <ds>/<ds>.emb-<plm>-td.npy    item text embeddings (SemEmb task output)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np


@dataclass
class DataFiles:
    """Path helper for one dataset directory."""

    data_path: str
    dataset: str

    @property
    def root(self) -> str:
        return os.path.join(self.data_path, self.dataset)

    def path(self, suffix: str) -> str:
        return os.path.join(self.root, f"{self.dataset}{suffix}")

    def _load(self, suffix: str) -> Any:
        with open(self.path(suffix)) as f:
            return json.load(f)

    def _save(self, suffix: str, obj: Any) -> str:
        os.makedirs(self.root, exist_ok=True)
        p = self.path(suffix)
        with open(p, "w") as f:
            json.dump(obj, f)
        return p

    # ---- single-behavior ---------------------------------------------------
    def load_inter(self, inter_type: str | None = None) -> dict[str, list[int]]:
        suffix = f".{inter_type}.inter.json" if inter_type else ".inter.json"
        return self._load(suffix)

    def load_item_meta(self) -> dict[str, dict]:
        return self._load(".item.json")

    def load_index(self, index_file: str = ".index.json") -> dict[str, list[str]]:
        return self._load(index_file)

    # ---- multi-behavior ----------------------------------------------------
    def load_mb_inter(self) -> dict[str, list[int]]:
        return self._load(".MB.inter.json")

    def load_mb_behavior(self) -> dict[str, list[str]]:
        return self._load(".MB.behavior.json")

    def load_behavior_level(self) -> dict[str, int]:
        return self._load(".behavior_level.json")

    # ---- session-wise multi-behavior ---------------------------------------
    def load_smb_inter(self) -> dict[str, list[int]]:
        return self._load(".SMB.inter.json")

    def load_smb_behavior(self) -> dict[str, list[str]]:
        return self._load(".SMB.behavior.json")

    def load_smb_session(self) -> dict[str, list[int]]:
        return self._load(".SMB.session.json")

    def load_smb_time(self) -> dict[str, list[str]]:
        return self._load(".SMB.time.json")

    def has(self, suffix: str) -> bool:
        return os.path.exists(self.path(suffix))

    # ---- embeddings --------------------------------------------------------
    def load_embeddings(self, plm: str = "llama", suffix: str = "td") -> np.ndarray:
        return np.load(self.path(f".emb-{plm}-{suffix}.npy"))

    def save_embeddings(self, emb: np.ndarray, plm: str = "llama", suffix: str = "td") -> str:
        os.makedirs(self.root, exist_ok=True)
        p = self.path(f".emb-{plm}-{suffix}.npy")
        np.save(p, emb)
        return p

    # ---- writers (synthetic generation / tokenize outputs) -----------------
    def save_inter(self, inters: Mapping[str, list[int]], inter_type: str | None = None) -> str:
        suffix = f".{inter_type}.inter.json" if inter_type else ".inter.json"
        return self._save(suffix, dict(inters))

    def save_item_meta(self, meta: Mapping[str, dict]) -> str:
        return self._save(".item.json", dict(meta))

    def save_index(self, indices: Mapping[str, list[str]], index_file: str = ".index.json") -> str:
        return self._save(index_file, dict(indices))

    def save_mb(self, inters: Mapping[str, list[int]], behaviors: Mapping[str, list[str]]) -> None:
        self._save(".MB.inter.json", dict(inters))
        self._save(".MB.behavior.json", dict(behaviors))

    def save_behavior_level(self, levels: Mapping[str, int]) -> str:
        return self._save(".behavior_level.json", dict(levels))

    def save_smb(
        self,
        inters: Mapping[str, list[int]],
        behaviors: Mapping[str, list[str]],
        sessions: Mapping[str, list[int]],
        times: Mapping[str, list[str]] | None = None,
    ) -> None:
        self._save(".SMB.inter.json", dict(inters))
        self._save(".SMB.behavior.json", dict(behaviors))
        self._save(".SMB.session.json", dict(sessions))
        if times is not None:
            self._save(".SMB.time.json", dict(times))


def target_behavior(levels: Mapping[str, int]) -> str:
    """The unique max-level behavior (ref: SeqRec/datasets/SMB_dataset.py:140-147)."""
    max_level = max(levels.values())
    winners = [b for b, l in levels.items() if l == max_level]
    if len(winners) != 1:
        raise ValueError(f"Expected exactly one max-level behavior, got {winners}")
    return winners[0]
