"""The dataset files the synthetic generator writes, in the on-disk data
contract the port reads (`<ds>/<ds>.inter.json`, `.item.json`,
`.index.json`, `.behavior_level.json`, `.MB.{inter,behavior}.json`,
`.SMB.{inter,behavior,session,time}.json`, `.emb-<plm>-td.npy`); the
writers of the port's `data/contract.DataFiles`, frozen."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np


@dataclass
class DataFiles:
    data_path: str
    dataset: str

    @property
    def root(self) -> str:
        return os.path.join(self.data_path, self.dataset)

    def path(self, suffix: str) -> str:
        return os.path.join(self.root, f"{self.dataset}{suffix}")

    def _save(self, suffix: str, obj) -> str:
        os.makedirs(self.root, exist_ok=True)
        p = self.path(suffix)
        with open(p, "w") as f:
            json.dump(obj, f)
        return p

    def save_inter(self, inters) -> str:
        return self._save(".inter.json", dict(inters))

    def save_item_meta(self, meta) -> str:
        return self._save(".item.json", dict(meta))

    def save_index(self, indices, index_file: str = ".index.json") -> str:
        return self._save(index_file, dict(indices))

    def save_mb(self, inters, behaviors) -> None:
        self._save(".MB.inter.json", dict(inters))
        self._save(".MB.behavior.json", dict(behaviors))

    def save_behavior_level(self, levels) -> str:
        return self._save(".behavior_level.json", dict(levels))

    def save_smb(self, inters, behaviors, sessions, times=None) -> None:
        self._save(".SMB.inter.json", dict(inters))
        self._save(".SMB.behavior.json", dict(behaviors))
        self._save(".SMB.session.json", dict(sessions))
        if times is not None:
            self._save(".SMB.time.json", dict(times))

    def save_embeddings(self, emb: np.ndarray, plm: str = "llama", suffix: str = "td") -> str:
        os.makedirs(self.root, exist_ok=True)
        p = self.path(f".emb-{plm}-{suffix}.npy")
        np.save(p, emb)
        return p
