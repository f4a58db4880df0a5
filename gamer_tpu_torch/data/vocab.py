"""Semantic-ID vocabulary: integer token space for items, behaviors, specials.

The reference round-trips every example through strings — items become
`"<a_12><b_7><c_201>"` and an HF tokenizer maps the strings back to ids
(ref: SeqRec/datasets/seq_dataset.py:90-94, SeqRec/tasks/train_SMB_decoder.py:251-252).
That string detour is an implementation detail, not a capability: here items are
integer code rows end-to-end and the vocabulary is a fixed arithmetic layout,
so "tokenization" is an O(1) table lookup and never allocates strings.

Token-id layout (level-major, disjoint level ranges — this disjointness is what
makes the decode-time trie a leveled DAG, see decode/trie.py):

  [0, n_special)                         special tokens (pad=0, eos=1, bos=2, unk=3, rest reserved)
  [n_special, n_special + n_behavior)    behavior tokens <behavior_X>
  [code_base + off[l], code_base + off[l] + level_sizes[l])   level-l codes <{letter}_{c}>

String forms (`<a_12>`, `<behavior_buy>`) are kept for interop with the
reference's `.index.json` contract files only.
"""

from __future__ import annotations

import json
import re
from typing import Mapping, Sequence

import numpy as np

PAD_ID = 0
EOS_ID = 1
BOS_ID = 2
UNK_ID = 3
# Mirror the reference's base vocab of 14 special tokens
# (ref: config/s2s-models/Qwen3-Light tokenizer files; SURVEY.md section 2.6).
DEFAULT_N_SPECIAL = 14

_CODE_RE = re.compile(r"^<([a-z])_(\d+)>$")
_BEHAVIOR_RE = re.compile(r"^<behavior_(.+)>$")


class SemanticVocab:
    """Arithmetic vocabulary over semantic-ID codes + behavior tokens."""

    def __init__(
        self,
        level_sizes: Sequence[int],
        behaviors: Sequence[str] = (),
        n_special: int = DEFAULT_N_SPECIAL,
    ):
        self.level_sizes = tuple(int(s) for s in level_sizes)
        self.num_levels = len(self.level_sizes)
        self.behaviors = tuple(behaviors)
        self.n_special = int(n_special)
        self.behavior_base = self.n_special
        self.code_base = self.n_special + len(self.behaviors)
        self.level_offsets = np.concatenate([[0], np.cumsum(self.level_sizes)]).astype(np.int64)
        self.vocab_size = int(self.code_base + self.level_offsets[-1])
        self._behavior_to_id = {b: self.behavior_base + i for i, b in enumerate(self.behaviors)}

    # ---- codes <-> tokens -------------------------------------------------

    def code_token(self, level: int, code: int) -> int:
        return int(self.code_base + self.level_offsets[level] + code)

    def encode_codes(self, codes: np.ndarray) -> np.ndarray:
        """[..., L] per-level codes -> [..., L] token ids (vectorized)."""
        codes = np.asarray(codes, dtype=np.int64)
        if codes.shape[-1] != self.num_levels:
            raise ValueError(f"expected last dim {self.num_levels}, got {codes.shape}")
        return codes + self.code_base + self.level_offsets[: self.num_levels]

    def decode_tokens(self, tokens: np.ndarray) -> np.ndarray:
        """[..., L] token ids -> [..., L] per-level codes."""
        tokens = np.asarray(tokens, dtype=np.int64)
        return tokens - self.code_base - self.level_offsets[: self.num_levels]

    def token_level(self, token: int) -> int:
        """Level of a code token, -1 for non-code tokens."""
        if token < self.code_base:
            return -1
        rel = token - self.code_base
        return int(np.searchsorted(self.level_offsets, rel, side="right") - 1)

    # ---- behaviors --------------------------------------------------------

    def behavior_token(self, behavior: str) -> int:
        return self._behavior_to_id[behavior]

    @property
    def behavior_token_ids(self) -> list[int]:
        return [self._behavior_to_id[b] for b in self.behaviors]

    def is_behavior_token(self, token: int) -> bool:
        return self.behavior_base <= token < self.code_base

    # ---- string interop (reference .index.json contract) ------------------

    def token_to_string(self, token: int) -> str:
        if token == PAD_ID:
            return "<pad>"
        if token == EOS_ID:
            return "</s>"
        if token == BOS_ID:
            return "<s>"
        if token < self.n_special:
            return f"<special_{token}>"
        if token < self.code_base:
            return f"<behavior_{self.behaviors[token - self.behavior_base]}>"
        rel = token - self.code_base
        level = int(np.searchsorted(self.level_offsets, rel, side="right") - 1)
        code = rel - self.level_offsets[level]
        return f"<{chr(ord('a') + level)}_{code}>"

    def string_to_token(self, s: str) -> int:
        m = _CODE_RE.match(s)
        if m:
            return self.code_token(ord(m.group(1)) - ord("a"), int(m.group(2)))
        m = _BEHAVIOR_RE.match(s)
        if m:
            return self._behavior_to_id[m.group(1)]
        return {"<pad>": PAD_ID, "</s>": EOS_ID, "<s>": BOS_ID}.get(s, UNK_ID)

    # ---- construction from .index.json ------------------------------------

    @staticmethod
    def infer_level_sizes(indices: Mapping[str, Sequence[str]]) -> list[int]:
        """Scan `.index.json` values (`["<a_3>", "<b_17>", ...]`) for level sizes."""
        max_code: dict[int, int] = {}
        for toks in indices.values():
            for t in toks:
                m = _CODE_RE.match(t)
                if not m:
                    raise ValueError(f"Unparseable semantic-ID token {t!r}")
                lvl = ord(m.group(1)) - ord("a")
                max_code[lvl] = max(max_code.get(lvl, -1), int(m.group(2)))
        n_levels = max(max_code) + 1
        return [max_code.get(l, -1) + 1 for l in range(n_levels)]

    @classmethod
    def from_index_json(
        cls,
        indices: Mapping[str, Sequence[str]],
        behaviors: Sequence[str] = (),
        n_special: int = DEFAULT_N_SPECIAL,
        level_sizes: Sequence[int] | None = None,
    ) -> "SemanticVocab":
        if level_sizes is None:
            level_sizes = cls.infer_level_sizes(indices)
        return cls(level_sizes, behaviors=behaviors, n_special=n_special)

    def item_code_table(self, indices: Mapping[str, Sequence[str]]) -> tuple[np.ndarray, np.ndarray]:
        """Build the [n_items, L] token-id matrix from an `.index.json` dict.

        Returns (item_ids, code_matrix): row r of code_matrix is the token-id
        sequence for item item_ids[r]. Item ids are the sorted integer keys.
        """
        item_ids = np.array(sorted(int(k) for k in indices), dtype=np.int64)
        L = self.num_levels
        mat = np.zeros((len(item_ids), L), dtype=np.int32)
        for r, iid in enumerate(item_ids):
            toks = indices[str(iid)]
            if len(toks) != L:
                raise ValueError(f"item {iid}: expected {L} tokens, got {len(toks)}")
            for l, t in enumerate(toks):
                mat[r, l] = self.string_to_token(t)
        return item_ids, mat

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "level_sizes": list(self.level_sizes),
                    "behaviors": list(self.behaviors),
                    "n_special": self.n_special,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "SemanticVocab":
        with open(path) as f:
            d = json.load(f)
        return cls(d["level_sizes"], d["behaviors"], d["n_special"])


def find_collisions(code_matrix: np.ndarray) -> np.ndarray:
    """Boolean mask of rows whose full code sequence duplicates an earlier row
    (the reference's 'collision items', ref: SeqRec/datasets/SMB_dataset.py:387-395)."""
    _, first_idx, inverse = np.unique(
        code_matrix, axis=0, return_index=True, return_inverse=True
    )
    is_first = np.zeros(len(code_matrix), dtype=bool)
    is_first[first_idx] = True
    return ~is_first
