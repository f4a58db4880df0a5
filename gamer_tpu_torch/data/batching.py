"""Static-shape batching.

The port's copy of `gamer_tpu/data/batching.py`. It replaces the
reference's dynamic `padding="longest"` HF collators
(ref: SeqRec/datasets/collator.py) with fixed-length batches: all batches in
a run share one sequence length (the dataset maximum, rounded up), so the
kernels see one shape, and the last partial batch is padded with empty rows
rather than dropped or dynamically shaped.

Batch dict contract (decoder-only models):
  input_ids             [B, S] int32   right-padded (train) / left-padded (decode)
  attention_mask        [B, S] int32   1 = real token
  labels                [B, S] int32   -100 where loss is masked
  session_ids           [B, S] int32
  extended_session_ids  [B, S] int32
  actions               [B, S] int32   pad = 100  (ref collator.py:99)
  time                  [B, S] f32     pad = -1
  row_valid             [B]    int32   1 = real example (0 = batch padding row)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from gamer_tpu_torch.data.smb import ACTION_PAD, TIME_PAD, SMBExample
from gamer_tpu_torch.data.vocab import PAD_ID

IGNORE_LABEL = -100


def _round_up(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple) if multiple > 1 else n


@dataclass
class DecoderBatcher:
    """Builds train/valid batches: [prompt + target] with full-stream labels.

    Mirrors DecoderOnlyCollator semantics (ref collator.py:47-107): labels are
    the full token stream with pads masked, behavior tokens masked, and the
    prompt masked when `only_train_response` or split == valid.
    """

    seq_len: int
    behavior_token_ids: Sequence[int] = ()
    only_train_response: bool = False
    pad_multiple: int = 8

    @classmethod
    def for_examples(cls, examples: Sequence[SMBExample], pad_multiple: int = 8, **kw) -> "DecoderBatcher":
        max_len = max((len(e.prompt) + e.targets.size for e in examples), default=8)
        return cls(seq_len=_round_up(max_len, pad_multiple), pad_multiple=pad_multiple, **kw)

    def collate(self, examples: Sequence[SMBExample]) -> dict[str, np.ndarray]:
        from gamer_tpu_torch import native

        B, S = len(examples), self.seq_len
        rows = [np.concatenate([ex.prompt, ex.targets.reshape(-1)]) for ex in examples]
        lengths = np.minimum([len(r) for r in rows], S)
        input_ids = native.pad_rows(rows, S, PAD_ID, left_align=True)
        attention = (np.arange(S)[None, :] < lengths[:, None]).astype(np.int32)
        prompt_lens = np.array(
            [len(ex.prompt) if (self.only_train_response or ex.split == "valid") else -1
             for ex in examples], dtype=np.int64)
        labels = native.mask_labels(input_ids, attention, self.behavior_token_ids,
                                    prompt_lens, IGNORE_LABEL)
        out = {
            "input_ids": input_ids,
            "attention_mask": attention,
            "labels": labels,
            "session_ids": native.pad_rows([ex.session_ids for ex in examples], S, 0),
            "extended_session_ids": native.pad_rows(
                [ex.extended_session_ids for ex in examples], S, 0),
            "actions": native.pad_rows([ex.actions for ex in examples], S, ACTION_PAD),
            "time": native.pad_rows([ex.time for ex in examples], S, TIME_PAD,
                                    dtype=np.float64),
            "row_valid": np.ones(B, dtype=np.int32),
        }
        return out


@dataclass
class DecodeBatcher:
    """Left-padded prompt batches for constrained generation.

    Mirrors DecoderOnlyTestCollator (ref collator.py:149-207): prompts are
    left-padded; when `append_behavior` the behavior token for the evaluated
    behavior is appended and the per-token streams get one extra slot whose
    session id / extended session id are (max + 1) and whose action is the
    target behavior's level (the remaining generated item tokens extend these
    streams inside the decode loop).
    """

    seq_len: int
    pad_multiple: int = 8

    @classmethod
    def for_examples(cls, examples: Sequence[SMBExample], extra: int = 1, pad_multiple: int = 8) -> "DecodeBatcher":
        max_len = max((len(e.prompt) for e in examples), default=8) + extra
        return cls(seq_len=_round_up(max_len, pad_multiple), pad_multiple=pad_multiple)

    def collate(
        self,
        examples: Sequence[SMBExample],
        append_behavior_token: int | Sequence[int] | None = None,
        append_action_level: int | Sequence[int] | None = None,
    ) -> dict[str, np.ndarray]:
        B, S = len(examples), self.seq_len
        if append_behavior_token is not None and not np.isscalar(append_behavior_token):
            append_behavior_token = np.asarray(append_behavior_token)
        if append_action_level is not None and not np.isscalar(append_action_level):
            append_action_level = np.asarray(append_action_level)
        out = {
            "input_ids": np.full((B, S), PAD_ID, dtype=np.int32),
            "attention_mask": np.zeros((B, S), dtype=np.int32),
            "session_ids": np.zeros((B, S), dtype=np.int32),
            "extended_session_ids": np.zeros((B, S), dtype=np.int32),
            "actions": np.full((B, S), ACTION_PAD, dtype=np.int32),
            "time": np.full((B, S), TIME_PAD, dtype=np.float32),
            "prompt_len": np.zeros(B, dtype=np.int32),
            "row_valid": np.ones(B, dtype=np.int32),
        }
        for i, ex in enumerate(examples):
            toks = ex.prompt
            if append_behavior_token is not None:
                btok = (append_behavior_token if np.isscalar(append_behavior_token)
                        else append_behavior_token[i])
                toks = np.concatenate([toks, [btok]])
            T = len(toks)
            assert T <= S, f"prompt length {T} exceeds seq_len {S}"
            out["input_ids"][i, S - T:] = toks
            out["attention_mask"][i, S - T:] = 1
            out["prompt_len"][i] = T
            sid = ex.session_ids
            esid = ex.extended_session_ids
            act = ex.actions
            if append_behavior_token is not None:
                new_sid = (sid.max() + 1) if len(sid) else 0
                new_esid = (esid.max() + 1) if len(esid) else 0
                sid = np.concatenate([sid, [new_sid]])
                esid = np.concatenate([esid, [new_esid]])
                if append_action_level is None:
                    level = ACTION_PAD
                elif np.isscalar(append_action_level):
                    level = append_action_level
                else:
                    level = append_action_level[i]
                act = np.concatenate([act, [level]])
            for key, stream, pad in (
                ("session_ids", sid, 0),
                ("extended_session_ids", esid, 0),
                ("actions", act, ACTION_PAD),
                ("time", ex.time, TIME_PAD),
            ):
                L = min(len(stream), S)
                out[key][i, S - L:] = stream[:L]
        return out


@dataclass
class EncDecBatcher:
    """Encoder-decoder batches (TIGER/PBATransformer).

    Mirrors EncoderDecoderCollator (ref collator.py:7-44): encoder inputs
    right-padded with EOS appended; labels = target tokens + EOS with pads
    masked to -100 (decoder inputs are derived by shift_right in the model).
    """

    enc_len: int
    dec_len: int
    eos_id: int = 1
    pad_multiple: int = 8

    @classmethod
    def for_examples(cls, examples: Sequence[SMBExample], pad_multiple: int = 8,
                     **kw) -> "EncDecBatcher":
        enc = max((len(e.prompt) for e in examples), default=4) + 1  # + EOS
        dec = max((e.targets.shape[1] for e in examples), default=4) + 1
        return cls(enc_len=_round_up(enc, pad_multiple), dec_len=dec,
                   pad_multiple=pad_multiple, **kw)

    def collate(self, examples: Sequence[SMBExample]) -> dict[str, np.ndarray]:
        B = len(examples)
        out = {
            "input_ids": np.full((B, self.enc_len), PAD_ID, dtype=np.int32),
            "attention_mask": np.zeros((B, self.enc_len), dtype=np.int32),
            "labels": np.full((B, self.dec_len), IGNORE_LABEL, dtype=np.int32),
            "row_valid": np.ones(B, dtype=np.int32),
        }
        for i, ex in enumerate(examples):
            toks = np.concatenate([ex.prompt, [self.eos_id]])[: self.enc_len]
            out["input_ids"][i, : len(toks)] = toks
            out["attention_mask"][i, : len(toks)] = 1
            lab = np.concatenate([ex.targets[0], [self.eos_id]])[: self.dec_len]
            out["labels"][i, : len(lab)] = lab
        return out


def iterate_batches(
    examples: Sequence[SMBExample],
    batch_size: int,
    collate_fn,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    pad_final: bool = True,
) -> Iterator[dict[str, np.ndarray]]:
    """Yield fixed-size batches; the final partial batch is padded with repeated
    examples flagged row_valid=0 so shapes stay static."""
    order = np.arange(len(examples))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    n = len(order)
    stop = n - (n % batch_size) if drop_last else n
    for start in range(0, stop, batch_size):
        idx = order[start:start + batch_size]
        n_real = len(idx)
        if n_real < batch_size:
            if not pad_final:
                continue
            idx = np.concatenate([idx, np.full(batch_size - n_real, idx[0])])
        batch = collate_fn([examples[j] for j in idx])
        if n_real < batch_size:
            batch["row_valid"] = (np.arange(batch_size) < n_real).astype(np.int32)
        yield batch
