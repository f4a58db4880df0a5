"""Native (C++) data-plane acceleration, loaded via ctypes.

The port's copy of `gamer_tpu/native`. Compiles collate.cpp with g++ -O3 on
first import into `native/_build/` (git-ignored), named by a hash of the
source and of the host's CPU (the library is built with -march=native), and
exposes numpy-friendly wrappers. Every entry point has a pure-numpy fallback,
so the package works without a toolchain; `AVAILABLE` reports which path is
active. Processes that load it at once build it once: they take turns on an
`flock` of `_build/.lock`, and the library appears by an atomic rename.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess

import numpy as np

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.core.logging import get_logger

logger = get_logger("native")

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "collate.cpp")
_lib = None
AVAILABLE = False


def _host_cpu() -> bytes:
    """The host's CPU model, so a library built for one CPU is never loaded on another."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"model name")), b"")
    except OSError:
        return platform.processor().encode()


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        digest = hashlib.md5(f.read() + _host_cpu()).hexdigest()[:12]
    cache_dir = os.path.join(_HERE, "_build")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"collate-{digest}.so")
    with open(os.path.join(cache_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(so_path):
            return so_path
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
               _SRC, "-o", tmp]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
            return so_path
        except Exception as e:  # no toolchain / compile error -> numpy fallback
            logger.warning("native build failed (%s); using numpy fallback", e)
            return None


def _load():
    global _lib, AVAILABLE
    if _lib is not None or AVAILABLE:
        return _lib
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    vpp = ctypes.POINTER(ctypes.c_void_p)
    lib.pad_rows_i32.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                 vpp, i64p, ctypes.c_int32, ctypes.c_int32]
    lib.pad_rows_i64_to_i32.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                        vpp, i64p, ctypes.c_int32, ctypes.c_int32]
    lib.pad_rows_f64_to_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                        vpp, i64p, ctypes.c_float, ctypes.c_int32]
    lib.mask_labels_i32.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int64,
                                    i32p, i32p, ctypes.c_int64, i64p,
                                    ctypes.c_int32]
    lib.repeat_stream_i64.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64]
    lib.gather_pad_i64_to_i32.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                          i64p, i64p, i64p,
                                          ctypes.c_int32, ctypes.c_int32]
    lib.gather_pad_f64_to_f32.argtypes = [f32p, ctypes.c_int64, ctypes.c_int64,
                                          f64p, i64p, i64p,
                                          ctypes.c_float, ctypes.c_int32]
    _lib = lib
    AVAILABLE = True
    return lib


def _row_ptrs(rows: list[np.ndarray]):
    n = len(rows)
    ptrs = (ctypes.c_void_p * n)()
    lens = np.empty(n, dtype=np.int64)
    for i, r in enumerate(rows):
        ptrs[i] = r.ctypes.data
        lens[i] = len(r)
    return ptrs, lens


def pad_rows(rows: list[np.ndarray], cols: int, pad_value=0, left_align=True,
             dtype=np.int32) -> np.ndarray:
    """Ragged rows -> [n, cols] padded matrix (alignment per flag).

    Accepts int32/int64 rows (-> int32 output) or float32/float64 rows
    (-> float32 output when dtype=np.float64/np.float32 is requested)."""
    lib = _load()
    n = len(rows)
    want_float = np.dtype(dtype).kind == "f"
    out_dtype = np.float32 if want_float else np.int32
    rows = [np.ascontiguousarray(r) for r in rows]
    src_dtype = np.float64 if want_float else (
        np.int64 if any(r.dtype != np.int32 for r in rows) else np.int32)
    if lib is None:
        out = np.full((n, cols), pad_value, dtype=out_dtype)
        for i, r in enumerate(rows):
            r = r.astype(out_dtype)[:cols]
            if left_align:
                out[i, :len(r)] = r
            else:
                out[i, cols - len(r):] = r
        return out
    rows = [r.astype(src_dtype, copy=False) for r in rows]
    ptrs, lens = _row_ptrs(rows)
    out = np.empty((n, cols), dtype=out_dtype)
    lens_p = lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    vpp = ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p))
    if want_float:
        lib.pad_rows_f64_to_f32(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                n, cols, vpp, lens_p, float(pad_value),
                                int(bool(left_align)))
    elif src_dtype == np.int32:
        lib.pad_rows_i32(out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         n, cols, vpp, lens_p, int(pad_value), int(bool(left_align)))
    else:
        lib.pad_rows_i64_to_i32(out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                n, cols, vpp, lens_p, int(pad_value),
                                int(bool(left_align)))
    return out


def mask_labels(input_ids: np.ndarray, attention: np.ndarray,
                behavior_token_ids, prompt_lens: np.ndarray,
                ignore_label: int = -100) -> np.ndarray:
    """Decoder-only label construction (see collate.cpp)."""
    lib = _load()
    beh = np.sort(np.asarray(list(behavior_token_ids), dtype=np.int32))
    input_ids = np.ascontiguousarray(input_ids, dtype=np.int32)
    attention = np.ascontiguousarray(attention, dtype=np.int32)
    prompt_lens = np.ascontiguousarray(prompt_lens, dtype=np.int64)
    n, cols = input_ids.shape
    if lib is None:
        labels = input_ids.astype(np.int32).copy()
        if len(beh):
            labels[np.isin(labels, beh)] = ignore_label
        labels[attention == 0] = ignore_label
        col = np.arange(cols)[None, :]
        pmask = (prompt_lens[:, None] >= 0) & (col < prompt_lens[:, None])
        labels[pmask] = ignore_label
        return labels
    labels = np.empty_like(input_ids)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.mask_labels_i32(labels.ctypes.data_as(i32p),
                        input_ids.ctypes.data_as(i32p), n, cols,
                        attention.ctypes.data_as(i32p),
                        beh.ctypes.data_as(i32p), len(beh),
                        prompt_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                        ignore_label)
    return labels


class ExampleStore:
    """Arena-resident SMB example set for O(1)-Python batch collation.

    Flattens every example's streams once; `collate(indices, seq_len, ...)`
    then produces the standard decoder batch dict with one native call per
    field. Falls back to numpy gathers when the native library is absent.
    """

    def __init__(self, examples, behavior_token_ids=(), only_train_response=False):
        from gamer_tpu_torch.data.smb import ACTION_PAD, TIME_PAD

        self.n = len(examples)
        self.behavior_token_ids = list(behavior_token_ids)
        self._pads = {"session_ids": 0, "extended_session_ids": 0,
                      "actions": ACTION_PAD, "time": TIME_PAD}
        full = [np.concatenate([e.prompt, e.targets.reshape(-1)]) for e in examples]
        self._fields = {"input_ids": self._arena(full, np.int64)}
        for f in ("session_ids", "extended_session_ids", "actions"):
            self._fields[f] = self._arena([getattr(e, f) for e in examples], np.int64)
        self._fields["time"] = self._arena([e.time for e in examples], np.float64)
        mask_prompt = [only_train_response or e.split == "valid" for e in examples]
        self.prompt_lens = np.array(
            [len(e.prompt) if m else -1 for e, m in zip(examples, mask_prompt)],
            dtype=np.int64)
        self.max_len = int(np.diff(self._fields["input_ids"][1]).max()) if self.n else 8

    @staticmethod
    def _arena(rows, dtype):
        offsets = np.zeros(len(rows) + 1, dtype=np.int64)
        for i, r in enumerate(rows):
            offsets[i + 1] = offsets[i] + len(r)
        flat = (np.concatenate([np.asarray(r, dtype=dtype).ravel() for r in rows])
                if offsets[-1] else np.zeros(0, dtype=dtype))
        return np.ascontiguousarray(flat), offsets

    def _gather(self, field, indices, cols, pad):
        lib = _load()
        flat, offsets = self._fields[field]
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        B = len(indices)
        i64p = ctypes.POINTER(ctypes.c_int64)
        if flat.dtype == np.float64:
            out = np.empty((B, cols), np.float32)
            if lib is None:
                for b, e in enumerate(indices):
                    r = flat[offsets[e]:offsets[e + 1]][:cols]
                    out[b, :] = pad
                    out[b, :len(r)] = r
                return out
            lib.gather_pad_f64_to_f32(
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), B, cols,
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                offsets.ctypes.data_as(i64p), indices.ctypes.data_as(i64p),
                float(pad), 1)
            return out
        out = np.empty((B, cols), np.int32)
        if lib is None:
            for b, e in enumerate(indices):
                r = flat[offsets[e]:offsets[e + 1]][:cols]
                out[b, :] = pad
                out[b, :len(r)] = r
            return out
        lib.gather_pad_i64_to_i32(
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), B, cols,
            flat.ctypes.data_as(i64p), offsets.ctypes.data_as(i64p),
            indices.ctypes.data_as(i64p), int(pad), 1)
        return out

    def collate(self, indices, seq_len: int, ignore_label: int = -100):
        with trace.span("data.collate"):
            return self._collate(indices, seq_len, ignore_label)

    def _collate(self, indices, seq_len: int, ignore_label: int):
        from gamer_tpu_torch.data.vocab import PAD_ID

        indices = np.asarray(indices, dtype=np.int64)
        _, offsets = self._fields["input_ids"]
        lengths = np.minimum(offsets[indices + 1] - offsets[indices], seq_len)
        input_ids = self._gather("input_ids", indices, seq_len, PAD_ID)
        attention = (np.arange(seq_len)[None, :] < lengths[:, None]).astype(np.int32)
        labels = mask_labels(input_ids, attention, self.behavior_token_ids,
                             self.prompt_lens[indices], ignore_label)
        batch = {"input_ids": input_ids, "attention_mask": attention,
                 "labels": labels,
                 "row_valid": np.ones(len(indices), dtype=np.int32)}
        for f, pad in self._pads.items():
            batch[f] = self._gather(f, indices, seq_len, pad)
        return batch

    def iterate(self, batch_size: int, seq_len: int, shuffle=False, seed=0):
        order = np.arange(self.n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for s in range(0, self.n, batch_size):
            idx = order[s:s + batch_size]
            n_real = len(idx)
            if n_real < batch_size:
                idx = np.concatenate([idx, np.full(batch_size - n_real, idx[0])])
            batch = self.collate(idx, seq_len)
            if n_real < batch_size:
                batch["row_valid"] = (np.arange(batch_size) < n_real).astype(np.int32)
            yield batch
