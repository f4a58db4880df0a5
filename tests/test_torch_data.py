"""Port parity of the data plane on the CPU: the synthetic generator, the SMB
corpus and examples, the batchers, the C++ example store and the ranking
metrics of gamer_tpu_torch against the JAX package's, equal bit for bit.

Each package writes the same synthetic spec into a directory of its own and
reads its own copy back (the corpus cache lives beside the data, so one
shared directory would let one package read the other's cache). Collation
is compared on both routes: the native C++ library and the numpy fallback.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from gamer_tpu import native as JN
from gamer_tpu.data import batching as JB
from gamer_tpu.data import synthetic as JS
from gamer_tpu.data.loading_smb import load_smb_test as jax_load_test
from gamer_tpu.data.loading_smb import load_smb_train as jax_load_train
from gamer_tpu.evaluation import ranking as JR
from gamer_tpu_torch import native as TN
from gamer_tpu_torch.data import batching as TB
from gamer_tpu_torch.data import synthetic as TS
from gamer_tpu_torch.data.loading_smb import load_smb_test, load_smb_train
from gamer_tpu_torch.evaluation import ranking as TR

SPEC = dict(n_users=30, n_items=40, num_levels=2, level_sizes=(8, 10), min_len=6, max_len=16,
            seed=11)
MAX_HIS = 6


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """(JAX package's dataset dir, the port's), the same spec written by each."""
    root = tmp_path_factory.mktemp("data_parity")
    JS.write_synthetic_dataset(str(root / "jax"), "Demo", JS.SyntheticSpec(**SPEC))
    TS.write_synthetic_dataset(str(root / "port"), "Demo", TS.SyntheticSpec(**SPEC))
    return str(root / "jax"), str(root / "port")


def _same(a, b, where=""):
    """Equal values of one type: arrays by np.array_equal (and dtype),
    dataclasses and containers field by field."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def test_synthetic_files_are_byte_identical(dirs):
    jdir, tdir = dirs
    names = sorted(os.listdir(os.path.join(jdir, "Demo")))
    assert names and names == sorted(os.listdir(os.path.join(tdir, "Demo")))
    match, mismatch, errors = filecmp.cmpfiles(os.path.join(jdir, "Demo"),
                                               os.path.join(tdir, "Demo"), names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_corpus_arrays_equal(dirs):
    jc = jax_load_test("Demo", dirs[0], MAX_HIS, ".index.json", "smb_explicit").corpus
    tc = load_smb_test("Demo", dirs[1], MAX_HIS, ".index.json", "smb_explicit").corpus
    for name in ("users", "user_items", "user_behaviors", "user_sessions", "user_times",
                 "valid_pos", "test_pos", "item_codes", "collision_rows", "behavior_names",
                 "behavior_levels", "target_behavior_idx", "sole_item_len"):
        _same(getattr(jc, name), getattr(tc, name), name)
    _same(jc.vocab.behavior_token_ids, tc.vocab.behavior_token_ids, "behavior_token_ids")
    assert (jc.vocab.vocab_size, jc.vocab.behavior_base, jc.vocab.code_base) == (
        tc.vocab.vocab_size, tc.vocab.behavior_base, tc.vocab.code_base)


@pytest.mark.parametrize("task", ["smb_explicit_decoder_4", "smb_explicit"])
def test_examples_equal(dirs, task):
    """Train, valid and test examples (every field of every example)."""
    jd = jax_load_train("Demo", dirs[0], MAX_HIS, ".index.json", task)
    td = load_smb_train("Demo", dirs[1], MAX_HIS, ".index.json", task)
    assert len(td.train) > 0 and len(td.valid) > 0
    _same(jd.train, td.train, "train")
    _same(jd.valid, td.valid, "valid")
    jt = jax_load_test("Demo", dirs[0], MAX_HIS, ".index.json", "smb_explicit").test
    tt = load_smb_test("Demo", dirs[1], MAX_HIS, ".index.json", "smb_explicit").test
    _same(jt, tt, "test")


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_collation_equal(dirs, route, monkeypatch):
    """DecoderBatcher, DecodeBatcher (with the appended behavior token and
    action level) and ExampleStore.collate / iterate, on the C++ library and
    on the numpy fallback."""
    if route == "numpy":
        monkeypatch.setattr(JN, "_load", lambda: None)
        monkeypatch.setattr(TN, "_load", lambda: None)
    else:
        assert JN._load() is not None and TN._load() is not None and TN.AVAILABLE
    task = "smb_explicit_decoder_4"
    jd = jax_load_train("Demo", dirs[0], MAX_HIS, ".index.json", task)
    td = load_smb_train("Demo", dirs[1], MAX_HIS, ".index.json", task)
    beh_ids = td.corpus.vocab.behavior_token_ids
    jbat = JB.DecoderBatcher.for_examples(jd.train + jd.valid, pad_multiple=24,
                                          behavior_token_ids=beh_ids)
    tbat = TB.DecoderBatcher.for_examples(td.train + td.valid, pad_multiple=24,
                                          behavior_token_ids=beh_ids)
    assert jbat.seq_len == tbat.seq_len
    _same(jbat.collate(jd.train[:7] + jd.valid[:3]), tbat.collate(td.train[:7] + td.valid[:3]))
    for j, t in zip(JB.iterate_batches(jd.valid, 8, jbat.collate, shuffle=True, seed=3),
                    TB.iterate_batches(td.valid, 8, tbat.collate, shuffle=True, seed=3)):
        _same(j, t)

    jt = jax_load_test("Demo", dirs[0], MAX_HIS, ".index.json", "smb_explicit").test
    tt = load_smb_test("Demo", dirs[1], MAX_HIS, ".index.json", "smb_explicit").test
    jdec, tdec = JB.DecodeBatcher.for_examples(jt, extra=1), TB.DecodeBatcher.for_examples(tt,
                                                                                      extra=1)
    toks = np.asarray(beh_ids)[np.arange(len(tt)) % len(beh_ids)].astype(np.int32)
    levels = (np.arange(len(tt)) % 3 + 1).astype(np.int32)
    _same(jdec.collate(jt, append_behavior_token=toks, append_action_level=levels),
          tdec.collate(tt, append_behavior_token=toks, append_action_level=levels))
    _same(jdec.collate(jt[:5]), tdec.collate(tt[:5]))

    jstore = JN.ExampleStore(jd.train, beh_ids)
    tstore = TN.ExampleStore(td.train, beh_ids)
    _same(jstore.collate([3, 0, 5, 5], jbat.seq_len), tstore.collate([3, 0, 5, 5], tbat.seq_len))
    for j, t in zip(jstore.iterate(16, jbat.seq_len, shuffle=True, seed=2),
                    tstore.iterate(16, tbat.seq_len, shuffle=True, seed=2)):
        _same(j, t)


def test_ranking_metrics_equal():
    """hits_matrix, metrics_from_hits and merge_behavior_metrics on ragged
    targets, repeated and missing predictions."""
    rng = np.random.default_rng(0)
    preds = rng.integers(0, 4, (9, 6, 3))
    targets = [rng.integers(0, 4, (int(rng.integers(1, 4)), 3)) for _ in range(9)]
    targets[0] = preds[0, 2:4].copy()
    metrics = ["hit@1", "hit@5", "recall@1", "recall@5", "ndcg@5", "ndcg@10"]
    jh, jn = JR.hits_matrix(preds, targets)
    th, tn = TR.hits_matrix(preds, targets)
    _same(jh, th)
    _same(jn, tn)
    jm, tm = JR.metrics_from_hits(jh, jn, metrics), TR.metrics_from_hits(th, tn, metrics)
    _same(jm, tm)
    per = {"click": jm, "buy": {k: v / 2 for k, v in jm.items()}}
    _same(JR.merge_behavior_metrics(per, {"click": 5, "buy": 4}),
          TR.merge_behavior_metrics(per, {"click": 5, "buy": 4}))
