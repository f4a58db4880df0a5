"""The discriminative zoo's data plane, ranking and losses in the port
against the JAX package's: `SMBDisBuilder` and `DisBatcher` byte-identical
for every variant, `rank_targets` and `dis_eval_metrics` identical on
scores with ties and NaN, `sequence_ce_loss`, `bpr_loss` and `info_nce` at
1e-6. Each package reads its own copy of the same synthetic dataset (the
corpus cache lives beside the data)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gamer_tpu.data import synthetic as JS
from gamer_tpu.data.contract import DataFiles as JDataFiles
from gamer_tpu.data.smb import SMBCorpus as JCorpus
from gamer_tpu.data.smb_dis import DisBatcher as JBatcher
from gamer_tpu.data.smb_dis import SMBDisBuilder as JBuilder
from gamer_tpu.modules import losses as JL
from gamer_tpu.tasks import train_smb_rec as JT
from gamer_tpu_torch.data import synthetic as TS
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.smb import SMBCorpus
from gamer_tpu_torch.data.smb_dis import DisBatcher, SMBDisBuilder
from gamer_tpu_torch.modules import losses as TL
from gamer_tpu_torch.tasks import train_smb_rec as PT

SPEC = dict(n_users=30, n_items=40, num_levels=2, level_sizes=(8, 10), min_len=6, max_len=16,
            seed=11)
MAX_HIS = 6


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("dis_data")
    JS.write_synthetic_dataset(str(root / "jax"), "Demo", JS.SyntheticSpec(**SPEC))
    TS.write_synthetic_dataset(str(root / "port"), "Demo", TS.SyntheticSpec(**SPEC))
    return (JCorpus(JDataFiles(str(root / "jax"), "Demo")),
            SMBCorpus(DataFiles(str(root / "port"), "Demo")))


def _same(a, b, where=""):
    """Equal values of one type: arrays by np.array_equal and dtype,
    dataclasses field by field."""
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
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, where


BUILDERS = [dict(), dict(diff=True), dict(add_uid=True), dict(max_his_len=3),
            dict(max_his_len=12)]


@pytest.mark.parametrize("kw", BUILDERS, ids=lambda kw: ",".join(map(str, kw.items())) or "base")
def test_examples_and_batches_are_byte_identical(corpora, kw):
    jc, tc = corpora
    kw = {"max_his_len": MAX_HIS, **kw}
    jb, tb = JBuilder(jc, **kw), SMBDisBuilder(tc, **kw)
    assert (jb.num_items, jb.n_raw_items) == (tb.num_items, tb.n_raw_items)
    for variant in ("base", "target", "neg", "user"):
        jt, tt = jb.build_train(variant, seed=5), tb.build_train(variant, seed=5)
        assert len(jt) > 0
        _same(jt, tt, variant)
        L = max(kw["max_his_len"], 1) + 1
        _same(JBatcher.for_examples(jt, seq_len=L).collate(jt[:16]),
              DisBatcher.for_examples(tt, seq_len=L).collate(tt[:16]), variant + " batch")
    for mode in ("valid", "test"):
        for mask_slot, num_neg in ((False, 0), (True, 0), (True, 25), (False, 1000)):
            je = jb.build_eval(mode, append_mask_slot=mask_slot, num_neg=num_neg, seed=9)
            te = tb.build_eval(mode, append_mask_slot=mask_slot, num_neg=num_neg, seed=9)
            where = f"{mode} mask={mask_slot} neg={num_neg}"
            _same(je, te, where)
            for b in range(len(jc.behavior_names)):
                jf, tf = jb.filter_by_behavior(je, b), tb.filter_by_behavior(te, b)
                assert len(jf) > 0
                _same(jf, tf, f"{where} behavior {b}")
                _same(JBatcher.for_examples(jf).collate(jf),
                      DisBatcher.for_examples(tf).collate(tf), f"{where} behavior {b} batch")


def test_rank_targets_and_metrics_are_identical():
    """Quantized scores (many ties), a NaN row, a constant row, full-sort,
    item_range and sampled (candidate pool) ranks, then every metric."""
    rng = np.random.default_rng(0)
    B, N, T, C = 7, 60, 4, 12
    scores = rng.integers(0, 6, (B, N)).astype(np.float32)
    scores[1] = np.nan
    scores[2] = 3.0
    scores[3, ::7] = np.inf
    targets = rng.integers(0, N, (B, T))
    n_targets = np.array([4, 1, 2, 3, 4, 0, 2])
    metrics = ["hit@1", "hit@5", "hit@10", "recall@1", "recall@5", "recall@10", "ndcg@5",
               "ndcg@10"]
    cands = {"all_item": rng.integers(0, N, (B, C)), "n_targets": n_targets}
    for kw in (dict(), dict(item_range=(10, 40)), dict(candidates=cands)):
        want = JT.rank_targets(scores.copy(), targets, **kw)
        got = PT.rank_targets(scores.copy(), targets, **kw)
        assert got.dtype == want.dtype and np.array_equal(got, want), kw
        assert PT.dis_eval_metrics(got, n_targets, metrics) == JT.dis_eval_metrics(
            want, n_targets, metrics)


def test_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((9, 31)) * 3).astype(np.float32)
    targets = rng.integers(0, 31, 9)
    valid = rng.random(9) < 0.6
    pos, neg = (rng.standard_normal((2, 9)) * 4).astype(np.float32)
    a, p = rng.standard_normal((2, 9, 16)).astype(np.float32)
    t = torch.as_tensor
    pairs = [
        (TL.sequence_ce_loss(t(logits), t(targets)),
         JL.sequence_ce_loss(jnp.asarray(logits), jnp.asarray(targets))),
        (TL.sequence_ce_loss(t(logits), t(targets), t(valid)),
         JL.sequence_ce_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(valid))),
        (TL.sequence_ce_loss(t(logits), t(targets), t(np.zeros(9, bool))),
         JL.sequence_ce_loss(jnp.asarray(logits), jnp.asarray(targets),
                             jnp.zeros(9, bool))),
        (TL.bpr_loss(t(pos), t(neg)), JL.bpr_loss(jnp.asarray(pos), jnp.asarray(neg))),
        (TL.bpr_loss(t(pos), t(neg), t(valid)),
         JL.bpr_loss(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(valid))),
        (TL.info_nce(t(a), t(p)), JL.info_nce(jnp.asarray(a), jnp.asarray(p))),
        (TL.info_nce(t(a), t(p), 0.2, normalize=False),
         JL.info_nce(jnp.asarray(a), jnp.asarray(p), 0.2, normalize=False)),
    ]
    for i, (got, want) in enumerate(pairs):
        got, want = float(got), float(want)
        assert abs(got - want) <= 1e-6 * max(abs(want), 1.0), (i, got, want)


def test_scoring_heads_match_jax():
    """`gather_last`, `full_sort_scores` (with an item range) and
    `sample_sort_scores` at 1e-6."""
    from gamer_tpu.models.discriminative import base as JB
    from gamer_tpu_torch.models.discriminative import base as PB

    rng = np.random.default_rng(2)
    out = rng.standard_normal((5, 7, 16)).astype(np.float32)
    seq_len = np.array([1, 7, 3, 0, 9], np.int32)
    table = rng.standard_normal((41, 16)).astype(np.float32)
    cands = rng.integers(0, 41, (5, 12)).astype(np.int32)
    last = PB.gather_last(torch.as_tensor(out), torch.as_tensor(seq_len))
    np.testing.assert_array_equal(last.numpy(), np.asarray(
        JB.gather_last(jnp.asarray(out), jnp.asarray(seq_len))))
    seq = last.numpy()
    for item_range in (None, (3, 20)):
        got = PB.full_sort_scores(torch.as_tensor(seq), torch.as_tensor(table), item_range)
        want = np.asarray(JB.full_sort_scores(jnp.asarray(seq), jnp.asarray(table), item_range))
        np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    got = PB.sample_sort_scores(torch.as_tensor(seq), torch.as_tensor(table),
                                torch.as_tensor(cands))
    want = np.asarray(JB.sample_sort_scores(jnp.asarray(seq), jnp.asarray(table),
                                            jnp.asarray(cands)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
