"""Port parity of the single- and multi-behavior data (`gamer_tpu_torch/data/seq.py`,
`tasks/train_mb_decoder.load_mb_train`) on the CPU against the JAX package's:
corpus arrays, examples of every split and MB task (with and without
`filter_target`, ForDecoder augmentation), the per-behavior filter and the
collated train and decode batches, all equal bit for bit (`np.array_equal`
and dtype). Each package reads its own copy of one synthetic spec."""

import numpy as np
import pytest

from gamer_tpu.data import batching as JB
from gamer_tpu.data import synthetic as JS
from gamer_tpu.data.contract import DataFiles as JaxFiles
from gamer_tpu.data.seq import MBExampleBuilder as JaxMB
from gamer_tpu.data.seq import SeqCorpus as JaxCorpus
from gamer_tpu.data.seq import SeqExampleBuilder as JaxSeq
from gamer_tpu.data.seq import filter_mb_examples as jax_filter
from gamer_tpu.tasks.train_mb_decoder import load_mb_train as jax_load_mb
from gamer_tpu_torch.data import batching as TB
from gamer_tpu_torch.data import synthetic as TS
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.seq import MBExampleBuilder, SeqCorpus, SeqExampleBuilder
from gamer_tpu_torch.data.seq import filter_mb_examples
from gamer_tpu_torch.tasks.train_mb_decoder import load_mb_train
from tests.test_torch_data import _same

# the MB test spec of tests/test_mb_tasks.py (conftest `synth_data`)
SPEC = dict(n_users=24, n_items=60, n_clusters=4, min_len=8, max_len=24, num_levels=3,
            level_sizes=(8, 8, 16), emb_dim=32, seed=7)
CORPUS_FIELDS = ("users", "user_items", "user_behaviors", "item_ids", "item_codes",
                 "collision_rows", "sole_item_len", "behavior_names", "behavior_levels",
                 "target_behavior_idx")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("seq_parity")
    JS.write_synthetic_dataset(str(root / "jax"), "Synth", JS.SyntheticSpec(**SPEC))
    TS.write_synthetic_dataset(str(root / "port"), "Synth", TS.SyntheticSpec(**SPEC))
    return str(root / "jax"), str(root / "port")


def _corpora(dirs, multi):
    return (JaxCorpus(JaxFiles(dirs[0], "Synth"), multi_behavior=multi),
            SeqCorpus(DataFiles(dirs[1], "Synth"), multi_behavior=multi))


@pytest.mark.parametrize("multi", [False, True])
def test_seq_corpus_arrays_equal(dirs, multi):
    jc, tc = _corpora(dirs, multi)
    for name in CORPUS_FIELDS:
        _same(getattr(jc, name), getattr(tc, name), name)
    _same(jc.vocab.__dict__, tc.vocab.__dict__, "vocab")


@pytest.mark.parametrize("mode", ["train", "valid", "test"])
def test_seq_examples_equal(dirs, mode):
    jc, tc = _corpora(dirs, False)
    want, got = JaxSeq(jc, 6).build(mode), SeqExampleBuilder(tc, 6).build(mode)
    assert len(got) > 0
    _same(want, got, mode)


@pytest.mark.parametrize("filter_target", [False, True])
@pytest.mark.parametrize("task", ["mb", "mb_explicit", "mb_explicit_back", "mb_explicit_decoder",
                                  "mb_explicit_decoder_4"])
def test_mb_train_valid_test_examples_equal(dirs, task, filter_target):
    """`load_mb_train` (layout, train and valid) and the test split of every
    MB task; the ForDecoder tasks with augmentation None and 4."""
    want = jax_load_mb("Synth", dirs[0], 6, ".index.json", task, filter_target)
    got = load_mb_train("Synth", dirs[1], 6, ".index.json", task, filter_target)
    _same(want[1].__dict__, got[1].__dict__, "layout")
    _same(want[2], got[2], "train")
    _same(want[3], got[3], "valid")
    test = (JaxMB(want[0], want[1], 6, filter_target).build("test"),
            MBExampleBuilder(got[0], got[1], 6, filter_target).build("test"))
    _same(*test, "test")
    if task == "mb_explicit_decoder_4":  # augmentation adds copies
        assert len(got[2]) > len(MBExampleBuilder(got[0], got[1], 6).build_decoder_train())


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_mb_filter_and_batches_equal(dirs, route, monkeypatch):
    """`filter_mb_examples` per behavior, the train batches of the MB
    batcher (behavior tokens masked from the labels) and the decode batches
    with extra 0 and 1 (the behavior token and action level appended, one
    value or one per row), on the native C++ and the numpy route."""
    from gamer_tpu import native as JN
    from gamer_tpu_torch import native as TN

    if route == "numpy":
        monkeypatch.setattr(JN, "_load", lambda: None)
        monkeypatch.setattr(TN, "_load", lambda: None)
    jc, tc = _corpora(dirs, True)
    layout = load_mb_train("Synth", dirs[1], 6, ".index.json", "mb_explicit", False)[1]
    jtest = JaxMB(jc, layout, 6).build("test")
    ttest = MBExampleBuilder(tc, layout, 6).build("test")
    for b in range(len(tc.behavior_names)):
        _same(jax_filter(jtest, b), filter_mb_examples(ttest, b), f"behavior {b}")
    jb = JB.DecoderBatcher.for_examples(jtest, pad_multiple=8,
                                        behavior_token_ids=jc.vocab.behavior_token_ids)
    tb = TB.DecoderBatcher.for_examples(ttest, pad_multiple=8,
                                        behavior_token_ids=tc.vocab.behavior_token_ids)
    _same(jb.collate(jtest[:8]), tb.collate(ttest[:8]), "train batch")
    behs = np.array([int(e.target_behaviors[0]) for e in ttest[:8]])
    btoks = np.array([tc.vocab.behavior_token(tc.behavior_names[b]) for b in behs])
    for extra, kw in ((0, {}),
                      (1, dict(append_behavior_token=btoks,
                               append_action_level=tc.behavior_levels[behs])),
                      (1, dict(append_behavior_token=int(btoks[0]), append_action_level=2))):
        want = JB.DecodeBatcher.for_examples(jtest, extra=extra).collate(jtest[:8], **kw)
        got = TB.DecodeBatcher.for_examples(ttest, extra=extra).collate(ttest[:8], **kw)
        _same(want, got, f"decode batch extra={extra} {sorted(kw)}")
