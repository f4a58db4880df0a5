"""`python -m gamer_tpu_torch train_SMB_rec` on the CPU for every backbone of
the discriminative zoo: a 2-epoch short train through the CLI (finite
losses, metrics in [0, 1], as `tests/test_zoo_insurance.py` runs the JAX
task), then `--only_test` on a JAX `best` checkpoint (the trained weights
saved by the JAX package's CheckpointManager, converted back by
`convert.py`) against the JAX task's own `--only_test` on it: the same
per-behavior test metrics within 1e-6 and the same counts.

The JAX task's init runs under one `jax.jit` (a test-local wrapper of
flax's `Module.init`): op by op it compiles each primitive on first use.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from gamer_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
from gamer_tpu.data import synthetic as JS
from gamer_tpu.data.contract import DataFiles as JDataFiles
from gamer_tpu.data.smb import SMBCorpus as JCorpus
from gamer_tpu.data.smb_dis import DisBatcher as JBatcher
from gamer_tpu.data.smb_dis import SMBDisBuilder as JBuilder
from gamer_tpu.models.discriminative import DisModelConfig as JaxCfg
from gamer_tpu.tasks import train_smb_rec as JT
from gamer_tpu_torch.convert import state_dict_from_jax, to_flax
from gamer_tpu_torch.core.checkpoint import CheckpointManager
from gamer_tpu_torch.data import synthetic as TS

BACKBONES = ["SASRec", "GRU4Rec", "BERT4Rec", "MBSTR", "PBAT", "MBHT"]
SPEC = dict(n_users=30, n_items=40, num_levels=2, level_sizes=(8, 10), min_len=6, max_len=16,
            seed=11)
MAX_HIS = 6
CFG = dict(n_layers=1, hidden_size=32, inner_size=64, embedding_size=32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Each package's copy of the dataset, and one config for both."""
    root = tmp_path_factory.mktemp("rec")
    JS.write_synthetic_dataset(str(root / "jax"), "Zoo", JS.SyntheticSpec(**SPEC))
    TS.write_synthetic_dataset(str(root / "port"), "Zoo", TS.SyntheticSpec(**SPEC))
    JaxCfg(**CFG).save(str(root / "cfg"))
    return root


def _argv(root, pkg, backbone, out, *extra):
    return ["train_SMB_rec", "--dataset", "Zoo", "--data_path", str(root / pkg),
            "--backbone", backbone, "--max_his_len", str(MAX_HIS), "--base_model",
            str(root / "cfg"), "--seed", "7", "--output_dir", str(out),
            "--result_dir", str(out / "results"), *extra]


_TRAINED = {}


def _trained(root, backbone):
    """The port's 2-epoch short train of `backbone` through the CLI (once
    per backbone and module)."""
    if backbone not in _TRAINED:
        from gamer_tpu_torch.__main__ import main

        out = root / f"port_{backbone}"
        _TRAINED[backbone] = (out, main(_argv(root, "port", backbone, out, "--epochs", "2",
                                              "--patience", "2", "--batch_size", "4",
                                              "--learning_rate", "3e-3", "--device", "cpu")))
    return _TRAINED[backbone]


@pytest.mark.parametrize("backbone", BACKBONES)
def test_short_train_through_the_cli(root, backbone):
    out, res = _trained(root, backbone)
    losses = res["losses"]
    assert len(losses) >= 6 and np.isfinite(losses).all(), (backbone, losses)
    assert np.isfinite(res["best_valid"]), backbone
    assert set(res["test"]) == {"click", "cart", "buy"}
    for behavior, metrics in res["test"].items():
        assert metrics["count"] > 0
        for metric, value in metrics.items():
            if metric != "count":
                assert 0.0 <= value <= 1.0, (backbone, behavior, metric, value)
    assert os.path.exists(out / "best" / "state.pt") and os.path.exists(out / "config.json")
    with open(out / "results" / f"Zoo_{backbone}.json") as f:
        assert json.load(f) == res["test"]


def _jax_template(root, backbone):
    """The flax tree (paths and shapes) the JAX task builds for `backbone`."""
    corpus = JCorpus(JDataFiles(str(root / "jax"), "Zoo"))
    builder = JBuilder(corpus, MAX_HIS, add_uid=backbone == "PBAT")
    cfg = JaxCfg.from_file(str(root / "cfg")).replace(n_behaviors=3)
    L = MAX_HIS + 1 if backbone == "MBHT" else MAX_HIS
    if backbone == "MBHT":  # the task's scale adjustment at length 7
        cfg = cfg.replace(scales=[cfg.scales[0], 1, 7])
    model = JT.build_dis_model(backbone, cfg, builder.num_items, L, 3, len(corpus.users))
    train = builder.build_train()
    b = {k: jax.numpy.asarray(v)
         for k, v in JBatcher.for_examples(train, seq_len=L).collate(train[:2]).items()}
    rng = jax.random.PRNGKey(0)
    M = type(model)
    if backbone in ("SASRec", "GRU4Rec"):
        init = lambda: model.init(rng, b["inputs"], b["seq_len"], None, True,
                                  method=M.encode_with_table)
    elif backbone == "BERT4Rec":
        init = lambda: model.init(rng, b["inputs"], b["seq_len"], rng, method=M.calculate_loss)
    elif backbone == "MBSTR":
        init = lambda: model.init(rng, b["inputs"], b["behaviors"], rng, method=M.calculate_loss)
    elif backbone == "PBAT":
        init = lambda: model.init(rng, b["inputs"], b["behaviors"], b["uid"], rng,
                                  method=M.calculate_loss)
    else:
        init = lambda: model.init(rng, b["inputs"], b["behaviors"], b["target"],
                                  b["behavior"] + 1, b["seq_len"], rng, method=M.calculate_loss)
    return jax.eval_shape(init)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_only_test_on_a_converted_jax_checkpoint(root, backbone, monkeypatch):
    import flax.linen as nn
    from main import main as jax_main

    from gamer_tpu_torch.__main__ import main

    out, _ = _trained(root, backbone)
    jdir, pdir = root / f"jax_{backbone}", root / f"conv_{backbone}"
    trained = torch.load(out / "best" / "state.pt", weights_only=True)
    JaxCheckpointManager(str(jdir)).save("best", to_flax(trained, _jax_template(root, backbone)))

    init = nn.Module.init
    monkeypatch.setattr(nn.Module, "init", lambda self, rngs, *a, **kw: jax.jit(
        lambda: init(self, rngs, *a, **kw))())
    want = jax_main(_argv(root, "jax", backbone, jdir, "--only_test"))["test"]

    restored = JaxCheckpointManager(str(jdir)).restore("best")
    CheckpointManager(str(pdir)).save("best", state_dict_from_jax(restored))
    got = main(_argv(root, "port", backbone, pdir, "--only_test", "--device", "cpu"))["test"]
    assert sorted(got) == sorted(want)
    for behavior in want:
        assert got[behavior]["count"] == want[behavior]["count"] > 0
        for metric, value in want[behavior].items():
            assert abs(got[behavior][metric] - value) <= 1e-6, (backbone, behavior, metric)
    assert max(m["hit@10"] for m in want.values()) > 0  # the trained model ranks targets
