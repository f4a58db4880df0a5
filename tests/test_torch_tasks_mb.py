"""Port counterpart of tests/test_mb_tasks.py's CLI runs: synthetic data ->
`python -m gamer_tpu_torch train_MB_decoder` (Qwen3MoeAction) ->
`test_MB_decoder`, and `train_decoder` (Qwen3Moe) -> `test_decoder`, through
`gamer_tpu_torch.__main__.main([..., "--device", "cpu"])` at that test's tiny
flags, held to the JAX package: the port's trained weights, taken into the
flax layout by `convert.to_flax`, run through the JAX tasks (their
`load_generative_model` handed the converted weights) and give every
`test_MB_decoder` mode's metrics and `test_decoder`'s metrics within 1e-6
(times the mode's row count: the metric totals), with equal
`collision_info`; fp32, 4 beams. The enc-dec backbones, which raised
NotImplementedError before they were ported, train and evaluate through the
same tasks (tests/test_torch_tasks_encdec.py holds them to JAX)."""

import json

import numpy as np
import pytest
import torch

from gamer_tpu.data import synthetic as JS
from gamer_tpu.data.vocab import SemanticVocab as JaxVocab
from gamer_tpu_torch.data import synthetic as TS
from gamer_tpu_torch.data.contract import DataFiles
from gamer_tpu_torch.data.seq import MBExampleBuilder, SeqCorpus, filter_mb_examples
from gamer_tpu_torch.tasks.train_mb_decoder import layout_for_mb_task
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_tasks_smb import _jax_weights, run_jax, run_port

# tests/test_mb_tasks.py's dataset (conftest `synth_data`) and flags
SPEC = dict(n_users=24, n_items=60, n_clusters=4, min_len=8, max_len=24, num_levels=3,
            level_sizes=(8, 8, 16), emb_dim=32, seed=7)
TINY = ["--max_his_len", 6, "--epochs", 2, "--batch_size", 16, "--n_layers", 1,
        "--hidden_size", 16, "--model_max_length", 128]
EVAL = ["--max_his_len", 6, "--num_beams", 4, "--test_batch_size", 8]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each package's copy of the dataset; the port's MB (Qwen3MoeAction) and
    single-behavior (Qwen3Moe) checkpoints and training results."""
    root = tmp_path_factory.mktemp("port_mb")
    JS.write_synthetic_dataset(str(root / "jax_data"), "Synth", JS.SyntheticSpec(**SPEC))
    TS.write_synthetic_dataset(str(root / "data"), "Synth", TS.SyntheticSpec(**SPEC))
    common = ["--dataset", "Synth", "--data_path", root / "data"]
    mb = run_port(["train_MB_decoder", *common, "--tasks", "mb_explicit_decoder_2",
                   "--backbone", "Qwen3MoeAction", "--output_dir", root / "mb", *TINY])
    seq = run_port(["train_decoder", *common, "--backbone", "Qwen3Moe",
                    "--output_dir", root / "seq", *TINY])
    return root, mb, seq


def _jax_loader(ckpt):
    """A stand-in for the JAX tasks' `load_generative_model` that returns the
    port's trained weights in the flax layout."""
    jmodel, jcfg, params = _jax_weights(ckpt)
    vocab = JaxVocab.load(str(ckpt / "vocab.json"))
    return lambda *args, **kw: (jmodel, jcfg, params, vocab, "decoder_only")


def test_mb_pipeline(trained):
    root, res, _ = trained
    losses = [h["train_loss"] for h in res["history"]]
    assert len(losses) == 2 and losses[1] < losses[0] and np.isfinite(res["best_metric"])
    cfg = json.loads((root / "mb" / "config.json").read_text())
    assert cfg["moe_action"] and cfg["family"] == "decoder_only"
    assert cfg["behavior_first"] is True and cfg["explicit"] is True
    assert cfg["num_positions"] == 4 and cfg["num_experts"] == 5 and cfg["num_behavior"] == 3
    for name in ("best", "last", "last_state", "vocab.json"):
        assert (root / "mb" / name).exists(), name


@pytest.mark.parametrize("filtered", [False, True])
def test_mb_eval_matches_jax_task(trained, monkeypatch, filtered):
    """All three modes, BEHAVIOR_ITEM (the behavior-token decode) included,
    in JAX's order and names, metrics in [0, 1] and within 1e-6 of the JAX
    task's on the same weights."""
    import gamer_tpu.tasks.test_mb_decoder as JT

    root, _, _ = trained
    argv = ["test_MB_decoder", "--dataset", "Synth", "--test_task", "mb_explicit",
            "--ckpt_path", root / "mb", *EVAL] + (["--filter"] if filtered else [])
    got = run_port(argv + ["--data_path", root / "data", "--results_file", root / "mb.json"])
    monkeypatch.setattr(JT, "load_generative_model", _jax_loader(root / "mb"))
    want = run_jax(argv + ["--data_path", root / "jax_data",
                           "--results_file", root / "jax_mb.json"])
    assert [r["eval_type"] for r in got] == [r["eval_type"] for r in want] == [
        "Target Behavior", "Behavior Specific", "Behavior Item"]
    corpus = SeqCorpus(DataFiles(str(root / "data"), "Synth"), multi_behavior=True)
    rows = len(MBExampleBuilder(corpus, layout_for_mb_task("mb_explicit"), 6).build("test"))
    tgt_rows = len(filter_mb_examples(
        MBExampleBuilder(corpus, layout_for_mb_task("mb_explicit"), 6).build("test"),
        corpus.target_behavior_idx))
    for g, w, n in zip(got, want, (tgt_rows, rows, rows)):
        assert sorted(g) == sorted(w)
        for m, v in w.items():
            if m != "eval_type":
                assert 0.0 <= g[m] <= 1.0 and abs(g[m] - v) * n <= 1e-6, (g["eval_type"], m)
    assert json.loads((root / "mb.json").read_text()) == got
    assert any(v > 0 for r in got for k, v in r.items() if k != "eval_type")


def test_seq_pipeline_and_eval_match_jax_task(trained, monkeypatch):
    import gamer_tpu.tasks.test_decoder as JT

    root, _, res = trained
    losses = [h["train_loss"] for h in res["history"]]
    assert len(losses) == 2 and losses[1] < losses[0]
    assert json.loads((root / "seq" / "config.json").read_text())["num_positions"] == 3
    argv = ["test_decoder", "--dataset", "Synth", "--ckpt_path", root / "seq", *EVAL]
    got = run_port(argv + ["--data_path", root / "data", "--results_file", root / "seq.json"])
    monkeypatch.setattr(JT, "load_generative_model", _jax_loader(root / "seq"))
    want = run_jax(argv + ["--data_path", root / "jax_data",
                           "--results_file", root / "jax_seq.json"])
    assert got["count"] == want["count"] == SPEC["n_users"]
    assert got["collision_info"] == want["collision_info"]
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for m, v in want["metrics"].items():
        assert 0.0 <= got["metrics"][m] <= 1.0
        assert abs(got["metrics"][m] - v) * got["count"] <= 1e-6, m


@pytest.mark.parametrize("task", ["train_decoder", "train_MB_decoder"])
def test_encdec_backbones_raise(trained, task, tmp_path):
    """The enc-dec backbones no longer raise: PBATransformer trains through
    the task (family "encdec" saved) and its test task evaluates the saved
    model (test_MB_decoder's two enc-dec modes), metrics in [0, 1]."""
    root, _, _ = trained
    extra = ["--tasks", "mb_explicit_decoder_2"] if task == "train_MB_decoder" else []
    res = run_port([task, "--dataset", "Synth", "--data_path", root / "data",
                    "--backbone", "PBATransformer", "--output_dir", tmp_path / "pbat",
                    *extra, *TINY, "--epochs", 1])
    assert np.isfinite(res["best_metric"]) and len(res["history"]) == 1
    cfg = json.loads((tmp_path / "pbat" / "config.json").read_text())
    assert cfg["family"] == "encdec" and cfg["sparse_layers_encoder"] == [0]
    evaluate = "test_decoder" if task == "train_decoder" else "test_MB_decoder"
    out = run_port([evaluate, "--dataset", "Synth", "--data_path", root / "data",
                    "--ckpt_path", tmp_path / "pbat", "--results_file", tmp_path / "r.json",
                    *EVAL] + (["--test_task", "mb_explicit"] if extra else []))
    rows = [out["metrics"]] if task == "train_decoder" else out
    assert len(rows) == (1 if task == "train_decoder" else 2)
    for r in rows:
        assert all(0.0 <= v <= 1.0 for k, v in r.items() if k != "eval_type"), r
