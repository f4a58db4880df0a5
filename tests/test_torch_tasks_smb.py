"""Port counterpart of tests/test_e2e_smb.py: synthetic data ->
`python -m gamer_tpu_torch train_SMB_decoder` -> `test_SMB_decoder` and
`test_SMB_rule`, through `gamer_tpu_torch.__main__.main([..., "--device",
"cpu"])` at the JAX test's tiny flags, held to the JAX package:

- the rule baseline's per-behavior metrics, merged metrics and counts equal
  the JAX task's (each package reads its own copy of the dataset);
- the trained weights, taken into the flax layout and carried back into the
  port by `convert.py`, give per-behavior metric totals of the port's
  `_eval_mixed` within 1e-6 of the JAX task's on the same rows (fp32, 4
  beams), and the --valid_loss result within 1e-5 relative.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.data import synthetic as JS
from gamer_tpu.data.batching import DecodeBatcher as JaxDecodeBatcher
from gamer_tpu.data.loading_smb import load_smb_test as jax_load_test
from gamer_tpu.data.smb import filter_examples_by_behavior as jax_filter
from gamer_tpu.data.vocab import SemanticVocab as JaxVocab
from gamer_tpu.decode.beam import BeamSearchConfig as JaxBeamConfig
from gamer_tpu.decode.beam import make_beam_search_fn as jax_search_fn
from gamer_tpu.decode.trie import LeveledTrie as JaxTrie
from gamer_tpu.models.generative import qwen_family as JQ
from gamer_tpu.tasks.test_smb_decoder import TestSMBDecoder as JaxTestTask
from gamer_tpu_torch.convert import load_jax_params, to_flax
from gamer_tpu_torch.data import synthetic as TS
from gamer_tpu_torch.data.batching import DecodeBatcher
from gamer_tpu_torch.data.loading_smb import load_smb_test
from gamer_tpu_torch.data.smb import filter_examples_by_behavior
from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_fn
from gamer_tpu_torch.decode.trie import LeveledTrie
from gamer_tpu_torch.models.generative import qwen_family as TQ
from gamer_tpu_torch.tasks.test_smb_decoder import TestSMBDecoder, load_generative_model
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)

SPEC = dict(n_users=30, n_items=40, num_levels=2, level_sizes=(8, 10), min_len=6, max_len=16,
            seed=11)
METRICS = "hit@1,hit@5,hit@10,recall@1,recall@5,recall@10,ndcg@5,ndcg@10".split(",")


def run_port(argv):
    from gamer_tpu_torch.__main__ import main

    return main([str(a) for a in argv] + ["--device", "cpu"])


def run_jax(argv):
    from main import main

    return main([str(a) for a in argv])


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """Each package's copy of the dataset, and the port's trained checkpoint."""
    root = tmp_path_factory.mktemp("port_e2e")
    JS.write_synthetic_dataset(str(root / "jax_data"), "Demo", JS.SyntheticSpec(**SPEC))
    TS.write_synthetic_dataset(str(root / "data"), "Demo", TS.SyntheticSpec(**SPEC))
    train_res = run_port([
        "train_SMB_decoder", "--dataset", "Demo", "--data_path", root / "data",
        "--tasks", "smb_explicit_decoder_2", "--backbone", "Qwen3Multi",
        "--max_his_len", 6, "--epochs", 2, "--batch_size", 8,
        "--learning_rate", "1e-3", "--temperature", "0.7",
        "--output_dir", root / "ckpt", "--n_layers", 2, "--hidden_size", 16,
        "--model_max_length", 128])
    return root, train_res


def _jax_weights(ckpt: Path):
    """(JAX model, its config, the port's trained weights as a flax tree)."""
    raw = json.loads((ckpt / "config.json").read_text())
    jcfg = JQ.QwenFamilyConfig.from_dict(raw)
    jmodel = JQ.QwenFamilyModel(jcfg)
    tmodel, _, _, _ = load_generative_model(str(ckpt), "best", "cpu")
    S = jcfg.num_positions * 2
    batch = {k: jnp.zeros((1, S), jnp.int32) for k in
             ("input_ids", "session_ids", "actions", "extended_session_ids")}
    batch["attention_mask"] = jnp.ones((1, S), jnp.int32)
    template = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                  **JQ.prepare_train_inputs(jcfg, batch)))
    return jmodel, jcfg, to_flax(dict(tmodel.named_parameters()), template)


def test_train_eval_rule_pipeline(e2e):
    root, train_res = e2e
    assert np.isfinite(train_res["best_metric"])
    assert len(train_res["history"]) == 2
    assert train_res["history"][1]["train_loss"] < train_res["history"][0]["train_loss"]
    for name in ("best", "last", "last_state", "config.json", "vocab.json"):
        assert (root / "ckpt" / name).exists(), name
    assert json.loads((root / "ckpt" / "config.json").read_text())["family"] == "decoder_only"

    eval_res = run_port([
        "test_SMB_decoder", "--dataset", "Demo", "--data_path", root / "data",
        "--max_his_len", 6, "--test_task", "smb_explicit",
        "--ckpt_path", root / "ckpt", "--test_batch_size", 8,
        "--num_beams", 4, "--results_file", root / "test.json"])
    assert set(eval_res["per_behavior"]) == {"click", "cart", "buy"}
    for m, v in eval_res["merged"].items():
        assert 0.0 <= v <= 1.0, (m, v)
    assert json.loads((root / "test.json").read_text())["merged"] == eval_res["merged"]

    rule = ["test_SMB_rule", "--dataset", "Demo", "--max_his_len", 6,
            "--test_task", "smb_explicit", "--unique"]
    got = run_port(rule + ["--data_path", root / "data", "--results_file", root / "rule.json"])
    want = run_jax(rule + ["--data_path", root / "jax_data",
                           "--results_file", root / "jax_rule.json"])
    assert got == want
    for m, v in got["merged"].items():
        assert 0.0 <= v <= 1.0


def test_eval_mixed_matches_jax_on_converted_weights(e2e):
    root, _ = e2e
    jmodel, jcfg, params = _jax_weights(root / "ckpt")
    tmodel = load_jax_params(TQ.QwenFamilyModel(TQ.QwenFamilyConfig.from_dict(jcfg.to_dict()),
                                                device="cpu"), params)
    results = []
    for pkg in ("jax", "port"):
        loader, filt = (jax_load_test, jax_filter) if pkg == "jax" else (
            load_smb_test, filter_examples_by_behavior)
        data = loader("Demo", str(root / ("jax_data" if pkg == "jax" else "data")), 6,
                      ".index.json", "smb_explicit")
        corpus = data.corpus
        vocab = (JaxVocab if pkg == "jax" else type(corpus.vocab)).load(
            str(root / "ckpt" / "vocab.json"))
        items = corpus.item_codes[~corpus.collision_rows]
        rows = [(b, i, ex) for i, b in enumerate(corpus.behavior_names)
                for ex in filt(data.test, i, corpus.target_behavior_idx)]
        if pkg == "jax":
            task, trie = JaxTestTask(), JaxTrie.from_token_rows(items, vocab)
            task._batcher = JaxDecodeBatcher.for_examples(data.test, extra=1)
            task._search = jax_search_fn(jmodel, trie, JaxBeamConfig(num_beams=4))
            acc = task._eval_mixed(jcfg, params, corpus, vocab, trie, rows,
                                   list(corpus.behavior_names), 8, METRICS)
        else:
            task, trie = TestSMBDecoder(), LeveledTrie.from_token_rows(items, vocab)
            task._batcher = DecodeBatcher.for_examples(data.test, extra=1)
            task._search = make_beam_search_fn(tmodel, trie, BeamSearchConfig(num_beams=4))
            acc = task._eval_mixed(corpus, vocab, trie, rows, list(corpus.behavior_names), 8,
                                   METRICS)
        results.append(acc)
    want, got = results
    assert sum(a["count"] for a in got.values()) > 0
    for behavior, a in want.items():
        assert got[behavior]["count"] == a["count"] and got[behavior]["dup_n"] == a["dup_n"]
        assert abs(got[behavior]["dup_sum"] - a["dup_sum"]) <= 1e-6
        for m in METRICS:
            assert abs(got[behavior]["totals"][m] - a["totals"][m]) <= 1e-6, (behavior, m)


def test_valid_loss_mode(e2e):
    root, _ = e2e
    res = run_port([
        "test_SMB_decoder", "--dataset", "Demo", "--data_path", root / "data",
        "--max_his_len", 6, "--test_task", "smb_explicit", "--ckpt_path", root / "ckpt",
        "--results_file", root / "valid_loss.json", "--valid_loss"])
    assert np.isfinite(res["valid_loss"]) and res["valid_loss"] > 0
    jmodel, jcfg, params = _jax_weights(root / "ckpt")
    want = JaxTestTask()._valid_loss(jmodel, jcfg, params, "Demo", str(root / "jax_data"), 6,
                                     ".index.json", str(root / "jax_valid_loss.json"))
    assert abs(res["valid_loss"] - want["valid_loss"]) <= 1e-5 * abs(want["valid_loss"])
