"""The enc-dec family through the port's CLI (`gamer_tpu_torch.__main__.main
([..., "--device", "cpu"])`): `train_decoder --backbone TIGER`,
`train_SMB_decoder --backbone PBATransformer` (from its shipped config, cut
to one narrow layer) and `train_MB_decoder --backbone TIGER`, then the
port's test tasks, held to the JAX package: the port's trained weights,
taken into the flax layout by `convert.to_flax`, run through the JAX
`test_decoder`, `test_SMB_decoder` (and its --valid_loss) and
`test_MB_decoder`, whose `load_generative_model` is handed the converted
weights, and give the port's metrics within 1e-6 (times the rows a metric
averages: the metric totals), the valid loss within 1e-5 relative; fp32, 4
beams."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gamer_tpu.data import synthetic as JS
from gamer_tpu.data.vocab import SemanticVocab as JaxVocab
from gamer_tpu.models.generative import encdec as JE
from gamer_tpu.models.generative.encdec_utils import prepare_encdec_inputs
from gamer_tpu_torch.convert import to_flax
from gamer_tpu_torch.data import synthetic as TS
from gamer_tpu_torch.tasks.test_decoder import load_generative_model
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_tasks_smb import run_jax, run_port

SPEC = dict(n_users=24, n_items=60, n_clusters=4, min_len=8, max_len=24, num_levels=3,
            level_sizes=(8, 8, 16), emb_dim=32, seed=7)
TINY = ["--max_his_len", 6, "--epochs", 2, "--batch_size", 16, "--n_layers", 1,
        "--hidden_size", 16]
EVAL = ["--max_his_len", 6, "--num_beams", 4, "--test_batch_size", 8]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Each package's copy of the dataset; the port's enc-dec checkpoints
    ("seq": TIGER, "smb": PBATransformer, "mb": TIGER) and training results."""
    root = tmp_path_factory.mktemp("port_encdec")
    JS.write_synthetic_dataset(str(root / "jax_data"), "Synth", JS.SyntheticSpec(**SPEC))
    TS.write_synthetic_dataset(str(root / "data"), "Synth", TS.SyntheticSpec(**SPEC))
    common = ["--dataset", "Synth", "--data_path", root / "data", *TINY]
    res = {
        "seq": run_port(["train_decoder", *common, "--backbone", "TIGER",
                         "--output_dir", root / "seq"]),
        "smb": run_port(["train_SMB_decoder", *common, "--backbone", "PBATransformer",
                         "--base_model", "config/s2s-models/PBATransformer",
                         "--tasks", "smb_explicit_decoder_2", "--gradient_checkpointing",
                         "--temperature", "0.7", "--output_dir", root / "smb"]),
        "mb": run_port(["train_MB_decoder", *common, "--backbone", "TIGER",
                        "--tasks", "mb_explicit_decoder_2", "--output_dir", root / "mb"]),
    }
    return root, res


def _jax_loader(ckpt):
    """A stand-in for the JAX tasks' `load_generative_model` that returns the
    port's trained enc-dec weights in the flax layout."""
    raw = json.loads((ckpt / "config.json").read_text())
    jcfg = JE.EncDecConfig.from_dict(raw)
    jmodel = JE.EncDecModel(jcfg)
    tmodel, _, _, family = load_generative_model(str(ckpt), "best", "cpu")
    assert family == "encdec"
    batch = {k: jnp.zeros((1, 4), jnp.int32) for k in ("input_ids", "attention_mask", "labels")}
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                **prepare_encdec_inputs(jcfg, batch)))
    params = to_flax(tmodel.state_dict(), shapes)
    vocab = JaxVocab.load(str(ckpt / "vocab.json"))
    return lambda *args, **kw: (jmodel, jcfg, params, vocab, "encdec")


def _close(got: dict, want: dict, rows: int) -> None:
    assert sorted(got) == sorted(want)
    for m, v in want.items():
        assert 0.0 <= got[m] <= 1.0 and abs(got[m] - v) * rows <= 1e-6, m


def test_training_runs(trained):
    root, res = trained
    for name, backbone in (("seq", "TIGER"), ("smb", "PBATransformer"), ("mb", "TIGER")):
        losses = [h["train_loss"] for h in res[name]["history"]]
        assert len(losses) == 2 and np.isfinite(res[name]["best_metric"]), name
        assert losses[1] < losses[0], (name, losses)
        cfg = json.loads((root / name / "config.json").read_text())
        assert cfg["family"] == "encdec" and cfg["backbone"] == backbone, name
        for f in ("best", "last", "last_state", "vocab.json"):
            assert (root / name / f).exists(), (name, f)
    smb = json.loads((root / "smb" / "config.json").read_text())
    assert smb["sparse_layers_encoder"] == [0, 1, 2, 3] and smb["d_ff"] == 512  # shipped config
    assert smb["num_positions"] == 4 and smb["num_experts"] == 5
    assert json.loads((root / "mb" / "config.json").read_text())["behavior_first"] is True


def test_seq_eval_matches_jax_task(trained, monkeypatch):
    import gamer_tpu.tasks.test_decoder as JT

    root, _ = trained
    argv = ["test_decoder", "--dataset", "Synth", "--ckpt_path", root / "seq", *EVAL]
    got = run_port(argv + ["--data_path", root / "data", "--results_file", root / "seq.json"])
    monkeypatch.setattr(JT, "load_generative_model", _jax_loader(root / "seq"))
    want = run_jax(argv + ["--data_path", root / "jax_data",
                           "--results_file", root / "jax_seq.json"])
    assert got["count"] == want["count"] == SPEC["n_users"]
    assert got["collision_info"] == want["collision_info"]
    _close(got["metrics"], want["metrics"], got["count"])


def test_smb_eval_and_valid_loss_match_jax_task(trained, monkeypatch):
    import gamer_tpu.tasks.test_decoder as JT

    root, _ = trained
    argv = ["test_SMB_decoder", "--dataset", "Synth", "--test_task", "smb_explicit",
            "--ckpt_path", root / "smb", *EVAL]
    got = run_port(argv + ["--data_path", root / "data", "--results_file", root / "smb.json"])
    got_loss = run_port(argv + ["--data_path", root / "data", "--valid_loss",
                                "--results_file", root / "smb_loss.json"])
    monkeypatch.setattr(JT, "load_generative_model", _jax_loader(root / "smb"))
    want = run_jax(argv + ["--data_path", root / "jax_data", "--results_file",
                           root / "jax_smb.json"])
    want_loss = run_jax(argv + ["--data_path", root / "jax_data", "--valid_loss",
                                "--results_file", root / "jax_smb_loss.json"])
    assert got["counts"] == want["counts"] and set(got["counts"]) == {"click", "cart", "buy"}
    for b, n in got["counts"].items():
        _close(got["per_behavior"][b], want["per_behavior"][b], n)
        assert abs(got["duplicate_ratio"][b] - want["duplicate_ratio"][b]) * n <= 1e-6
    _close(got["merged"], want["merged"], sum(got["counts"].values()))
    assert abs(got_loss["valid_loss"] / want_loss["valid_loss"] - 1) <= 1e-5


def test_mb_eval_matches_jax_task(trained, monkeypatch):
    """The two modes the enc-dec family runs (BEHAVIOR_ITEM is decoder-only,
    as in JAX), in JAX's order and names."""
    import gamer_tpu.tasks.test_mb_decoder as JT

    root, _ = trained
    argv = ["test_MB_decoder", "--dataset", "Synth", "--test_task", "mb_explicit",
            "--ckpt_path", root / "mb", *EVAL]
    got = run_port(argv + ["--data_path", root / "data", "--results_file", root / "mb.json"])
    monkeypatch.setattr(JT, "load_generative_model", _jax_loader(root / "mb"))
    want = run_jax(argv + ["--data_path", root / "jax_data", "--results_file",
                           root / "jax_mb.json"])
    assert [r["eval_type"] for r in got] == [r["eval_type"] for r in want] == [
        "Target Behavior", "Behavior Specific"]
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        g.pop("eval_type"), w.pop("eval_type")
        _close(g, w, 2 * SPEC["n_users"])
