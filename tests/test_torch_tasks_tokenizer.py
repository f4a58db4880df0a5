"""The port's item-tokenizer tasks (`SemEmb`, `RQVAE`, `tokenize`) through
`python -m gamer_tpu_torch`'s `main(argv)` against the JAX package's, each
package on its own copy of one synthetic dataset:

- `SemEmb`'s hash backend: the `.npy` byte-identical; its AutoModel
  backend on a tiny random BERT the test writes itself (offline,
  `local_files_only`): the embeddings within 1e-5 of JAX's task's;
- `tokenize` cid (plain and shuffled) and rid: the JSON byte-identical; the
  reference flag aliases (`--cid`, `--rid`, `--rq_kmeans`, `--checkpoint`);
- `tokenize --mode rq_vae` on a JAX RQ-VAE checkpoint carried over by
  `convert.py`: the codes before repair and the repaired JSON equal to
  JAX's (a code that flips on a near-tie would have to show a distance gap
  under 1e-5 relative);
- `rq_kmeans` collision-free, its residual energy within 5% of JAX's; with
  `--cf_emb_file --reduce`;
- `RQVAE` then `tokenize` (the port's version of
  `tests/test_rqvae.py::test_rqvae_train_and_tokenize`), and with --bn,
  dropout, a `.pt` CF file and non-uniform levels; the `.pt` loaders and
  `collision_rate` against JAX's.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.data import synthetic as JSyn
from gamer_tpu.models.tokenizer.rqvae import RQVAE as JaxRQVAE
from gamer_tpu.models.tokenizer.rqvae import RQVAEConfig as JaxRQVAEConfig
from gamer_tpu_torch.convert import state_dict_from_jax
from gamer_tpu_torch.core.checkpoint import CheckpointManager
from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)

N_ITEMS = 60


def run_port(argv):
    from gamer_tpu_torch.__main__ import main

    return main([str(a) for a in argv] + ["--device", "cpu"])


def run_jax(argv):
    from main import main

    return main([str(a) for a in argv])


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The JAX generator's dataset (32-d embeddings), one copy a package."""
    root = tmp_path_factory.mktemp("tok")
    JSyn.generate(JSyn.SyntheticSpec(
        n_users=24, n_items=N_ITEMS, n_clusters=4, min_len=8, max_len=24, num_levels=3,
        level_sizes=(8, 8, 16), emb_dim=32, seed=7)).write(str(root / "jax"), "Synth")
    shutil.copytree(root / "jax", root / "port")
    return root


def _emb(d, pkg):
    return str(d / pkg / "Synth" / "Synth.emb-synthetic-td.npy")


def _same_file(d, suffix):
    a = (d / "jax" / "Synth" / f"Synth{suffix}").read_bytes()
    b = (d / "port" / "Synth" / f"Synth{suffix}").read_bytes()
    assert a == b, suffix


def test_semantic_emb_hash_is_byte_identical(data):
    for pkg, run in (("jax", run_jax), ("port", run_port)):
        res = run(["SemEmb", "--dataset", "Synth", "--data_path", data / pkg, "--emb_dim", "48",
                   "--plm_name", "hash"])
        assert res["shape"] == [N_ITEMS, 48]
    _same_file(data, ".emb-hash-td.npy")


def _tiny_bert(path) -> str:
    """A random 2-layer BERT of width 32 and its WordPiece tokenizer (the
    special tokens, letters, digits and their ## forms) saved in `path`."""
    from transformers import BertConfig, BertModel, BertTokenizerFast

    chars = [chr(c) for c in range(ord("a"), ord("z") + 1)] + [str(d) for d in range(10)]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", *chars, *(f"##{c}" for c in chars)]
    path.mkdir()
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n")
    BertTokenizerFast(vocab_file=str(path / "vocab.txt"), do_lower_case=True).save_pretrained(
        str(path))
    torch.manual_seed(0)
    BertModel(BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=128)).save_pretrained(str(path))
    return str(path)


def test_semantic_emb_automodel_matches_jax_task(data, tmp_path, monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    ckpt = _tiny_bert(tmp_path / "bert")
    out = {}
    for pkg, run in (("jax", run_jax), ("port", run_port)):
        res = run(["SemEmb", "--dataset", "Synth", "--data_path", data / pkg, "--plm_name",
                   "tinybert", "--plm_checkpoint", ckpt, "--max_sent_len", "64"])
        assert res["shape"] == [N_ITEMS, 32]
        out[pkg] = np.load(data / pkg / "Synth" / "Synth.emb-tinybert-td.npy")
    assert np.abs(out["port"]).max() > 0
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("argv,suffix", [
    (["--mode", "cid", "--chunk_size", "8"], ".index.cid.chunk8.json"),
    (["--cid", "--chunk_size", "4", "--shuffle", "--seed", "3"], ".index.cid.shuffle.chunk4.json"),
    (["--mode", "rid", "--num_code_list", "8,8"], ".index.rid.json"),
    (["--rid", "--num_code_list", "4", "4", "8"], ".index.rid.json"),
])
def test_cid_and_rid_are_byte_identical(data, argv, suffix):
    for pkg, run in (("jax", run_jax), ("port", run_port)):
        res = run(["tokenize", "--dataset", "Synth", "--data_path", data / pkg, *argv])
        assert res["collision_rate"] == 0.0 and res["n_items"] == N_ITEMS
    _same_file(data, suffix)


def _jax_checkpoint(d, tag="best_collision"):
    """A JAX RQ-VAE (random weights, codebooks from the JAX task's k-means
    init; bn) saved as the JAX RQVAE task saves it, and the same weights as
    the port's checkpoint (`convert.py`)."""
    kw = dict(in_dim=32, num_emb_list=[8, 8, 8], e_dim=4, layers=[16, 8], bn=True,
              sk_epsilons=[0.0, 0.0, 0.003], kmeans_iters=10)
    from gamer_tpu.core.checkpoint import CheckpointManager as JaxCheckpointManager
    from gamer_tpu.tasks.rqvae import init_codebooks_from_data

    jm = JaxRQVAE(JaxRQVAEConfig(**kw))
    x = np.load(_emb(d, "jax"))
    v = init_codebooks_from_data(jm, jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:8])), x)
    # move the running statistics off their defaults, as training does
    _, stats = jm.apply(v, jnp.asarray(x), deterministic=False, mutable=["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats["batch_stats"]}
    jdir, pdir = d / "jax_ckpt", d / "port_ckpt"
    JaxCheckpointManager(str(jdir)).save(tag, v)
    JaxRQVAEConfig(**kw).save(str(jdir))
    model = RQVAE(RQVAEConfig(**kw), device="cpu")
    model.load_state_dict(state_dict_from_jax(v))
    CheckpointManager(str(pdir)).save(tag, model.state_dict())
    RQVAEConfig(**kw).save(str(pdir))
    return jm, v, model, x


def _near_tie_gaps(model, x, got, want):
    """For each row whose codes differ, the relative distance gap between the
    two codes at the first level where they part (on `want`'s path)."""
    gaps = []
    for i in np.nonzero((got != want).any(axis=1))[0]:
        residual = model.encoder(torch.tensor(x[i:i + 1]))
        for lvl in range(got.shape[1]):
            book = model.book(lvl)
            d = ((residual - book) ** 2).sum(dim=1)
            if got[i, lvl] != want[i, lvl]:
                a, b = float(d[got[i, lvl]]), float(d[want[i, lvl]])
                gaps.append(abs(a - b) / max(abs(b), 1e-12))
                break
            residual = residual - book[want[i, lvl]]
    return gaps


def test_rq_vae_mode_on_a_converted_jax_checkpoint(data):
    jm, v, model, x = _jax_checkpoint(data)
    want0 = np.asarray(jm.apply(v, jnp.asarray(x), method=JaxRQVAE.get_indices))
    got0 = model.get_indices(torch.tensor(x)).numpy()
    gaps = _near_tie_gaps(model, x, got0, want0)
    assert all(g < 1e-5 for g in gaps), gaps
    np.testing.assert_array_equal(got0, want0)  # no flip at these inputs
    assert len({tuple(r) for r in want0.tolist()}) < N_ITEMS  # the repair has work to do
    common = ["tokenize", "--mode", "rq_vae", "--dataset", "Synth", "--epoch", "7",
              "--ckpt_tag", "best_collision"]
    want = run_jax(common + ["--data_path", data / "jax", "--ckpt_path", data / "jax_ckpt",
                             "--emb_file", _emb(data, "jax")])
    got = run_port(common + ["--data_path", data / "port", "--ckpt_path", data / "port_ckpt",
                             "--emb_file", _emb(data, "port")])
    assert got["collision_rate"] == want["collision_rate"] == 0.0
    assert got["output_file"].endswith("Synth.index.epoch7.alpha0.02-beta0.0001.json")
    _same_file(data, ".index.epoch7.alpha0.02-beta0.0001.json")
    # the reference's --checkpoint file name maps onto the tag
    again = run_port(common[:-2] + ["--checkpoint", "best_collision_model.pth",
                                    "--data_path", data / "port",
                                    "--ckpt_path", data / "port_ckpt",
                                    "--emb_file", _emb(data, "port")])
    np.testing.assert_array_equal(again["codes"], got["codes"])


def _kmeans_task(pkg):
    if pkg == "jax":
        from gamer_tpu.data.contract import DataFiles
        from gamer_tpu.tasks.tokenize import Tokenize

        return Tokenize(), DataFiles
    from gamer_tpu_torch.data.contract import DataFiles
    from gamer_tpu_torch.tasks.tokenize import Tokenize

    task = Tokenize()
    task.device = torch.device("cpu")
    return task, DataFiles


def test_rq_kmeans_collision_free_and_as_good_as_jax(data):
    energy = {}
    for pkg in ("jax", "port"):
        task, DataFiles = _kmeans_task(pkg)
        x = np.load(_emb(data, pkg))
        res = task.run_rq_kmeans(DataFiles(str(data / pkg), "Synth"), x, [8, 8, 8], None)
        assert res["collision_rate"] == 0.0 and res["n_items"] == N_ITEMS
        R = task._rq_kmeans_state[0]
        energy[pkg] = float((np.asarray(R.cpu() if pkg == "port" else R) ** 2).sum())
    assert energy["port"] <= 1.05 * energy["jax"], energy
    res = run_port(["tokenize", "--rq_kmeans", "--dataset", "Synth", "--data_path",
                    data / "port", "--num_code_list", "8,8,8", "--emb_file", _emb(data, "port")])
    assert res["output_file"].endswith("Synth.index.rq-kmeans.json")
    assert res["collision_rate"] == 0.0


def test_rq_kmeans_cf_reduce(data, tmp_path):
    cf_path = str(tmp_path / "cf.npy")
    np.save(cf_path, np.random.default_rng(0).normal(size=(N_ITEMS, 8)).astype(np.float32))
    res = run_port(["tokenize", "--mode", "rq_kmeans", "--dataset", "Synth", "--data_path",
                    data / "port", "--num_code_list", "8,8,8", "--cf_emb_file", cf_path,
                    "--reduce", "--emb_file", _emb(data, "port")])
    assert res["n_items"] == N_ITEMS and res["collision_rate"] == 0.0
    assert res["output_file"].endswith("Synth.index.rq-kmeans-cf.json")


@pytest.mark.parametrize("extra", [
    [],
    ["--bn", "--dropout_prob", "0.1", "--num_emb_list", "16,8,12", "--alpha", "0.02",
     "--recluster_every", "2"],
])
def test_rqvae_train_then_tokenize(data, tmp_path, extra):
    """tests/test_rqvae.py::TestTokenizeTask::test_rqvae_train_and_tokenize
    through the port's CLI; the second case adds BatchNorm, dropout, a .pt
    CF file and non-uniform levels."""
    if "--alpha" in extra:
        cf = torch.from_numpy(np.random.default_rng(1).normal(size=(N_ITEMS, 8)).astype(
            np.float32))
        torch.save(cf, str(tmp_path / "cf.pt"))
        extra = [*extra, "--cf_emb_file", str(tmp_path / "cf.pt"), "--e_dim", "8"]
    ckpt = tmp_path / "rq_ckpt"
    res = run_port(["RQVAE", "--dataset", "Synth", "--data_path", data / "port",
                    "--output_dir", ckpt, "--epochs", "30", "--batch_size", "32",
                    "--eval_step", "10", "--e_dim", "8", "--num_emb", "16", "--num_levels", "3",
                    "--layers", "32,16", "--alpha", "0", "--beta", "0.0001", "--kmeans_init",
                    "--emb_file", _emb(data, "port"), *extra])
    assert np.isfinite(res["best_loss"]) and 0.0 <= res["best_collision"] <= 1.0
    assert [h["epoch"] for h in res["history"]] == [9, 19, 29]
    assert np.isfinite([h["loss"] for h in res["history"]]).all()
    sizes = res["init_cluster_sizes"]  # the k-means init's clusters, level by level
    levels = RQVAEConfig.from_file(str(ckpt)).num_emb_list
    assert [len(s) for s in sizes] == levels and all(sum(s) == N_ITEMS for s in sizes)
    for name in ("best_loss", "best_collision", "last", "config.json"):
        assert (ckpt / name).exists(), name
    tok = run_port(["tokenize", "--mode", "rq_vae", "--dataset", "Synth", "--data_path",
                    data / "port", "--ckpt_path", ckpt, "--ckpt_tag", "best_collision",
                    "--epoch", "30", "--emb_file", _emb(data, "port")])
    assert tok["n_items"] == N_ITEMS and tok["collision_rate"] == 0.0
    codes = json.loads(open(tok["output_file"]).read())
    assert len(codes) == N_ITEMS and all(len(v) == 3 for v in codes.values())
    assert (tok["codes"].max(axis=0) < np.asarray(levels)).all()


def test_loaders_and_collision_rate_match_jax(tmp_path):
    from gamer_tpu.tasks import rqvae as JR
    from gamer_tpu_torch.tasks import rqvae as TR

    x = np.random.default_rng(0).normal(size=(12, 6)).astype(np.float32) * 0.1
    torch.save(torch.from_numpy(x), str(tmp_path / "a.pt"))
    torch.save({"emb": torch.from_numpy(x)}, str(tmp_path / "b.pt"))
    np.save(str(tmp_path / "c.npy"), x)
    for name in ("a.pt", "b.pt", "c.npy"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(TR._load_tensor_file(path), JR._load_tensor_file(path))
        np.testing.assert_array_equal(TR.load_embeddings(path), JR.load_embeddings(path))
    codes = np.random.default_rng(1).integers(0, 3, (50, 2))
    assert TR.collision_rate(codes) == JR.collision_rate(codes) > 0


def test_force_unique_last_level_matches_jax():
    from gamer_tpu.tasks.tokenize import Tokenize as JT
    from gamer_tpu_torch.tasks.tokenize import Tokenize as TT

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 3, (40, 3))
    d = rng.random((40, 16))
    scores = lambda idx: d[idx]
    np.testing.assert_array_equal(TT._force_unique_last_level(codes.copy(), scores),
                                  JT._force_unique_last_level(codes.copy(), scores))
