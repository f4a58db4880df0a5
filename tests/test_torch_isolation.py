"""The port stands alone: importing `gamer_tpu_torch` (every module) and
`chip_smoke.py` pulls in neither JAX nor any module of the JAX package, the
entry points default to CUDA and raise without it, and `chip_smoke.py`
refuses to run (no result line) without a GPU or without the repository.
The script's device-independent phases also run here at a tiny size."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny models here train on one intra-op thread: parallel test
    workers would otherwise each spread every small op over all cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_IMPORT_ALL = """
import importlib, pkgutil, sys
import gamer_tpu_torch
for m in pkgutil.walk_packages(gamer_tpu_torch.__path__, "gamer_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "gamer_tpu"))
assert not bad, bad
print("isolated", len([m for m in sys.modules if m.startswith("gamer_tpu_torch")]))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module of the package was imported


def test_entry_points_default_to_cuda():
    from chip_smoke import flagship_config
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel

    cfg = flagship_config(num_hidden_layers=1, hidden_size=32, intermediate_size=32,
                          num_attention_heads=2, num_key_value_heads=1, head_dim=32)
    if torch.cuda.is_available():
        assert QwenFamilyModel(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            QwenFamilyModel(cfg)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu_or_repo(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("with a GPU the script runs for real")
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = str(shutil.copy(script, tmp_path / "chip_smoke.py"))
    out = subprocess.run([sys.executable, script], cwd=os.path.dirname(script),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_phases_on_cpu():
    import chip_smoke as cs
    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_fn

    cfg = cs.flagship_config(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                             num_key_value_heads=2, head_dim=32, intermediate_size=128,
                             dtype="float32")
    batch = cs.make_batch(cfg, 2, 6)
    model, loss_fn = cs.run_forward(cfg, "cpu")
    _, plain_loss_fn = cs.run_forward(
        cfg.replace(attention_impl="jnp", moe_impl="jnp", ce_impl="jnp"), "cpu")
    loss, aux = loss_fn(batch)
    plain, plain_aux = plain_loss_fn(batch)
    np.testing.assert_allclose(float(loss), float(plain), rtol=1e-5)
    assert int(aux["denom"]) == int(plain_aux["denom"]) == 2 * 29

    trie, prompts, behaviors = cs.make_trie_and_prompts(cfg, 3, 200, 4, 16, 4)
    assert prompts["attention_mask"][1].sum() < prompts["attention_mask"].shape[1]
    search = make_beam_search_fn(model, trie, BeamSearchConfig(num_beams=5))
    for behavior in (behaviors, 2):
        codes, scores = search(prompts, behavior)
        cs.check_beams(trie, codes, scores, 3, 5)


def _tiny_flagship(**kw):
    import chip_smoke as cs

    return cs.flagship_config(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                              num_key_value_heads=2, head_dim=32, intermediate_size=128,
                              dtype="float32", **kw)


def test_chip_smoke_eval_phase_on_cpu():
    """Phase 3 of chip_smoke.py (`Trainer.evaluate` through the eval step,
    compiled and eager, then the plain path) at a tiny size on the CPU: both
    modes run the device part eagerly, bit-identical, no launch, no graph."""
    import chip_smoke as cs

    res = cs.eval_phase(torch.device("cpu"), _counters(), "cpu", cfg=_tiny_flagship(),
                        geometry=(2, 6), calls=3)
    assert set(res) == {"ms", "eager_ms", "launches"} and not any(res["launches"].values())
    assert cs._scoring_launches(cs.flagship_config(), True, cs.kernel_counters()) == {
        **{k: 0 for k in cs.kernel_counters()}, "fused_mask_attention": 12,
        "qk_norm_rope_fwd": 12, "fused_moe_ffn": 8, "fused_ce_rows": 1}


def test_chip_smoke_search_phase_on_cpu():
    """Phase 4 of chip_smoke.py (the per-example, scalar and behavior-token
    searches, compiled and eager, with their gates) at a tiny size on the
    CPU: every code path in its trie, compiled equal to eager, no graph."""
    import chip_smoke as cs

    cs.search_phase(torch.device("cpu"), _counters(), "cpu", cfg=_tiny_flagship(),
                    geometry=(3, 5, 200, 4, 16, 4), timed=1)
    trie, prompts, _ = cs.make_trie_and_prompts(_tiny_flagship(), 3, 200, 4, 16, 4,
                                                behavior_level=True)
    assert trie.num_levels == 5 and trie.level_sizes[0] == 3
    assert (prompts["attention_mask"].sum(1) % 5 == 0).all()  # whole blocks, no target token


def test_chip_smoke_train_step_on_cpu():
    """The kernel-path-vs-plain-path training step of phases 5 and 6 at a
    tiny size: on the CPU no kernel launches and the two paths agree."""
    import chip_smoke as cs
    from gamer_tpu_torch.ops import fused_attention as FA
    from gamer_tpu_torch.ops import fused_ce as FC
    from gamer_tpu_torch.ops import fused_moe as FM

    counters = {"a": FA.fused_mask_attention, "b": FA.fused_mask_attention_bwd,
                "h": FM.fused_moe_ffn, "i": FM.fused_moe_ffn_bwd,
                "j": FC.fused_ce_rows, "k": FC.fused_ce_rows_bwd}
    cfg = cs.flagship_config(hidden_size=128, num_hidden_layers=2, num_attention_heads=4,
                             num_key_value_heads=2, head_dim=32, intermediate_size=128,
                             dtype="float32", dropout_rate=cs.DROP_RATE)
    for remat in (False, True):
        cs._paths_agree("tiny", cfg, cs.make_batch(cfg, 2, 6, seed=1), "cpu", 1, counters,
                        {k: 0 for k in counters}, plain_remat=remat)


def test_data_plane_cli_and_native_are_isolated():
    """The slice's modules (data plane, native collation, checkpoints,
    tasks, the CLI `gamer_tpu_torch.__main__`, the process group, the
    tokenizer chain, the discriminative zoo) import no JAX, `python -m
    gamer_tpu_torch` has the eleven tasks, and every task that needs a model
    raises without CUDA unless --device cpu is given."""
    code = ("import importlib, sys\n"
            "for m in ('gamer_tpu_torch.__main__', 'gamer_tpu_torch.native', "
            "'gamer_tpu_torch.core.checkpoint', 'gamer_tpu_torch.data.batching', "
            "'gamer_tpu_torch.data.synthetic', 'gamer_tpu_torch.evaluation.ranking', "
            "'gamer_tpu_torch.tasks', 'gamer_tpu_torch.core.distributed', "
            "'gamer_tpu_torch.core.mesh', 'gamer_tpu_torch.ops.sinkhorn', "
            "'gamer_tpu_torch.ops.kmeans', 'gamer_tpu_torch.models.tokenizer.rqvae', "
            "'gamer_tpu_torch.tasks.rqvae', 'gamer_tpu_torch.tasks.tokenize', "
            "'gamer_tpu_torch.tasks.semantic_emb', 'gamer_tpu_torch.entry', "
            "'gamer_tpu_torch.modules.transformer', 'gamer_tpu_torch.models.discriminative', "
            "'gamer_tpu_torch.data.smb_dis', 'gamer_tpu_torch.tasks.train_smb_rec'):\n"
            "    importlib.import_module(m)\n"
            "from gamer_tpu_torch.tasks import task_list\n"
            "assert sorted(task_list) == ['RQVAE', 'SemEmb', 'test_MB_decoder', "
            "'test_SMB_decoder', 'test_SMB_rule', 'test_decoder', 'tokenize', "
            "'train_MB_decoder', 'train_SMB_decoder', 'train_SMB_rec', 'train_decoder'], "
            "sorted(task_list)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'gamer_tpu'))\n"
            "assert not bad, bad\n"
            "print(len([m for m in sys.modules if m.startswith('gamer_tpu_torch')]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 35
    if torch.cuda.is_available():
        return
    from gamer_tpu_torch.__main__ import main

    common = ["--dataset", "Demo", "--data_path", "unused"]
    for task in ("train_SMB_decoder", "test_SMB_decoder", "test_SMB_rule", "train_decoder",
                 "test_decoder", "train_MB_decoder", "test_MB_decoder", "RQVAE",
                 "train_SMB_rec"):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([task, *common])


def test_chip_smoke_task_phase_on_cpu():
    """Phase 7 of chip_smoke.py (the CLI pipeline, its gates and its reload
    check) at a tiny size on the CPU: no kernel launches, so every step's
    launch counts are 0."""
    import chip_smoke as cs
    from gamer_tpu_torch.ops import fused_attention as FA
    from gamer_tpu_torch.ops import fused_ce as FC
    from gamer_tpu_torch.ops import fused_moe as FM

    counters = {"fused_mask_attention": FA.fused_mask_attention,
                "fused_mask_attention_bwd": FA.fused_mask_attention_bwd,
                "fused_moe_ffn": FM.fused_moe_ffn, "fused_moe_ffn_bwd": FM.fused_moe_ffn_bwd,
                "fused_ce_rows": FC.fused_ce_rows, "fused_ce_rows_bwd": FC.fused_ce_rows_bwd}
    spec = dict(n_users=24, n_items=60, n_clusters=4, num_levels=2, level_sizes=(8, 10),
                min_len=6, max_len=16, seed=3)
    cs.task_phase(torch.device("cpu"), counters, "cpu", 0.0, spec=spec,
                  train_args=("--backbone", "Qwen3Multi", "--batch_size", "8", "--dtype",
                              "float32", "--n_layers", "2", "--hidden_size", "16"),
                  extra_args=("--device", "cpu"), min_steps=2, num_beams=4)
    assert not any(name.startswith("phase7_") for name in os.listdir(REPO))


def test_chip_smoke_seq_phase_on_cpu():
    """Phase 8 of chip_smoke.py (the multi- and single-behavior pipelines:
    train_MB_decoder with Qwen3MoeAction, the reload check, test_MB_decoder's
    three modes, train_decoder and test_decoder, with their gates) at a tiny
    size on the CPU: no kernel launches, so every step's launch counts are
    0."""
    import chip_smoke as cs
    from gamer_tpu_torch.ops import fused_attention as FA
    from gamer_tpu_torch.ops import fused_ce as FC
    from gamer_tpu_torch.ops import fused_moe as FM

    counters = {"fused_mask_attention": FA.fused_mask_attention,
                "fused_mask_attention_bwd": FA.fused_mask_attention_bwd,
                "fused_moe_ffn": FM.fused_moe_ffn, "fused_moe_ffn_bwd": FM.fused_moe_ffn_bwd,
                "fused_ce_rows": FC.fused_ce_rows, "fused_ce_rows_bwd": FC.fused_ce_rows_bwd}
    spec = dict(n_users=24, n_items=60, n_clusters=4, num_levels=3, level_sizes=(8, 8, 16),
                min_len=8, max_len=24, seed=7)
    tiny = ("--batch_size", "8", "--n_layers", "2", "--hidden_size", "16")
    cs.seq_phase(torch.device("cpu"), counters, "cpu", spec=spec,
                 mb_args=("--backbone", "Qwen3MoeAction", "--tasks", "mb_explicit_decoder_2",
                          *tiny),
                 seq_args=("--backbone", "Qwen3Moe", *tiny), extra_args=("--device", "cpu"),
                 min_steps=(2, 2), num_beams=4)
    assert not any(name.startswith("phase8_") for name in os.listdir(REPO))


def _counters():
    from gamer_tpu_torch.ops import fused_attention as FA
    from gamer_tpu_torch.ops import fused_ce as FC
    from gamer_tpu_torch.ops import fused_moe as FM
    from gamer_tpu_torch.ops import hash_dropout as HD

    return {"fused_mask_attention": FA.fused_mask_attention,
            "fused_mask_attention_bwd": FA.fused_mask_attention_bwd,
            "fused_moe_ffn": FM.fused_moe_ffn, "fused_moe_ffn_bwd": FM.fused_moe_ffn_bwd,
            "fused_ce_rows": FC.fused_ce_rows, "fused_ce_rows_bwd": FC.fused_ce_rows_bwd,
            "hash_dropout_fwd": HD.hash_dropout_fwd, "hash_dropout_bwd": HD.hash_dropout_bwd}


def test_chip_smoke_remat_phase_on_cpu():
    """Phase 9 of chip_smoke.py (each remat policy's steps against remat
    off, the automatic choice) at a tiny size on the CPU: no launches, no
    memory readings, every policy bit-identical to remat off."""
    import chip_smoke as cs

    cfg = cs.flagship_config(tiny=True, dtype="float32", dropout_rate=cs.DROP_RATE)
    results = cs.remat_phase(torch.device("cpu"), _counters(), "cpu", cfg=cfg,
                             geometries=((2, 4),), auto=(2, 4))
    assert sorted(results[(2, 20)]) == ["attn", "dots", "full", "off"]
    assert cs._remat_launches(cs.flagship_config(), "attn")["fused_mask_attention"] == 12
    assert cs._remat_launches(cs.flagship_config(), "dots") == {
        "fused_mask_attention": 24, "fused_mask_attention_bwd": 12, "fused_moe_ffn": 16,
        "fused_moe_ffn_bwd": 8, "fused_ce_rows": 1, "fused_ce_rows_bwd": 1,
        "hash_dropout_fwd": 0, "hash_dropout_bwd": 0, "qk_norm_rope_fwd": 24,
        "qk_norm_rope_bwd": 12}
    # flagship at dropout 0.2: 20 residual sites, all but each layer's last run again
    dropped = cs.flagship_config(dropout_rate=cs.DROP_RATE)
    for policy, k1 in ((None, 20), ("full", 32), ("attn", 32), ("dots", 32)):
        launches = cs._remat_launches(dropped, policy)
        assert (launches["hash_dropout_fwd"], launches["hash_dropout_bwd"]) == (k1, 20)


def test_chip_smoke_encdec_phase_on_cpu():
    """Phase 10 of chip_smoke.py (TIGER through train_decoder/test_decoder,
    PBATransformer from its shipped config through train_SMB_decoder/
    test_SMB_decoder, with their gates) at a tiny size on the CPU."""
    import chip_smoke as cs

    spec = dict(n_users=16, n_items=40, n_clusters=4, num_levels=3, level_sizes=(8, 8, 16),
                min_len=8, max_len=16, seed=7)
    tiny = ("--batch_size", "8", "--n_layers", "1", "--hidden_size", "16")
    cs.encdec_phase(torch.device("cpu"), _counters(), "cpu", spec=spec,
                    seq_args=("--backbone", "TIGER", "--learning_rate", "3e-3", *tiny),
                    smb_args=(*cs.PHASE10_SMB[:4], "--tasks", "smb_explicit_decoder_2",
                              "--learning_rate", "3e-3", *tiny),
                    extra_args=("--device", "cpu"), min_steps=(3, 3), num_beams=4)
    assert not any(name.startswith("phase10_") for name in os.listdir(REPO))


def test_chip_smoke_multiprocess_phase_on_cpu():
    """Phase 11 of chip_smoke.py (train_SMB_decoder in a one-process group
    against ungrouped, the grouped `Trainer` steps compiled against eager,
    two worker processes of the script against one, the striped
    test_SMB_decoder, with their gates) at a tiny size on the CPU, on
    gloo."""
    import chip_smoke as cs

    spec = dict(n_users=24, n_items=60, n_clusters=4, num_levels=2, level_sizes=(8, 10),
                min_len=6, max_len=16, seed=3)
    cs.multiprocess_phase(
        torch.device("cpu"), _counters(), "cpu", spec=spec,
        train_args=("--backbone", "Qwen3Multi", "--batch_size", "8", "--dtype", "float32",
                    "--n_layers", "2", "--hidden_size", "16"),
        steps_spec=dict(cfg=dict(tiny=True, dtype="float32", dropout_rate=0.2),
                        geometry=(2, 4, 4)),
        inproc_spec=dict(cfg=dict(tiny=True, dtype="float32", dropout_rate=0.2),
                         geometry=(4, 4), steps=3),
        extra_args=("--device", "cpu"), min_steps=2, num_beams=4)
    assert not any(name.startswith("phase11_") for name in os.listdir(REPO))


def test_chip_smoke_tokenizer_phase_on_cpu():
    """Phase 12 of chip_smoke.py (SemEmb, RQVAE with the k-means init and CF
    embeddings, tokenize rq_vae, the card-vs-CPU step, train_SMB_decoder on
    the emitted semantic IDs, with their gates) at a tiny size on the CPU."""
    import chip_smoke as cs

    spec = dict(n_users=24, n_items=60, n_clusters=4, num_levels=2, level_sizes=(8, 10),
                min_len=6, max_len=16, seed=3)
    cs.tokenizer_phase(
        torch.device("cpu"), _counters(), "cpu", spec=spec,
        rq_args=("--layers", "32,16", "--e_dim", "8", "--num_emb", "8", "--num_levels", "3",
                 "--batch_size", "16", "--alpha", "0.02", "--beta", "0.0001"),
        emb_dim=64, epochs=6, eval_step=3,
        train_args=("--backbone", "Qwen3Multi", "--batch_size", "8", "--dtype", "float32",
                    "--n_layers", "2", "--hidden_size", "16"),
        extra_args=("--device", "cpu"), min_steps=2)
    assert not any(name.startswith("phase12_") for name in os.listdir(REPO))


def test_chip_smoke_rec_phase_on_cpu():
    """Phase 13 of chip_smoke.py (train_SMB_rec for each backbone of the
    discriminative zoo, --only_test on best, the card-vs-CPU step, the
    sampled eval, the BPR epoch, with their gates) at a tiny size on the
    CPU."""
    import chip_smoke as cs

    spec = dict(n_users=60, n_items=30, n_clusters=3, num_levels=2, level_sizes=(8, 10),
                min_len=20, max_len=40, seed=3)
    cs.rec_phase(torch.device("cpu"), _counters(), "cpu", spec=spec,
                 train_args=("--tasks", "smb_dis", "--max_his_len", "6", "--batch_size", "8",
                             "--learning_rate", "1e-2", "--optim", "adamw"),
                 cfg_overrides=dict(n_layers=1, hidden_size=16, inner_size=32,
                                    embedding_size=16),
                 extra_args=("--device", "cpu"), min_steps=40, window=10)
    assert not any(name.startswith("phase13_") for name in os.listdir(REPO))
