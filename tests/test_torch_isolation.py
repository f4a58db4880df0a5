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
