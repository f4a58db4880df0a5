"""The bf16 train-step limits of `chip_smoke.py` (BF16_STEP_LOSS_TOL,
BF16_STEP_GRAD_TOL) separate a sound kernel path from a faulty one: a tiny
Qwen3MoeAction step (2 layers, hidden 32, dropout 0.2, B 4 x 20 blocks) on
the CPU, whose kernel path runs the wrappers' plain versions, passes
`_paths_agree` at those limits, and fails it with each fault that
`scripts/probe_step_tolerance.py` plants on the card (sound reading here: loss
4.9e-5, worst grad 2.5e-2; faults: worst grad 0.63 and more)."""

import importlib.util
import os

import pytest

import chip_smoke as cs
from gamer_tpu_torch.ops import fused_attention as FA
from gamer_tpu_torch.ops import fused_ce as FC
from gamer_tpu_torch.ops import fused_moe as FM
from tests.test_torch_isolation import REPO, _one_torch_thread  # noqa: F401 (autouse fixture)

_spec = importlib.util.spec_from_file_location(
    "probe_step_tolerance", os.path.join(REPO, "scripts", "probe_step_tolerance.py"))
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

COUNTERS = {"fused_mask_attention": FA.fused_mask_attention,
            "fused_mask_attention_bwd": FA.fused_mask_attention_bwd,
            "fused_moe_ffn": FM.fused_moe_ffn, "fused_moe_ffn_bwd": FM.fused_moe_ffn_bwd,
            "fused_ce_rows": FC.fused_ce_rows, "fused_ce_rows_bwd": FC.fused_ce_rows_bwd}
NO_LAUNCHES = {k: 0 for k in COUNTERS}  # CPU tensors run the plain versions


def _step(label: str):
    from gamer_tpu_torch.models.generative.qwen_family import build_config

    cfg = build_config("Qwen3MoeAction", vocab_size=64 + 17, num_positions=5, num_experts=6,
                       num_behavior=3, behavior_base=14, dtype="bfloat16", dropout_rate=0.2,
                       num_hidden_layers=2, hidden_size=32, intermediate_size=64)
    return cs._paths_agree(label, cfg, cs.make_batch(cfg, 4, 20, seed=0), "cpu", 0, COUNTERS,
                           NO_LAUNCHES, loss_tol=cs.BF16_STEP_LOSS_TOL,
                           grad_tol=cs.BF16_STEP_GRAD_TOL)


def test_sound_bf16_step_within_limits():
    loss_rel, grad_rel, _ = _step("sound")
    assert loss_rel <= cs.BF16_STEP_LOSS_TOL and grad_rel <= cs.BF16_STEP_GRAD_TOL


@pytest.mark.parametrize("kind", probe.FAULTS)
def test_planted_fault_breaks_bf16_limits(kind):
    with probe.planted(kind), pytest.raises(AssertionError, match="disagree"):
        _step(kind)
