"""The zoo's and the RQ-VAE's compiled paths on the CPU.

- The device parts of `tasks/train_smb_rec.RecTrainStep` and `RecScorer`
  (each of the six backbones) and of `tasks/rqvae.RQVAEStep` and
  `RQVAEEmit` (BatchNorm off and on, the diversity loss on, dropout on
  and off) run with reading a tensor into Python and making a tensor from
  host data (`torch.as_tensor`, `torch.tensor`, `torch.from_numpy`)
  patched to raise: they neither branch on a device value nor copy from
  the host, which a CUDA graph's capture would refuse.
- The staged step (its seed table and masked-LM or Gumbel draws made on
  the host and staged) against the unstaged step (`train_step`: the same
  generator's draws made inside the forward), three steps from the same
  weights: every loss and every parameter bit for bit; each model's stated
  dropout site count (`dropout_sites`) is the number of seeds its forward
  takes. The staged scorer and emit against the eager scorer and
  `get_indices`, bit for bit.
- MBSTR's relative-position buckets against JAX's.

The zoo's and the tokenizer's task losses and metrics against the JAX
tasks stay in `tests/test_torch_tasks_rec.py` and
`tests/test_torch_tasks_tokenizer.py`; the CUDA graphs themselves run only
on the card (`tests/test_torch_kernels_gpu.py -k compiled`,
`chip_smoke.py` phases 12 and 13).
"""

import numpy as np
import pytest
import torch

from chip_smoke import random_rec_batch
from gamer_tpu_torch.models.discriminative import DisModelConfig
from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig
from gamer_tpu_torch.modules import transformer as TT
from gamer_tpu_torch.tasks import rqvae as RQ
from gamer_tpu_torch.tasks import train_smb_rec as TR
from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)

BACKBONES = ["SASRec", "GRU4Rec", "BERT4Rec", "MBSTR", "MBHT", "PBAT"]
# 2 layers, width 32, 40 items; MBHT's scales divide its length 9
CFG = dict(n_layers=2, n_heads=2, hidden_size=32, inner_size=64, embedding_size=32,
           dropout_prob=0.3, scales=[3, 3, 3], hyper_len=3, num_buckets=8, max_distance=10)
N_ITEMS, N_USERS, HIS, B = 40, 12, 8, 4
# (backbone, config overrides): every backbone, then the variants that change the sites
CASES = [(b, {}) for b in BACKBONES] + [
    ("SASRec", {"loss_type": "BPR"}), ("MBHT", {"enable_ms": False}),
    ("MBHT", {"enable_hg": False}), ("MBSTR", {"behavior_moe": False})]
# (bn, beta, dropout_prob) of the RQ-VAE
RQ_CASES = [(False, 0.01, 0.0), (True, 0.01, 0.0), (True, 0.01, 0.2), (False, 0.0, 0.2)]


@pytest.fixture
def no_host_io(monkeypatch):
    """A context in which reading a tensor into Python, and making a tensor
    from host data, raise."""
    def forbid():
        def read(*args, **kwargs):
            raise AssertionError("a tensor was read into Python")

        def make(*args, **kwargs):
            raise AssertionError("a tensor was made from host data")
        for name in ("__bool__", "__float__", "__int__", "item", "tolist"):
            monkeypatch.setattr(torch.Tensor, name, read)
        for name in ("as_tensor", "tensor", "from_numpy"):
            monkeypatch.setattr(torch, name, make)
    return forbid


def _case_id(case):
    backbone, over = case
    return backbone + "".join(f"-{k}={v}" for k, v in over.items())


def _optimizer(model):
    return make_optimizer(OptimizerConfig(optim="adamw", learning_rate=1e-2, weight_decay=1e-4,
                                          lr_scheduler_type="constant", warmup_ratio=0.0,
                                          max_grad_norm=0.0), model)


def _rec(backbone, overrides=None):
    """(config, length, a fresh model and its optimizer, three batches)."""
    cfg = DisModelConfig(**{**CFG, **(overrides or {})})
    L = HIS + 1 if backbone == "MBHT" else HIS
    model = TR.build_dis_model(backbone, cfg, N_ITEMS, L, 3, N_USERS, "cpu", seed=0)
    batches = [random_rec_batch(B, L, HIS, N_ITEMS, N_USERS, seed=s) for s in range(3)]
    batches[0]["row_valid"][-1] = 0  # a batch-padding row
    return cfg, model, _optimizer(model), batches


def _same_state(a, b) -> list:
    """Names of the state-dict entries of modules `a` and `b` that differ."""
    sa, sb = a.state_dict(), b.state_dict()
    return [n for n in sa if not torch.equal(sa[n], sb[n])]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_staged_rec_step_equals_unstaged(case, monkeypatch):
    """Three `RecTrainStep` steps (the draws staged) against three
    `train_step` steps (the generator's draws in the forward) from the same
    weights and generators: losses and parameters bit for bit, and the
    forward takes `dropout_sites` seeds."""
    backbone, over = case
    cfg, model, opt, batches = _rec(backbone, over)
    taken = []
    seed0 = TT.DropoutSeeds._seed
    monkeypatch.setattr(TT.DropoutSeeds, "_seed",
                        lambda self: (taken.append(self.taken), seed0(self))[1])
    loss_fn = TR.make_dis_loss_fn(backbone, model, cfg)
    want = [float(TR.train_step(model, opt, loss_fn, {k: torch.as_tensor(v) for k, v in b.items()},
                                TR.step_generator(7, i)))
            for i, b in enumerate(batches)]
    assert len(taken) == 3 * model.dropout_sites, (len(taken), model.dropout_sites)
    _, staged_model, staged_opt, _ = _rec(backbone, over)
    step = TR.RecTrainStep(backbone, staged_model, cfg, staged_opt)
    got = [float(step(b, TR.step_generator(7, i))) for i, b in enumerate(batches)]
    assert got == want
    assert _same_state(model, staged_model) == []
    assert step.staged.graphs == 0  # on the CPU the device part runs eagerly


@pytest.mark.parametrize("backbone", BACKBONES)
def test_rec_device_parts_read_nothing_and_copy_nothing(backbone, no_host_io):
    """`RecTrainStep.device_part` and the scorer's on staged inputs under
    `no_host_io`; the scorer's output equals the eager `make_score_fn`'s,
    and a sampled-eval batch (with `all_item`) is a second key."""
    cfg, model, opt, batches = _rec(backbone)
    step = TR.RecTrainStep(backbone, model, cfg, opt)
    staged = [step.stage(b, TR.step_generator(0, i)) for i, b in enumerate(batches[:2])]
    scorer = TR.RecScorer(backbone, model, "cpu")
    sampled = {**batches[2], "all_item": np.ones((B, 5), np.int32)}
    keys = [scorer.staged.stage(b)[0] for b in (batches[2], sampled)]
    assert keys[0] != keys[1]
    score_key, score_in = scorer.staged.stage({n: batches[2][n] for n in TR.SCORE_INPUTS[backbone]})
    with torch.no_grad():
        want = TR.make_score_fn(backbone, model)({k: torch.as_tensor(v)
                                                  for k, v in batches[2].items()})
    no_host_io()
    got = scorer.score_fn(score_in)
    for _, static in staged:
        loss = step.device_part(static)
    assert loss.shape == () and torch.equal(got, want)


def _rq(bn, beta, dropout):
    cfg = RQVAEConfig(in_dim=16, num_emb_list=[8, 6, 8], e_dim=8, layers=[32, 16], bn=bn,
                      beta=beta, dropout_prob=dropout, alpha=0.02, sk_epsilons=[0.0, 0.0, 0.003],
                      sk_iters=10)
    model = RQVAE(cfg, device="cpu", seed=1)
    return model, _optimizer(model)


_RNG = np.random.default_rng(0)
X = torch.as_tensor(_RNG.standard_normal((40, 16)), dtype=torch.float32)
CF = torch.as_tensor(_RNG.standard_normal((40, 8)), dtype=torch.float32)
LABELS = _RNG.integers(0, 3, (3, 8))
ROWS = [_RNG.permutation(40)[:16] for _ in range(3)]


@pytest.mark.parametrize("bn,beta,dropout", RQ_CASES)
def test_staged_rqvae_step_and_emit_equal_unstaged(bn, beta, dropout):
    """Three `RQVAEStep` steps (rows, seed table and Gumbel noise staged)
    against three `tasks/rqvae.train_step` steps on the same rows and
    generators: [loss, recon, quant, cf] and every parameter and BatchNorm
    statistic bit for bit; then `RQVAEEmit` (the last chunk padded) against
    `get_indices` of each chunk."""
    model, opt = _rq(bn, beta, dropout)
    labels = torch.as_tensor(LABELS)
    want = []
    for i, rows in enumerate(ROWS):
        idx = torch.as_tensor(rows)
        loss, aux = RQ.train_step(model, opt, X[idx], CF[idx], labels, RQ.step_generator(0, 1, i))
        want.append([float(loss)] + [float(aux[k]) for k in RQ.AUX])
    staged_model, staged_opt = _rq(bn, beta, dropout)
    step = RQ.RQVAEStep(staged_model, staged_opt, X, CF)
    step.set_labels(LABELS)
    got = torch.stack([step(rows, RQ.step_generator(0, 1, i))
                       for i, rows in enumerate(ROWS)]).tolist()
    assert got == want
    assert _same_state(model, staged_model) == []
    codes = RQ.RQVAEEmit(staged_model, X, 16)()
    assert codes.shape == (40, 3)
    np.testing.assert_array_equal(codes, np.concatenate(
        [staged_model.get_indices(X[s:s + 16]).numpy() for s in range(0, 40, 16)]))


@pytest.mark.parametrize("bn,beta,dropout", RQ_CASES)
def test_rqvae_device_parts_read_nothing_and_copy_nothing(bn, beta, dropout, no_host_io):
    """`RQVAEStep.device_part` (two staged steps) and `RQVAEEmit`'s device
    part under `no_host_io`."""
    model, opt = _rq(bn, beta, dropout)
    step = RQ.RQVAEStep(model, opt, X, CF)
    step.set_labels(LABELS)
    staged = [step.stage(rows, RQ.step_generator(0, 0, i)) for i, rows in enumerate(ROWS[:2])]
    emit = RQ.RQVAEEmit(model, X, 16)
    _, emit_in = emit.staged.stage({"rows": np.arange(16, dtype=np.int64)})
    no_host_io()
    for _, static in staged:
        out = step.device_part(static)
    assert out.shape == (1 + len(RQ.AUX),)
    assert emit.device_part(emit_in).shape == (16, 3)


@pytest.mark.parametrize("L,num_buckets,max_distance", [(20, 32, 40), (21, 32, 40), (9, 8, 10),
                                                        (50, 32, 40), (128, 16, 64)])
def test_rel_pos_bucket_equals_jax(L, num_buckets, max_distance):
    """MBSTR's buckets, their divisor's log now taken of a float32 fill on
    the device, against JAX's; phase 13's length 20 and the shipped
    num_buckets 32 / max_distance 40 first."""
    from gamer_tpu.models.discriminative.mbstr import rel_pos_bucket as jax_bucket
    from gamer_tpu_torch.models.discriminative.mbstr import rel_pos_bucket

    np.testing.assert_array_equal(rel_pos_bucket(L, L, num_buckets, max_distance).numpy(),
                                  np.asarray(jax_bucket(L, L, num_buckets, max_distance)))
