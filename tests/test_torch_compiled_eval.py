"""The compiled eval step and the compiled searches on the CPU.

- The device parts of `train/loop.EvalStep` and of the search objects of
  `decode/beam.py` (every behavior mode, a MoeAction preset, the enc-dec
  search) run with reading a tensor into Python and making a tensor from
  host data (`torch.as_tensor`, `torch.tensor`, `torch.from_numpy`)
  patched to raise: they neither branch on a device value nor copy from
  the host, which a CUDA graph's capture would refuse.
- `Trainer.evaluate` through the split eval step against the JAX
  `Trainer.evaluate` on converted weights, with a short last batch, and a
  loss without "denom": fp32, rtol 1e-5.
- The search objects against the JAX package's jitted searches: codes equal
  on live beams, scores at `tests/test_torch_beam.py`'s and
  `tests/test_torch_encdec.py`'s tolerances, on a batch padded with its
  first row; a scalar behavior id stages to the same key, and gives the
  same result, as the [B] array of that id.
- `test_SMB_decoder` with a test batch that leaves a short last chunk (which
  the task pads, as JAX's does) against the JAX task on the same weights:
  metrics within 1e-6.

The CUDA graphs themselves run only on the card
(`tests/test_torch_kernels_gpu.py`, `chip_smoke.py` phases 3, 4, 7, 8, 10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.core.mesh import MeshContext, default_mesh
from gamer_tpu.decode import beam as JB
from gamer_tpu.decode.trie import LeveledTrie as JaxTrie
from gamer_tpu.models.generative import qwen_family as JQ
from gamer_tpu.tasks.train_smb_decoder import make_loss_fn as jax_make_loss_fn
from gamer_tpu.train import loop as JL
from gamer_tpu.train import state as JS
from gamer_tpu_torch.decode import beam as TB
from gamer_tpu_torch.decode.trie import LeveledTrie
from gamer_tpu_torch.models.generative import encdec as TE
from gamer_tpu_torch.models.generative import encdec_utils as TU
from gamer_tpu_torch.models.generative import qwen_family as TQ
from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
from gamer_tpu_torch.train import loop as TL
from gamer_tpu_torch.train import state as TS
from tests import test_torch_encdec as ED
from tests.test_torch_beam import CODE_BASE, LEVELS, SIZE, _prompts
from tests.test_torch_compiled_step import no_reads  # noqa: F401 (fixture)
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_qwen_family import jax_and_port, make_batch, tiny_kwargs
from tests.test_torch_tasks_smb import _jax_weights, e2e, run_jax, run_port  # noqa: F401


@pytest.fixture
def no_host_io(no_reads, monkeypatch):  # noqa: F811
    """A context in which reading a tensor into Python, and making a tensor
    from host data, raise."""
    def forbid():
        no_reads()

        def raise_(*args, **kwargs):
            raise AssertionError("a tensor was made from host data")
        for name in ("as_tensor", "tensor", "from_numpy"):
            monkeypatch.setattr(torch, name, raise_)
    return forbid


# ------------------------------------------------------------- eval step

def _no_denom(loss_fn):
    """The loss without its "denom": batches then weigh by their valid rows."""
    return lambda *args: (loss_fn(*args)[0], {})


@pytest.mark.parametrize("family", ["Qwen3Multi", "Qwen3MoeAction", "TIGER"])
@pytest.mark.parametrize("denom", [True, False])
def test_eval_device_part_reads_nothing_and_copies_nothing(family, denom, no_host_io):
    """`EvalStep.device_part` on staged batches (two, the second shorter)
    under `no_host_io`; the sums equal the eager `Trainer.evaluate` of the
    unsplit loss's batch means, weighted."""
    if family == "TIGER":
        cfg = TE.build_encdec_config("TIGER", **ED.tiny_kwargs("TIGER"))
        model = TE.EncDecModel(cfg, device="cpu", seed=0)
        loss_fn = TU.encdec_loss_fn(model, cfg, deterministic=True)
        batches = [ED.make_batch(cfg, B=B, seed=B) for B in (3, 2)]
    else:
        cfg = TQ.build_config(family, **tiny_kwargs("pallas"))
        model = TQ.QwenFamilyModel(cfg, device="cpu", seed=0)
        loss_fn = make_loss_fn(model, cfg, deterministic=True)
        batches = [make_batch(cfg, B=B, seed=B) for B in (3, 2)]
    if not denom:
        loss_fn = _no_denom(loss_fn)
    step = TL.EvalStep(loss_fn, "cpu")
    staged = [step.stage(b) for b in batches]
    assert staged[0][0] != staged[1][0]  # a short last batch is a second key
    with torch.no_grad():
        want = [loss_fn(b) for b in batches]
        ws = [float(aux["denom"]) if denom else float(b["row_valid"].sum())
              for (_, aux), b in zip(want, batches)]
        total = sum(float(loss) * w for (loss, _), w in zip(want, ws))
        no_host_io()
        for _, static in staged:
            step.device_part(static)
    np.testing.assert_allclose(step.sums.numpy(), [total, sum(ws)], rtol=1e-6)


@pytest.mark.parametrize("denom", [True, False])
def test_trainer_evaluate_matches_jax_trainer(denom):
    """The split `Trainer.evaluate` (eval step, device sums, one read)
    against the JAX `Trainer.evaluate` on converted weights: batches of 3,
    3 and a short last 2 (each with a batch-padding row), the loss's
    "denom" weights or, without it, the valid rows; fp32, rtol 1e-5."""
    backbone, kw = "Qwen3Multi", tiny_kwargs()
    cfg = JQ.build_config(backbone, **kw)
    batches = [make_batch(cfg, B=B, seed=s) for s, B in enumerate((3, 3, 2))]
    jmodel, params, tmodel = jax_and_port(backbone, batches[0], **kw)
    jloss, tloss = jax_make_loss_fn(jmodel, jmodel.cfg), make_loss_fn(tmodel, deterministic=True)
    if not denom:
        jloss, tloss = _no_denom(jloss), _no_denom(tloss)
    ctx = MeshContext(default_mesh(data=1, model=1, devices=jax.devices()[:1]))
    jtrainer = JL.Trainer(jloss, params, JS.OptimizerConfig(), JL.TrainLoopConfig(
        save_checkpoints=False), mesh_ctx=ctx, eval_loss_fn=jloss)
    ttrainer = TL.Trainer(make_loss_fn(tmodel, deterministic=False), tmodel, TS.OptimizerConfig(),
                          TL.TrainLoopConfig(), eval_loss_fn=tloss)
    want = jtrainer.evaluate(batches)
    got = ttrainer.evaluate(batches)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert ttrainer.evaluate(batches) == got  # the sums start again at each evaluate
    assert ttrainer.eval_step().graphs == 0  # the CPU runs the device part eagerly


def test_trainer_evaluate_without_eval_loss_uses_seed_table():
    """Without `eval_loss_fn`, `evaluate` scores the training loss with the
    dropout seeds of `generator(0)`, read from a seed table: equal, bit for
    bit, to the loss with the generator itself."""
    cfg = TQ.build_config("Qwen3Multi", **tiny_kwargs("pallas", dropout_rate=0.2))
    model = TQ.QwenFamilyModel(cfg, device="cpu", seed=0)
    loss_fn = make_loss_fn(model, cfg, deterministic=False)
    trainer = TL.Trainer(loss_fn, model, TS.OptimizerConfig(), TL.TrainLoopConfig(seed=3))
    batch = make_batch(cfg, B=3)
    with torch.no_grad():
        loss, aux = loss_fn(batch, trainer.generator(0))
    assert trainer.evaluate([batch]) == float(loss.float() * aux["denom"].float()) / float(
        aux["denom"])


# ------------------------------------------------------------- searches

def _search_case(backbone: str, mode: str):
    """(JAX model, params, port model, JAX trie, port trie, prompt batch,
    behavior ids) of test_torch_beam.py's geometry; `mode` "none" decodes
    the behavior token over the combined behavior + item trie."""
    codes, bases, batch = _prompts(12, trailing_behavior=mode != "none")
    kw = tiny_kwargs(vocab_size=CODE_BASE + LEVELS * SIZE, num_positions=LEVELS + 1,
                     num_experts=LEVELS + 2)
    jmodel, params, tmodel = jax_and_port(backbone, batch, route_mode="onehot", **kw)
    sizes, tbases = [SIZE] * LEVELS, bases
    if mode == "none":
        codes = np.concatenate([np.repeat(np.arange(3), len(codes))[:, None],
                                np.tile(codes, (3, 1))], axis=1)
        sizes, tbases = [3] + sizes, [14] + bases
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    behavior = {"int": 2, "per_example": np.array([3, 1, 2], np.int32), "none": None}[mode]
    return (jmodel, params, tmodel, JaxTrie.build(codes, sizes, tbases),
            LeveledTrie.build(codes, sizes, tbases), prompt, behavior)


def _pad(batch: dict, behavior, rows: int):
    """`batch` padded to `rows` with its first row, as the test tasks pad a
    last chunk."""
    idx = np.r_[np.arange(len(batch["input_ids"])), np.zeros(rows - len(batch["input_ids"]), int)]
    if isinstance(behavior, np.ndarray):
        behavior = behavior[idx]
    return {k: v[idx] for k, v in batch.items()}, behavior


@pytest.mark.parametrize("mode", ["int", "per_example", "none"])
@pytest.mark.parametrize("backbone", ["Qwen3Multi", "Qwen3MoeAction"])
def test_search_device_part_reads_nothing_and_copies_nothing(backbone, mode, no_host_io):
    """`BeamSearch.device_part` on a staged batch under `no_host_io`, in each
    behavior mode, equal bit for bit to the eager `constrained_beam_search`."""
    _, _, tmodel, _, trie, prompt, behavior = _search_case(backbone, mode)
    cfg = TB.BeamSearchConfig(num_beams=6)
    want = TB.constrained_beam_search(tmodel, prompt, trie, behavior, cfg)
    search = TB.make_beam_search_fn(tmodel, trie, cfg)
    key, static = search.stage(prompt, behavior)
    assert ("behavior_emb_id" in dict((n, s) for n, s, _ in key)) == (mode != "none")
    no_host_io()
    got = search.device_part(static)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_encdec_search_device_part_reads_nothing_and_copies_nothing(no_host_io):
    """The enc-dec search's device part under `no_host_io`, per-row
    prefixes, equal bit for bit to `constrained_beam_search_encdec`."""
    tmodel, trie, enc, prefix = _encdec_case("PBATransformer")[2:]
    cfg = TB.BeamSearchConfig(num_beams=6)
    want = TB.constrained_beam_search_encdec(tmodel, enc, trie, prefix, cfg)
    search = TB.make_beam_search_encdec_fn(tmodel, trie, cfg)
    _, static = search.stage(enc, prefix)
    no_host_io()
    got = search.device_part(static)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("mode", ["int", "per_example", "none"])
@pytest.mark.parametrize("backbone", ["Qwen3Multi", "Qwen3MoeAction"])
def test_search_object_matches_jax_jitted_search(backbone, mode):
    """`make_beam_search_fn`'s object against JAX's jitted
    `make_beam_search_fn` on a batch of 3 rows padded to 4 with its first
    row: codes equal on live beams, scores within 1e-4 (1e-5 for MoeAction
    and the behavior-token decode), the padding row's results those of row
    0."""
    jmodel, params, tmodel, jtrie, trie, prompt, behavior = _search_case(backbone, mode)
    batch, behavior = _pad(prompt, behavior, 4)
    jbeh = jnp.asarray(behavior) if isinstance(behavior, np.ndarray) else behavior
    want_codes, want_scores = JB.make_beam_search_fn(
        jmodel, jtrie, JB.BeamSearchConfig(num_beams=6, cache_dtype="float32"))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jbeh)
    got_codes, got_scores = TB.make_beam_search_fn(
        tmodel, trie, TB.BeamSearchConfig(num_beams=6))(batch, behavior)
    want_codes, want_scores = np.asarray(want_codes), np.asarray(want_scores)
    got_codes, got_scores = got_codes.numpy(), got_scores.numpy()
    tol = 1e-4 if backbone == "Qwen3Multi" and mode != "none" else 1e-5
    np.testing.assert_allclose(got_scores, want_scores, rtol=tol, atol=tol)
    live = want_scores > TB.NEG / 2
    assert live.any() and (live == (got_scores > TB.NEG / 2)).all()
    np.testing.assert_array_equal(got_codes[live], want_codes[live])
    np.testing.assert_array_equal(got_codes[3], got_codes[0])
    np.testing.assert_array_equal(got_scores[3], got_scores[0])


def test_scalar_behavior_id_reaches_the_per_example_key():
    """A scalar id is staged as the [B] array of that id: one key for both
    modes (one CUDA graph on the card), and the same codes and scores."""
    _, _, tmodel, _, trie, prompt, _ = _search_case("Qwen3Multi", "int")
    search = TB.make_beam_search_fn(tmodel, trie, TB.BeamSearchConfig(num_beams=6))
    key, static = search.stage(prompt, 2)
    assert torch.equal(static["behavior_emb_id"], torch.full((3,), 2, dtype=torch.int32))
    assert search.stage(prompt, np.full(3, 2, np.int32))[0] == key
    assert search.stage(prompt, None)[0] != key
    scalar, array = search(prompt, 2), search(prompt, np.full(3, 2, np.int32))
    assert all(torch.equal(a, b) for a, b in zip(scalar, array))
    assert search.graphs == 0  # the CPU runs the device part eagerly


def _encdec_case(backbone: str):
    """(JAX model and params, port model, port trie, encoder batch of 3
    rows padded to 4, per-row [start, behavior token] prefixes), and the
    JAX trie as `jtrie` on the function."""
    from gamer_tpu.data.vocab import SemanticVocab as JaxVocab
    from gamer_tpu_torch.data.vocab import SemanticVocab

    levels = [5, 6, 4]
    kw = dict(vocab_size=14 + 2 + sum(levels))
    cfg = TE.build_encdec_config(backbone, **ED.tiny_kwargs(backbone, **kw))
    batch = ED.make_batch(cfg, B=3, Se=9, seed=2)
    batch["input_ids"] = np.minimum(batch["input_ids"], kw["vocab_size"] - 1)
    jmodel, params, tmodel = ED.jax_and_port(backbone, batch, **kw)
    codes = np.unique(np.random.default_rng(1).integers(0, 4, (40, 3)), axis=0)
    _encdec_case.jtrie = JaxTrie.from_token_rows(
        JaxVocab(levels, behaviors=["a", "b"]).encode_codes(codes),
        JaxVocab(levels, behaviors=["a", "b"]))
    tvocab = SemanticVocab(levels, behaviors=["a", "b"])
    trie = LeveledTrie.from_token_rows(tvocab.encode_codes(codes), tvocab)
    enc, _ = _pad({k: batch[k] for k in ("input_ids", "attention_mask")}, None, 4)
    prefix = np.stack([np.zeros(4, np.int32), np.array([14, 15, 15, 14], np.int32)], axis=1)
    return jmodel, params, tmodel, trie, enc, prefix


@pytest.mark.parametrize("backbone", ["TIGER", "PBATransformer"])
def test_encdec_search_object_matches_jax_jitted_search(backbone):
    """`make_beam_search_encdec_fn`'s object against JAX's jitted enc-dec
    search on a batch padded with its first row, per-row prefixes: codes
    equal on live beams, scores within 1e-4."""
    jmodel, params, tmodel, trie, enc, prefix = _encdec_case(backbone)
    want_codes, want_scores = JB.make_beam_search_encdec_fn(
        jmodel, _encdec_case.jtrie, 2, JB.BeamSearchConfig(num_beams=6, cache_dtype="float32"))(
        params, {k: jnp.asarray(v) for k, v in enc.items()}, jnp.asarray(prefix))
    search = TB.make_beam_search_encdec_fn(tmodel, trie, TB.BeamSearchConfig(num_beams=6))
    got_codes, got_scores = search(enc, prefix)
    want_codes, want_scores = np.asarray(want_codes), np.asarray(want_scores)
    got_codes, got_scores = got_codes.numpy(), got_scores.numpy()
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-4, atol=1e-4)
    live = want_scores > TB.NEG / 2
    assert live.any() and (live == (got_scores > TB.NEG / 2)).all()
    np.testing.assert_array_equal(got_codes[live], want_codes[live])
    np.testing.assert_array_equal(got_codes[3], got_codes[0])
    # a shared [P0] prefix stages as its [B, P0] rows: the per-row key
    assert search.stage(enc, np.array([0, 14], np.int32))[0] == search.stage(enc, prefix)[0]


# ------------------------------------------------------------- the task

def test_task_with_a_short_last_chunk_matches_jax_task(e2e, monkeypatch):  # noqa: F811
    """test_SMB_decoder at a test batch of 9, which leaves a short last chunk
    (padded with its first row, as the JAX task pads it), against the JAX
    task on the port's trained weights: counts equal, per-behavior and
    merged metrics within 1e-6."""
    import gamer_tpu.tasks.test_decoder as JT
    from gamer_tpu.data.vocab import SemanticVocab as JaxVocab

    root, _ = e2e
    argv = ["test_SMB_decoder", "--dataset", "Demo", "--max_his_len", 6, "--test_task",
            "smb_explicit", "--ckpt_path", root / "ckpt", "--test_batch_size", 9,
            "--num_beams", 4]
    got = run_port(argv + ["--data_path", root / "data", "--results_file", root / "short.json"])
    assert sum(got["counts"].values()) % 9, "the last chunk must be short"
    jmodel, jcfg, params = _jax_weights(root / "ckpt")
    vocab = JaxVocab.load(str(root / "ckpt" / "vocab.json"))
    monkeypatch.setattr(JT, "load_generative_model",
                        lambda *a, **k: (jmodel, jcfg, params, vocab, "decoder_only"))
    want = run_jax(argv + ["--data_path", root / "jax_data",
                           "--results_file", root / "jax_short.json"])
    assert got["counts"] == want["counts"]
    for m, v in want["merged"].items():
        assert abs(got["merged"][m] - v) <= 1e-6, m
    for b, metrics in want["per_behavior"].items():
        for m, v in metrics.items():
            assert abs(got["per_behavior"][b][m] - v) <= 1e-6, (b, m)
