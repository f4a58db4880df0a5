"""The port's model axis (`core/mesh.py`, expert-parallel `modules/moe.py`,
vocab-parallel `models/generative/qwen_family.py` and `modules/losses.py`,
the model-group sums of `train/state.py` and `train/loop.py`), on the CPU:

- the port's `param_shardings` equal the JAX package's path for path, for
  the 7 Qwen presets on a (1, 2) and a (1, 4) mesh, including the
  replicate-and-warn case (6 experts on 4);
- the expert-parallel MoE, its shards run in turn and summed, against the
  whole layer (output and grads at 1e-6, dropout 0.2, the seed shift of a
  slice): flagship E 6 and MoeAction E 16, the fused and the plain path;
- the vocab-parallel CE, shards in turn (nll, lse, dh, dE) against
  `fused_ce_rows_plain` on the whole table at 1e-6 (the grads of their
  largest, against its formula in float64), with padded rows, a
  rank of padded rows only and targets below and above a rank's rows;
- sharded processes on gloo: `entry.dryrun_multiprocess` at 1 x 2 and 2 x 2
  against one process (losses 1e-5, codes equal, scores 1e-4); one sharded
  `Trainer` step (1 x 2) against JAX's `Trainer` on a (1, 2) host-device
  mesh on the same converted weights (loss and parameters 1e-5); the step's
  checkpoint reloads in one process with the same eval loss (1e-6), and its
  whole-tensor train state into a fresh sharded model bit for bit;
  `train_SMB_decoder.run(mesh_ctx=...)` at 1 x 2 against the task in one
  process (losses 1e-5);
  `chip_smoke.py`'s phase 14 rehearsed at a tiny size.

Run as a script, this file is one worker process of the sharded step:
`python tests/test_torch_model_axis.py <out_dir>` with the GAMER_* variables set.
"""

import copy
import json
import logging
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THIS = os.path.abspath(__file__)
WORKER_TIMEOUT_S = 240
PRESETS = ["Qwen3", "Qwen3Session", "Qwen3Moe", "Qwen3MoeAction", "Qwen3SessionMoe",
           "Qwen3Multi", "Qwen3SessionMulti"]
# the sharded step: SGD (a parameter moves by lr x its grad, so last-bit grad
# differences stay last-bit), clipping active
STEP_OPT = dict(optim="sgd", learning_rate=0.5, weight_decay=0.0, lr_scheduler_type="constant",
                total_steps=4, max_grad_norm=0.5)
DATA_SPEC = dict(n_users=24, n_items=40, n_clusters=4, num_levels=2, level_sizes=(8, 10),
                 min_len=6, max_len=14, seed=5)


def task_argv(data: str, out: str, *extra) -> list[str]:
    """train_SMB_decoder, one epoch of a 2-layer Qwen3Multi on the CPU."""
    return ["train_SMB_decoder", "--dataset", "Synth", "--data_path", data, "--tasks",
            "smb_explicit_decoder_2", "--backbone", "Qwen3Multi", "--max_his_len", "6",
            "--epochs", "1", "--batch_size", "8", "--n_layers", "2", "--hidden_size", "16",
            "--model_max_length", "128", "--output_dir", out, "--device", "cpu", *extra]


@pytest.fixture(scope="module", autouse=True)
def _one_thread_each():
    """The tiny models here run on one intra-op thread, in this process and
    in the processes it starts (OMP_NUM_THREADS, which `spawn_local` keeps):
    parallel test workers would otherwise each spread every small op over
    all cores."""
    n, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(n)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = env


def _tiny(**kw):
    from tests.test_torch_qwen_family import tiny_kwargs

    return tiny_kwargs(**kw)


# ----------------------------------------------------------------- specs

@pytest.mark.parametrize("model_axis", [2, 4])
@pytest.mark.parametrize("backbone", PRESETS)
def test_param_shardings_equal_jax(backbone, model_axis, caplog):
    import jax
    import jax.numpy as jnp

    from gamer_tpu.core.mesh import MeshContext, default_mesh
    from gamer_tpu.models.generative import qwen_family as JQ
    from gamer_tpu_torch.convert import flax_path
    from gamer_tpu_torch.core.mesh import ProcessMesh, param_shardings
    from gamer_tpu_torch.models.generative import qwen_family as TQ
    from tests.test_torch_qwen_family import make_batch

    jcfg = JQ.build_config(backbone, **_tiny())
    batch = {k: jnp.asarray(v) for k, v in make_batch(jcfg, B=2, blocks=2).items()}
    shapes = jax.eval_shape(lambda: JQ.QwenFamilyModel(jcfg).init(
        jax.random.PRNGKey(0), **JQ.prepare_train_inputs(jcfg, batch)))["params"]
    ctx = MeshContext(default_mesh(data=1, model=model_axis, devices=jax.devices()[:model_axis]))
    flat = jax.tree_util.tree_flatten_with_path(ctx.param_shardings(shapes))[0]
    want = {"/".join(str(k.key) for k in path): tuple(s.spec) for path, s in flat}

    model = TQ.QwenFamilyModel(TQ.QwenFamilyConfig.from_dict(jcfg.to_dict()), device="cpu")
    with caplog.at_level(logging.WARNING, logger="gamer_tpu_torch.mesh"):
        got = {flax_path(model, n): spec for n, spec in
               param_shardings(model, ProcessMesh(1, model_axis)).items()}
    assert got == want
    assert any(spec for spec in got.values())  # the token table splits in every preset
    experts = [spec for path, spec in got.items() if "experts_" in path]
    E = model.layers[0].mlp.experts_gate.shape[0]
    assert all(spec == (("model",) if E % model_axis == 0 else ()) for spec in experts)
    if E % model_axis:  # replicated, with a warning, as JAX does
        assert any("replicating" in r.getMessage() and "experts_" in r.getMessage()
                   for r in caplog.records)


# ------------------------------------------------------------ expert parallelism

def _moe_inputs(backbone: str, seed: int = 0):
    """A tiny model's first MLP (whole) and its routing inputs."""
    from gamer_tpu_torch.entry import make_batch
    from gamer_tpu_torch.models.generative import qwen_family as TQ

    cfg = TQ.build_config(backbone, **_tiny(impl="auto", dropout_rate=0.2))
    model = TQ.QwenFamilyModel(cfg, device="cpu", seed=seed)
    batch = {k: torch.as_tensor(v) for k, v in
             make_batch(cfg, 3, 4, np.random.default_rng(seed)).items()}
    inputs = TQ.prepare_train_inputs(cfg, batch)
    x = torch.randn((3, 20, cfg.hidden_size), generator=torch.Generator().manual_seed(seed))
    return cfg, model.layers[0].mlp, x, inputs


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("backbone,n", [("Qwen3Multi", 2), ("Qwen3MoeAction", 2),
                                        ("Qwen3MoeAction", 4)])
def test_expert_parallel_moe_matches_whole(backbone, n, use_kernel):
    from gamer_tpu_torch.core.distributed import ModelAxis

    cfg, whole, x, inputs = _moe_inputs(backbone)
    whole.use_kernel = use_kernel
    E = whole.experts_gate.shape[0]
    assert E == cfg.total_experts and E % n == 0
    kw = dict(behavior_index=inputs["behavior_index"],
              expert_index=inputs["expert_index"] if cfg.moe_action else None,
              route_mode="periodic", num_positions=cfg.num_positions, deterministic=False,
              dropout_seed=1234, row0=2)
    names = [f"experts_{w}" for w in whole.weight_names]

    xw = x.clone().requires_grad_(True)
    want = whole(xw, inputs["position_index"], **kw)
    gout = torch.randn(want.shape, generator=torch.Generator().manual_seed(9))
    (want * gout).sum().backward()

    xs = x.clone().requires_grad_(True)
    shards, got = [], 0
    for m in range(n):
        shard = copy.deepcopy(whole)
        shard.zero_grad(set_to_none=True)
        for name in names:
            getattr(shard, name).data = getattr(whole, name).data[m * E // n:(m + 1) * E // n]
        shard.model_axis = ModelAxis(m, n)  # no group: the caller sums the shards
        got = got + shard(xs, inputs["position_index"], **kw)
        shards.append(shard)
    (got * gout).sum().backward()
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(xs.grad, xw.grad, **tol)
    for name in names:
        torch.testing.assert_close(torch.cat([getattr(s, name).grad for s in shards]),
                                   getattr(whole, name).grad, **tol)
    torch.testing.assert_close(sum(s.behavior_embedding.weight.grad for s in shards),
                               whole.behavior_embedding.weight.grad, **tol)


# ------------------------------------------------------------ vocab parallelism

@pytest.mark.parametrize("V,Vp,n", [(37, 40, 2), (37, 48, 4), (30, 48, 4)])
def test_vocab_parallel_ce_matches_whole_table(V, Vp, n):
    """Rank blocks of Vp / n rows, real rows below V: (37, 48, 4) leaves the
    last rank one real row, (30, 48, 4) none."""
    from gamer_tpu_torch.modules.losses import (
        combine_vocab_shards, vocab_shard_ce, vocab_shard_ce_grads)
    from gamer_tpu_torch.ops.fused_ce import fused_ce_rows_plain

    g = torch.Generator().manual_seed(V + n)
    N, D, inv_t = 29, 24, 1 / 0.7
    h = torch.randn((N, D), generator=g)
    table = torch.randn((Vp, D), generator=g)
    targets = torch.randint(0, V, (N,), generator=g, dtype=torch.int32)
    valid = (torch.rand((N,), generator=g) > 0.2).to(torch.int32)
    gnll = torch.rand((N,), generator=g)

    want_nll, want_lse = fused_ce_rows_plain(h, table[:V], targets, valid, inv_t)
    # the grads' reference: autograd through the same formula in float64
    hw, tw = h.double().requires_grad_(True), table.double().requires_grad_(True)
    logits = (hw @ tw[:V].T) * inv_t
    tl = torch.where(torch.arange(V)[None, :] == targets.long()[:, None], logits, 0.0).sum(-1)
    nll64 = torch.where(valid == 1, torch.logsumexp(logits, dim=-1) - tl, 0.0)
    (nll64 * gnll.double()).sum().backward()

    rows = Vp // n
    blocks = [(m * rows, table[m * rows:m * rows + max(0, min(rows, V - m * rows))])
              for m in range(n)]
    assert any(b.shape[0] == 0 for _, b in blocks) == (V <= (n - 1) * rows)
    parts = torch.stack([torch.stack(vocab_shard_ce(h, b, targets, valid, inv_t, v0))
                         for v0, b in blocks])
    nll, lse = combine_vocab_shards(parts, valid)
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(nll, want_nll, **tol)
    torch.testing.assert_close(lse, want_lse, **tol)
    dh, de = 0, torch.zeros_like(table)
    for v0, b in blocks:
        dh_m, de_m = vocab_shard_ce_grads(h, b, targets, valid, inv_t, v0, lse, gnll)
        dh = dh + dh_m
        de[v0:v0 + b.shape[0]] = de_m
    # the grads within 1e-6 of their largest (fp32 against float64: the
    # ranks' partial dh sum in another order than one pass over the table)
    for got, want in ((dh, hw.grad.float()), (de, tw.grad.float())):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-6, err
    assert (de[V:] == 0).all()


# ------------------------------------------------------------ sharded processes

@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multiprocess_on_a_model_axis(n):
    """1 x 2 and 2 x 2 (JAX's rule: model 2 when n is even)."""
    from gamer_tpu_torch.entry import dryrun_multiprocess

    single = dryrun_multiprocess(n, device="cpu", timeout_s=WORKER_TIMEOUT_S)
    assert np.isfinite(single["losses"]).all() and single["mesh"] == [1, 1]


def _step_config():
    from gamer_tpu.core.mesh import pad_to_multiple
    from gamer_tpu.models.generative import qwen_family as JQ

    return JQ.build_config("Qwen3Multi", **_tiny(vocab_size=67,
                                                 padded_vocab_size=pad_to_multiple(67, 8)))


def _port_step(out_dir: str) -> None:
    """A worker of the sharded step (1 x 2 on gloo): the converted weights of
    `inputs.pt`, sharded; one `Trainer` step on the whole batch; the eval
    loss; "best" (whole tensors) saved in out_dir/ckpt."""
    from gamer_tpu_torch.core import distributed, trace
    from gamer_tpu_torch.core.mesh import MeshContext, default_mesh
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig, QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
    from gamer_tpu_torch.train.loop import Trainer, TrainLoopConfig
    from gamer_tpu_torch.train.state import OptimizerConfig

    distributed.maybe_initialize(device="cpu")
    try:
        inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=True)
        cfg = QwenFamilyConfig.from_dict(json.loads(inputs["cfg"]))
        model = QwenFamilyModel(cfg, device="cpu")
        model.load_state_dict(inputs["state"])
        ctx = MeshContext(default_mesh(model=2), device="cpu")
        ctx.shard_params(model)
        assert model.embed_tokens.weight.shape[0] == cfg.padded_vocab_size // 2
        trainer = Trainer(make_loss_fn(model, cfg, deterministic=False), model,
                          OptimizerConfig(**STEP_OPT),
                          TrainLoopConfig(save_checkpoints=True, seed=0),
                          output_dir=os.path.join(out_dir, "ckpt"),
                          eval_loss_fn=make_loss_fn(model, cfg, deterministic=True))
        batch = ctx.shard_batch(inputs["batch"])
        calls = trace.counter("all_reduce.model")
        loss = float(trainer.train_step(batch))
        collectives = trace.counter("all_reduce.model") - calls
        eval_loss = trainer.evaluate([batch])
        trainer.ckpt.save("best", trainer.model_state(), {"eval": eval_loss})
        # the whole-tensor train state loads into a fresh sharded model
        again = ctx.shard_params(QwenFamilyModel(cfg, device="cpu", seed=1))
        Trainer(make_loss_fn(again, cfg), again, OptimizerConfig(**STEP_OPT),
                TrainLoopConfig(save_checkpoints=False)).load_train_state(trainer.train_state())
        assert all(torch.equal(p, q) for p, q in zip(again.parameters(), model.parameters()))
        task = _sharded_task(out_dir, ctx)
        if distributed.is_main_process():
            with open(os.path.join(out_dir, "result.json"), "w") as f:
                json.dump({"loss": loss, "eval": eval_loss, "collectives": collectives,
                           "task": task}, f)
    finally:
        distributed.shutdown()


def _sharded_task(out_dir: str, ctx) -> dict:
    """`train_SMB_decoder.run(mesh_ctx=ctx)` through the CLI's parser."""
    import argparse

    from gamer_tpu_torch.tasks import task_list

    parser = argparse.ArgumentParser()
    task_list["train_SMB_decoder"].add_parser(parser.add_subparsers(dest="task"))
    args = vars(parser.parse_args(task_argv(os.path.join(out_dir, "data"),
                                            os.path.join(out_dir, "task"))))
    res = task_list[args.pop("task")]().invoke(**args, mesh_ctx=ctx)
    return {"history": res["history"], "best": res["best_metric"]}


@pytest.fixture(scope="module")
def sharded_step(tmp_path_factory):
    """JAX's `Trainer` step on a (1, 2) host-device mesh, and the port's in
    two gloo processes (`_port_step`), from the same converted weights."""
    import jax
    import jax.numpy as jnp

    from gamer_tpu.core.mesh import MeshContext, default_mesh
    from gamer_tpu.models.generative import qwen_family as JQ
    from gamer_tpu.tasks.train_smb_decoder import make_loss_fn as jax_make_loss_fn
    from gamer_tpu.train import loop as JL
    from gamer_tpu.train import state as JS
    from gamer_tpu_torch.convert import state_dict_from_jax
    from gamer_tpu_torch.core.distributed import spawn_local
    from tests.test_torch_qwen_family import make_batch

    out = str(tmp_path_factory.mktemp("model_axis_step"))
    jcfg = _step_config()
    batch = make_batch(jcfg, B=3)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jmodel = JQ.QwenFamilyModel(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0), **JQ.prepare_train_inputs(jcfg, jbatch))
    # the port's main path: the fused CE, MoE and attention (plain versions on the CPU)
    tcfg = {**jcfg.to_dict(), "attention_impl": "auto", "moe_impl": "auto", "ce_impl": "auto"}
    torch.save({"cfg": json.dumps(tcfg), "state": state_dict_from_jax(params),
                "batch": {k: torch.as_tensor(v) for k, v in batch.items()}},
               os.path.join(out, "inputs.pt"))
    from gamer_tpu_torch.data.synthetic import SyntheticSpec, write_synthetic_dataset

    write_synthetic_dataset(os.path.join(out, "data"), "Synth", SyntheticSpec(**DATA_SPEC))
    spawn_local([[THIS, out]] * 2, backend="gloo", cwd=REPO, timeout_s=WORKER_TIMEOUT_S)

    ctx = MeshContext(default_mesh(data=1, model=2, devices=jax.devices()[:2]))
    trainer = JL.Trainer(jax_make_loss_fn(jmodel, jcfg), params, JS.OptimizerConfig(**STEP_OPT),
                         JL.TrainLoopConfig(save_checkpoints=False, seed=0), mesh_ctx=ctx)
    spec = trainer.state.params["params"]["embed_tokens"]["embedding"].sharding.spec
    assert tuple(spec) == ("model",), spec
    trainer.state, loss, _ = trainer._train_step(trainer.state, ctx.shard_batch(jbatch),
                                                 trainer.base_rng)
    with open(os.path.join(out, "result.json")) as f:
        result = json.load(f)
    return dict(out=out, result=result, jax_loss=float(loss), tcfg=tcfg, batch=batch,
                jax_params=jax.device_get(trainer.state.params))


def test_sharded_step_matches_jax_sharded_trainer(sharded_step):
    from gamer_tpu_torch.convert import to_flax
    from gamer_tpu_torch.core.checkpoint import CheckpointManager
    from tests.test_torch_train import _assert_trees_close

    res = sharded_step["result"]
    np.testing.assert_allclose(res["loss"], sharded_step["jax_loss"], rtol=1e-5)
    # one model-group collective a table lookup, MoE layer forward and backward, CE
    # forward and backward, and the clip norm's sum: 1 + 2 x 2 + 2 + 1
    assert res["collectives"] == 8, res["collectives"]
    state = CheckpointManager(os.path.join(sharded_step["out"], "ckpt")).restore("best")
    _assert_trees_close(to_flax(state, sharded_step["jax_params"]), sharded_step["jax_params"],
                        rtol=1e-5, atol=1e-5)


def test_train_smb_decoder_on_a_model_axis_matches_one_process(sharded_step):
    """`train_SMB_decoder.run(mesh_ctx=...)` at data 1 x model 2 (the vocab
    padded to a multiple of 128 and split, the experts split) against the
    CLI task in one process with the same padded table: every epoch's train
    loss and the best valid loss within 1e-5."""
    from gamer_tpu_torch.__main__ import main
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig

    out = sharded_step["out"]
    cfg = QwenFamilyConfig.from_file(os.path.join(out, "task"))
    assert cfg.padded_vocab_size % 128 == 0 and cfg.padded_vocab_size > cfg.vocab_size
    one = main(task_argv(os.path.join(out, "data"), os.path.join(out, "one"), "--model_overrides",
                         f"padded_vocab_size={cfg.padded_vocab_size}"))
    task = sharded_step["result"]["task"]
    np.testing.assert_allclose([h["train_loss"] for h in task["history"]],
                               [h["train_loss"] for h in one["history"]], rtol=1e-5)
    np.testing.assert_allclose(task["best"], one["best_metric"], rtol=1e-5)


def test_model_axis_checkpoint_reloads_in_one_process(sharded_step):
    from gamer_tpu_torch.core.checkpoint import CheckpointManager
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyConfig, QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    cfg = QwenFamilyConfig.from_dict(sharded_step["tcfg"])
    model = QwenFamilyModel(cfg, device="cpu")
    model.load_state_dict(CheckpointManager(os.path.join(sharded_step["out"], "ckpt"))
                          .restore("best"))
    assert model.embed_tokens.weight.shape[0] == cfg.padded_vocab_size
    loss, _ = make_loss_fn(model, cfg)(sharded_step["batch"])
    np.testing.assert_allclose(float(loss), sharded_step["result"]["eval"], rtol=1e-6)


def test_chip_smoke_model_axis_phase_on_cpu():
    """Phase 14 of chip_smoke.py (two worker processes of the script at data
    1 x model 2 against one process: the steps, a sharded step's launches
    and model-group collectives against the prediction, the search) at a
    tiny size on the CPU, on gloo."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    tiny = dict(tiny=True, dtype="float32")
    spec = dict(steps=dict(cfg=dict(tiny, dropout_rate=0.2), geometry=(2, 4, 4)),
                step16=dict(cfg=dict(tiny, dtype="bfloat16", dropout_rate=0.2),
                            geometry=(4, 4)),
                search=dict(cfg=dict(tiny, vocab_size=1041), geometry=(4, 4, 64, 3)), model=2)
    cs.model_axis_phase(torch.device("cpu"), cs.kernel_counters(), "cpu", spec=spec)
    assert not any(name.startswith("phase14_") for name in os.listdir(REPO))


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _port_step(sys.argv[1])
