"""Port parity of the training path on the CPU: the training loss and every
parameter's grad of the Qwen3 family (gamer_tpu_torch) against the JAX
package's `make_loss_fn(deterministic=False)` at dropout 0, the parameters
after `Trainer` steps against the JAX `Trainer` (AdamW, warmup-cosine,
clipping, gradient accumulation), the optimizer families and schedules
against optax, fp32 master weights in a bf16 run, and the determinism of the
hash dropout with remat on and off. Tolerance 1e-4 unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gamer_tpu.core.mesh import MeshContext, default_mesh
from gamer_tpu.models.generative import qwen_family as JQ
from gamer_tpu.tasks.train_smb_decoder import make_loss_fn as jax_make_loss_fn
from gamer_tpu.train import loop as JL
from gamer_tpu.train import state as JS
from gamer_tpu_torch.convert import flax_path, to_flax
from gamer_tpu_torch.entry import entry
from gamer_tpu_torch.models.generative import qwen_family as TQ
from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
from gamer_tpu_torch.train import loop as TL
from gamer_tpu_torch.train import state as TS
from tests.test_torch_qwen_family import jax_and_port, make_batch, tiny_kwargs

TOL = dict(rtol=1e-4, atol=1e-4)
# tiny_kwargs sets dropout 0: the JAX MoeAction path draws "bits" dropout from
# its rng stream (gamer_tpu/modules/moe.py:230), which torch cannot reproduce
PRESETS = ["Qwen3", "Qwen3Session", "Qwen3Moe", "Qwen3SessionMoe", "Qwen3Multi",
           "Qwen3SessionMulti", "Qwen3MoeAction"]


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_trees_close(got: dict, want: dict, path: str = "", **tol) -> None:
    for key, w in want.items():
        if isinstance(w, dict):
            _assert_trees_close(got[key], w, f"{path}/{key}", **tol)
        else:
            np.testing.assert_allclose(got[key], np.asarray(w), err_msg=f"{path}/{key}",
                                       **(tol or TOL))


@pytest.mark.parametrize("backbone,impl", [(b, "jnp") for b in PRESETS]
                         + [("Qwen3Multi", "pallas_interpret"),
                            ("Qwen3MoeAction", "pallas_interpret")])
def test_training_loss_and_grads_match_jax(backbone, impl):
    kw = tiny_kwargs(impl)
    batch = make_batch(JQ.build_config(backbone, **kw), B=3)
    jmodel, params, tmodel = jax_and_port(backbone, batch, **kw)
    jloss_fn = jax_make_loss_fn(jmodel, jmodel.cfg, deterministic=False)
    (want, want_aux), want_grads = jax.value_and_grad(jloss_fn, has_aux=True)(
        params, _jbatch(batch), jax.random.PRNGKey(3))
    loss, aux = make_loss_fn(tmodel, deterministic=False)(batch, torch.Generator().manual_seed(3))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    assert int(aux["denom"]) == int(want_aux["denom"])
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    _assert_trees_close(to_flax(grads, params), jax.device_get(want_grads))


def test_trainer_steps_match_jax_trainer():
    """Six micro-steps on two alternating batches with accumulation 2: three
    AdamW updates under warmup-cosine with clipping at 0.5 (active)."""
    backbone, kw = "Qwen3Multi", tiny_kwargs()
    cfg = JQ.build_config(backbone, **kw)
    batches = [make_batch(cfg, B=2, seed=s) for s in (0, 1)]
    jmodel, params, tmodel = jax_and_port(backbone, batches[0], **kw)
    opt = dict(learning_rate=3e-3, lr_scheduler_type="cosine", warmup_steps=1, total_steps=4,
               max_grad_norm=0.5, weight_decay=0.1)
    loop = dict(gradient_accumulation_steps=2, seed=0)
    ctx = MeshContext(default_mesh(data=1, model=1, devices=jax.devices()[:1]))
    jtrainer = JL.Trainer(jax_make_loss_fn(jmodel, jmodel.cfg), params, JS.OptimizerConfig(**opt),
                          JL.TrainLoopConfig(save_checkpoints=False, **loop), mesh_ctx=ctx)
    ttrainer = TL.Trainer(make_loss_fn(tmodel, deterministic=False), tmodel,
                          TS.OptimizerConfig(**opt), TL.TrainLoopConfig(**loop))
    for step in range(6):
        batch = batches[step % 2]
        jtrainer.state, want, _ = jtrainer._train_step(jtrainer.state, ctx.shard_batch(
            _jbatch(batch)), jtrainer.base_rng)
        got = ttrainer.train_step(batch)
        np.testing.assert_allclose(float(got), float(want), **TOL)
    assert ttrainer.updates == 3 and ttrainer.step == int(jtrainer.state.step) == 6
    state = {n: p.detach() for n, p in tmodel.named_parameters()}
    _assert_trees_close(to_flax(state, params), jax.device_get(jtrainer.state.params))


def test_bf16_run_updates_fp32_master_weights():
    """One AdamW step at lr 1e-6 of a bf16 run: the port's parameters stay
    fp32 and move as optax moves JAX's fp32 parameters for the same grads
    (per tensor |d_port - d_jax| <= 1e-2 |d_jax|), while bf16 storage would
    round most of these updates away. The bf16 grads themselves match JAX's
    to bf16 rounding (per tensor 5e-2 relative; Adam's first step, about
    lr * sign(g), would turn the sign flips of near-zero grads into
    differences of 2 lr, so the update is compared on shared grads)."""
    backbone, kw = "Qwen3Multi", tiny_kwargs(dtype="bfloat16")
    batch = make_batch(JQ.build_config(backbone, **kw), B=3)
    jmodel, params, tmodel = jax_and_port(backbone, batch, **kw)
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    opt = dict(learning_rate=1e-6, lr_scheduler_type="constant", max_grad_norm=0.0)
    jax_grads = jax.device_get(jax.grad(lambda p: jax_make_loss_fn(jmodel, jmodel.cfg)(
        p, _jbatch(batch), jax.random.PRNGKey(0))[0])(params))
    loss, _ = make_loss_fn(tmodel, deterministic=False)(batch, torch.Generator().manual_seed(0))
    loss.backward()
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    TS.make_optimizer(TS.OptimizerConfig(**opt), tmodel).step(grads)
    tx = JS.make_optimizer(JS.OptimizerConfig(**opt))
    flax_grads = to_flax(grads, params)
    updates = tx.update(flax_grads, tx.init(params), params)[0]
    want = jax.device_get(jax.tree_util.tree_map(  # the fp32 step as stored: (p + u) - p
        lambda p, u: (p + u) - p, params, updates))
    delta = to_flax({n: p.detach() - before[n] for n, p in tmodel.named_parameters()}, params)
    flat = lambda tree: jax.tree_util.tree_leaves(tree)
    rounded_away = []
    for d, w, g, jg, p in zip(flat(delta), flat(want), flat(flax_grads), flat(jax_grads),
                              flat(to_flax(before, params))):
        w, jg = np.asarray(w, np.float32), np.asarray(jg, np.float32)
        assert np.linalg.norm(d - w) <= 1e-2 * np.linalg.norm(w)
        assert np.linalg.norm(g - jg) <= 5e-2 * np.linalg.norm(jg)
        bf16 = lambda a: torch.tensor(a).bfloat16()
        rounded_away.append(torch.eq(bf16(p + d), bf16(p)).float().mean().item())
    assert np.mean(rounded_away) > 0.5  # bf16 parameters would mostly not move


@pytest.mark.parametrize("optim", ["adamw", "adam", "sgd", "adagrad", "rmsprop", "lion"])
def test_optimizer_families_match_optax(optim):
    rng = np.random.default_rng(7)
    tree = {"dense": {"kernel": rng.standard_normal((5, 3)), "bias": rng.standard_normal(3)},
            "norm": {"scale": rng.standard_normal(4)}}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    flat = {"dense.weight": "dense/kernel", "dense.bias": "dense/bias", "norm.weight": "norm/scale"}
    pick = lambda t, path: t[path.split("/")[0]][path.split("/")[1]]
    cfg = dict(optim=optim, learning_rate=0.05, lr_scheduler_type="linear", warmup_steps=1,
               total_steps=5, max_grad_norm=1.0, weight_decay=0.1)
    tx = JS.make_optimizer(JS.OptimizerConfig(**cfg))
    params = {n: torch.tensor(pick(tree, p)) for n, p in flat.items()}
    opt = TS.Optimizer(TS.OptimizerConfig(**cfg), params,
                       {n: not p.endswith(("scale", "bias")) for n, p in flat.items()})
    jparams, jstate = tree, tx.init(tree)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * (0.3 + step)).astype(np.float32), tree)
        upd, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step({n: torch.tensor(pick(g, p)) for n, p in flat.items()})
    for n, p in flat.items():
        np.testing.assert_allclose(params[n].numpy(), np.asarray(pick(jparams, p)), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_schedules_match_optax(kind):
    for warmup in (0, 3):
        cfg = dict(learning_rate=1e-3, lr_scheduler_type=kind, warmup_steps=warmup,
                   total_steps=12)
        want = JS.make_schedule(JS.OptimizerConfig(**cfg))
        got = TS.make_schedule(TS.OptimizerConfig(**cfg))
        for count in range(15):
            np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-10)
    assert TS.schedule_horizon(100, 8, 2, 3) == JS.schedule_horizon(100, 8, 2, 3)


def test_decay_mask_follows_flax_names():
    model = TQ.QwenFamilyModel(TQ.build_config("Qwen3Multi", **tiny_kwargs()), device="cpu")
    mask = TS.decay_mask(model)
    assert not mask["norm.weight"] and not mask["layers.0.self_attn.q_norm.weight"]
    assert mask["embed_tokens.weight"] and mask["layers.0.self_attn.q_proj.weight"]
    assert mask["layers.0.mlp.experts_gate"]
    assert flax_path(model, "layers.1.self_attn.q_proj.weight") == "layers_1/self_attn/q_proj/kernel"
    assert flax_path(model, "embed_tokens.weight") == "embed_tokens/embedding"


@pytest.mark.parametrize("remat", [False, True])
def test_dropout_is_seeded_and_remat_exact(remat):
    cfg = TQ.build_config("Qwen3Multi", **tiny_kwargs(dropout_rate=0.2, remat=remat))
    batch = make_batch(cfg, B=2)

    def run(seed, use_remat=remat):
        model = TQ.QwenFamilyModel(cfg.replace(remat=use_remat), device="cpu")
        loss, _ = make_loss_fn(model, deterministic=False)(batch, torch.Generator().manual_seed(seed))
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in model.parameters()]

    loss, grads = run(0)
    again, grads_again = run(0)
    assert np.isfinite(loss) and loss == again
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_again))
    assert run(1)[0] != loss
    plain_loss, plain_grads = run(0, use_remat=not remat)  # remat recomputes exactly
    assert plain_loss == loss
    for a, b in zip(grads, plain_grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_trainer_fit_evaluates_and_keeps_the_best(tmp_path):
    from gamer_tpu_torch.core.metrics import MetricWriter

    cfg = TQ.build_config("Qwen3Multi", **tiny_kwargs(dropout_rate=0.1))
    model = TQ.QwenFamilyModel(cfg, device="cpu")
    batches = [make_batch(cfg, B=2, seed=s) for s in range(2)]
    writer = MetricWriter(str(tmp_path), "t", {"a": 1})
    trainer = TL.Trainer(make_loss_fn(model, deterministic=False), model,
                         TS.OptimizerConfig(learning_rate=3e-3, warmup_steps=1, total_steps=6),
                         TL.TrainLoopConfig(epochs=3, patience=5, log_every_steps=1),
                         metric_writer=writer, eval_loss_fn=make_loss_fn(model))
    out = trainer.fit(lambda epoch: iter(batches), lambda: iter(batches))
    assert out["steps"] == 6 and len(out["history"]) == 3
    evals = [h["eval"] for h in out["history"]]
    assert out["best_metric"] == min(evals) and evals[-1] < evals[0]
    manual = trainer.evaluate(batches)
    assert manual == pytest.approx(evals[-1], rel=1e-6)
    assert (tmp_path / "metrics.jsonl").read_text().count("train/loss") == 6
    assert set(trainer.best_params()) == set(model.state_dict())


def test_entry_train_loss_is_differentiable():
    fn, (model, batch) = entry(tiny=True, device="cpu")
    loss = fn(model, batch)
    loss.backward()
    assert torch.isfinite(loss) and model.embed_tokens.weight.grad is not None
