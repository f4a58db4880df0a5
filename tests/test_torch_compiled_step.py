"""The compiled training step's pieces on the CPU: the optimizer's
device-scalar path (plain kernel L) against optax, the device step reading no
tensor into Python, the training forward with its dropout seeds read from a
seed table against the int seeds (bit for bit) and against JAX, and the split
`Trainer` step against the unsplit step it replaces and against the JAX
`Trainer`. The CUDA graph itself and kernel L run only on the card
(`tests/test_torch_kernels_gpu.py`, `chip_smoke.py` phases 2e and 5)."""

import copy

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
from gamer_tpu_torch.convert import to_flax
from gamer_tpu_torch.core.distributed import ModelAxis
from gamer_tpu_torch.models.generative import qwen_family as TQ
from gamer_tpu_torch.ops import seeds as SD
from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn
from gamer_tpu_torch.train import loop as TL
from gamer_tpu_torch.train import state as TS
from tests.test_torch_qwen_family import jax_and_port, make_batch, tiny_kwargs
from tests.test_torch_train import TOL, _assert_trees_close, _jbatch


# ------------------------------------------------------------------ optimizer

@pytest.mark.parametrize("optim", ["adamw", "adam", "sgd", "adagrad", "rmsprop", "lion"])
def test_device_scalar_optimizer_matches_optax(optim):
    """20 updates of a warmup-cosine schedule through `prepare` (the host
    writes lr and the bias corrections into the device scalar buffer) and
    `apply` (the plain version of kernel L reads them), the clip active on
    some updates and not on others: rtol 1e-5, atol 1e-6 against optax."""
    rng = np.random.default_rng(11)
    tree = {"dense": {"kernel": rng.standard_normal((5, 3)), "bias": rng.standard_normal(3)},
            "norm": {"scale": rng.standard_normal(4)}}
    tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    flat = {"dense.weight": "dense/kernel", "dense.bias": "dense/bias", "norm.weight": "norm/scale"}
    pick = lambda t, path: t[path.split("/")[0]][path.split("/")[1]]
    cfg = dict(optim=optim, learning_rate=0.05, lr_scheduler_type="cosine", warmup_steps=3,
               total_steps=20, max_grad_norm=1.0, weight_decay=0.1)
    tx = JS.make_optimizer(JS.OptimizerConfig(**cfg))
    params = {n: torch.tensor(pick(tree, p)) for n, p in flat.items()}
    opt = TS.Optimizer(TS.OptimizerConfig(**cfg), params,
                       {n: not p.endswith(("scale", "bias")) for n, p in flat.items()})
    jparams, jstate = tree, tx.init(tree)
    clipped = []
    for step in range(20):
        scale = 0.05 if step % 3 else 0.6  # the norm of 12 N(0, scale^2): ~0.17 or ~2
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32), tree)
        clipped.append(optax.global_norm(g) >= 1.0)
        upd, jstate = tx.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        lr = opt.prepare()
        assert opt.scalars[0].item() == np.float32(lr)
        opt.apply({n: torch.tensor(pick(g, p)) for n, p in flat.items()})
    assert any(clipped) and not all(clipped)
    assert opt.count == 20
    for n, p in flat.items():
        np.testing.assert_allclose(params[n].numpy(), np.asarray(pick(jparams, p)), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


@pytest.fixture
def no_reads(monkeypatch):
    """A context in which reading a tensor into Python raises."""
    def forbid():
        def raise_(*args, **kwargs):
            raise AssertionError("a tensor was read into Python")
        for name in ("__bool__", "__float__", "__int__", "item", "tolist"):
            monkeypatch.setattr(torch.Tensor, name, raise_)
    return forbid


def _tiny_trainer(k: int, graphed: bool = True, dropout: float = 0.2, seed: int = 0):
    cfg = TQ.build_config("Qwen3Multi", **tiny_kwargs(dropout_rate=dropout))
    model = TQ.QwenFamilyModel(cfg, device="cpu", seed=seed)
    trainer = TL.Trainer(make_loss_fn(model, deterministic=False), model,
                         TS.OptimizerConfig(learning_rate=3e-3, warmup_steps=1, total_steps=4,
                                            max_grad_norm=0.5, weight_decay=0.1),
                         TL.TrainLoopConfig(gradient_accumulation_steps=k, seed=0),
                         graphed=graphed)
    return cfg, model, trainer


@pytest.mark.parametrize("k", [1, 2])
def test_optimizer_and_device_step_read_no_tensor(k, no_reads):
    """`Optimizer.step` and every micro-step's device part run with
    `Tensor.__bool__`, `__float__`, `__int__`, `item` and `tolist` patched to
    raise: neither branches on nor copies out a device value (the host part,
    which draws the seeds and stages the batch, runs before the patch)."""
    cfg, model, trainer = _tiny_trainer(k)
    batch = make_batch(cfg, B=2)
    staged = [trainer._prepare(batch, mini, k) for mini in range(k)]
    params = dict(model.named_parameters())
    opt = TS.Optimizer(TS.OptimizerConfig(max_grad_norm=1e-3), params, TS.decay_mask(model))
    grads = {n: torch.ones_like(p) for n, p in params.items()}
    no_reads()
    opt.step(grads)  # the clip is active at this norm
    for mini, (inputs, seeds) in enumerate(staged):
        loss = trainer._device_step(inputs, seeds, mini, k)
    assert loss.shape == ()


# ------------------------------------------------------------ seeds in memory

def _grads(model, cfg, batch, source, row0: int = 0):
    loss_fn = make_loss_fn(model, cfg, deterministic=False)
    model.zero_grad(set_to_none=True)
    if row0:  # rows row0.. of the global batch, as a process group would feed them
        inputs = TQ.prepare_train_inputs(cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
        out = model(**inputs, route_mode="periodic", deterministic=False, generator=source,
                    row0=row0)
        loss = out["logits"].float().square().mean()
    else:
        loss, _ = loss_fn(batch, source)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("backbone", ["Qwen3Multi", "Qwen3MoeAction"])
@pytest.mark.parametrize("row0", [0, 3])
def test_seed_table_forward_equals_int_seeds(backbone, row0):
    """The training forward with its seeds read from a seed table (each site
    a `DeviceSeed`: the table entry plus the call site's row offsets) gives
    the int path's loss and grads bit for bit, dropout 0.2 on every site, on
    the fused (plain kernel) path; from row0 > 0 too."""
    cfg = TQ.build_config(backbone, **tiny_kwargs("pallas", dropout_rate=0.2))
    model = TQ.QwenFamilyModel(cfg, device="cpu", seed=1)
    batch = make_batch(cfg, B=3, seed=row0)
    table = SD.draw(torch.Generator().manual_seed(5), model.dropout_sites).to(torch.int32)
    want = _grads(model, cfg, batch, torch.Generator().manual_seed(5), row0)
    got = _grads(model, cfg, batch, table, row0)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][n], want[1][n]) for n in want[1])
    moved = _grads(model, cfg, batch, table + 1, row0)  # other seeds, other masks
    assert not torch.equal(moved[0], want[0])


@pytest.mark.parametrize("use_kernel", [True, False])
def test_seed_table_in_an_expert_window_equals_int_seed(use_kernel):
    """An expert-parallel shard whose window starts past position 0 (rank 1
    of 2) shifts its seed by the window's first position: a `DeviceSeed`
    carries the shift in its add and draws the int seed's masks."""
    cfg = TQ.build_config("Qwen3MoeAction", **tiny_kwargs(dropout_rate=0.2))
    model = TQ.QwenFamilyModel(cfg, device="cpu", seed=2)
    batch = {k: torch.as_tensor(v) for k, v in make_batch(cfg, 3, 4).items()}
    inputs = TQ.prepare_train_inputs(cfg, batch)
    mlp = copy.deepcopy(model.layers[0].mlp)
    mlp.use_kernel = use_kernel
    E = mlp.experts_gate.shape[0]
    for name in ("experts_gate", "experts_up", "experts_down"):
        getattr(mlp, name).data = getattr(mlp, name).data[E // 2:]
    mlp.model_axis = ModelAxis(1, 2)
    x = torch.randn((3, 20, cfg.hidden_size), generator=torch.Generator().manual_seed(4))
    table = torch.tensor([7, 987654321], dtype=torch.int32)
    kw = dict(behavior_index=inputs["behavior_index"], expert_index=inputs["expert_index"],
              route_mode="periodic", num_positions=cfg.num_positions, deterministic=False, row0=2)
    want = mlp(x, inputs["position_index"], dropout_seed=987654321, **kw)
    got = mlp(x, inputs["position_index"], dropout_seed=SD.DeviceSeed(table, 1), **kw)
    assert want.abs().sum() > 0 and torch.equal(got, want)


def test_seed_table_forward_matches_jax():
    """The seed-table forward against JAX's `make_loss_fn(deterministic=
    False)` on the same weights, loss and every grad within 1e-4, as
    `test_torch_train.py` holds the int path (dropout 0 there too: JAX draws
    its masks from its own rng)."""
    kw = tiny_kwargs()
    batch = make_batch(JQ.build_config("Qwen3Multi", **kw), B=3)
    jmodel, params, tmodel = jax_and_port("Qwen3Multi", batch, **kw)
    (want, _), want_grads = jax.value_and_grad(
        jax_make_loss_fn(jmodel, jmodel.cfg, deterministic=False), has_aux=True)(
        params, _jbatch(batch), jax.random.PRNGKey(3))
    table = torch.arange(tmodel.dropout_sites, dtype=torch.int32)
    loss, _ = make_loss_fn(tmodel, deterministic=False)(batch, table)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), **TOL)
    grads = {n: p.grad for n, p in tmodel.named_parameters()}
    _assert_trees_close(to_flax(grads, params), jax.device_get(want_grads))


# ------------------------------------------------------------ the split step

def _unsplit_steps(trainer: TL.Trainer, batches: list, steps: int) -> list:
    """The micro-step before the split, verbatim but for the optimizer call:
    the loss function fed the numpy batch and the micro-step's generator,
    the first micro-step's grads taken as the accumulator, the running mean
    by a Python divisor, `Optimizer.step` on the update micro-step."""
    losses, acc = [], None
    k = max(trainer.cfg.gradient_accumulation_steps, 1)
    for step in range(steps):
        mini = step % k
        for p in trainer.params.values():
            p.grad = None
        loss, _ = trainer.loss_fn(batches[step % len(batches)], trainer.generator(step))
        loss.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in trainer.params.items()}
        if acc is None:
            acc = grads
        else:
            for n, g in grads.items():
                acc[n].add_((g - acc[n]) / (mini + 1))
        for p in trainer.params.values():
            p.grad = None
        if mini == k - 1:
            trainer.optimizer.step(acc)
            acc = None
        losses.append(loss.detach())
    return losses


@pytest.mark.parametrize("k", [1, 2])
def test_split_step_equals_the_unsplit_step(k):
    """Four micro-steps on two alternating batches (dropout 0.2): the split
    step (host part, then the device part on the static buffers, eagerly on
    the CPU) against the unsplit step: every loss and parameter bit for bit."""
    cfg, model, trainer = _tiny_trainer(k)
    _, ref_model, ref = _tiny_trainer(k)
    batches = [make_batch(cfg, B=2, seed=s) for s in (0, 1)]
    got = [trainer.train_step(batches[s % 2]) for s in range(4)]
    want = _unsplit_steps(ref, batches, 4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert trainer.updates == ref.updates == 4 // k and trainer.graphs == 0
    for (n, p), q in zip(model.named_parameters(), ref_model.parameters()):
        assert torch.equal(p, q), n


def test_split_step_matches_jax_trainer_without_accumulation():
    """The split step at accumulation 1 against the JAX `Trainer` (four
    AdamW updates, warmup-cosine, clipping at 0.5 active), as
    `test_torch_train.py::test_trainer_steps_match_jax_trainer` holds
    accumulation 2: losses and parameters within 1e-4."""
    backbone, kw = "Qwen3Multi", tiny_kwargs()
    cfg = JQ.build_config(backbone, **kw)
    batches = [make_batch(cfg, B=2, seed=s) for s in (0, 1)]
    jmodel, params, tmodel = jax_and_port(backbone, batches[0], **kw)
    opt = dict(learning_rate=3e-3, lr_scheduler_type="cosine", warmup_steps=1, total_steps=4,
               max_grad_norm=0.5, weight_decay=0.1)
    ctx = MeshContext(default_mesh(data=1, model=1, devices=jax.devices()[:1]))
    jtrainer = JL.Trainer(jax_make_loss_fn(jmodel, jmodel.cfg), params, JS.OptimizerConfig(**opt),
                          JL.TrainLoopConfig(save_checkpoints=False, seed=0), mesh_ctx=ctx)
    ttrainer = TL.Trainer(make_loss_fn(tmodel, deterministic=False), tmodel,
                          TS.OptimizerConfig(**opt), TL.TrainLoopConfig(seed=0))
    for step in range(4):
        batch = batches[step % 2]
        jtrainer.state, want, _ = jtrainer._train_step(jtrainer.state, ctx.shard_batch(
            _jbatch(batch)), jtrainer.base_rng)
        np.testing.assert_allclose(float(ttrainer.train_step(batch)), float(want), **TOL)
    assert ttrainer.updates == 4
    state = {n: p.detach() for n, p in tmodel.named_parameters()}
    _assert_trees_close(to_flax(state, params), jax.device_get(jtrainer.state.params))


def test_mid_cycle_accumulator_round_trips_through_train_state():
    """A checkpoint taken mid-cycle (accumulation 2, after one micro-step)
    restores the static accumulator in place: the resumed run's next step
    and parameters equal the uninterrupted run's bit for bit."""
    cfg, model, trainer = _tiny_trainer(2)
    batches = [make_batch(cfg, B=2, seed=s) for s in (0, 1)]
    trainer.train_step(batches[0])
    state = copy.deepcopy(trainer.train_state())
    assert set(state["acc"]) == set(trainer.params)
    _, resumed_model, resumed = _tiny_trainer(2, seed=3)
    resumed.load_train_state(state)
    acc = resumed._acc
    assert torch.equal(resumed.train_step(batches[1]), trainer.train_step(batches[1]))
    assert resumed._acc is acc and resumed.train_state()["acc"] == {}
    for p, q in zip(model.parameters(), resumed_model.parameters()):
        assert torch.equal(p, q)


def test_kernel_counters_cover_every_expected_launch():
    """`chip_smoke.kernel_counters()` (which its probes pass too) names
    every wrapper whose launches a step is expected to make: a forward and
    backward's, and a `Trainer` step's with kernel L's L1 and L2 (a probe
    that passed the a-k counters alone failed on the card once K1 and K2
    joined the expected launches)."""
    import chip_smoke as cs

    cfg = cs.flagship_config(dropout_rate=cs.DROP_RATE)
    counters = cs.kernel_counters()
    assert set(cs._step_launches(cfg)) < set(cs._train_step_launches(cfg)) == set(counters)
    assert {k: cs._train_step_launches(cfg)[k] for k in cs.UPDATE_LAUNCHES} == {
        "global_norm_sq": 1, "apply_update": 1}
