"""The port's tokenizer ops and model against the JAX package, on inputs
made from a numpy seed:

- `sinkhorn` and `balanced_assign` at 1e-5;
- Lloyd and balanced k-means from JAX's initial centers (its greedy
  k-means++ seeding, which torch cannot redraw): labels equal, centers at
  1e-5; the empty-cluster reseed of `update_centers` equal to JAX's;
- `kmeans` and `balanced_kmeans` from the port's own seeding: inertia within
  5% of JAX's, cluster sizes as balanced;
- the RQ-VAE forward, `rq_loss` and `rqvae_loss` on parameters converted
  from flax (`convert.py`), bn off and on, with JAX's diversity positives
  (its Gumbel noise handed over): at 1e-5; the BatchNorm running statistics
  after a training forward; the eval-mode indices, `last_level_distances`;
- 3 AdamW steps of the `RQVAE` training step (`tasks/rqvae.train_step`):
  losses and parameters at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gamer_tpu.models.tokenizer.rqvae import RQVAE as JaxRQVAE
from gamer_tpu.models.tokenizer.rqvae import RQVAEConfig as JaxRQVAEConfig
from gamer_tpu.models.tokenizer.rqvae import rqvae_loss as jax_rqvae_loss
from gamer_tpu.ops import kmeans as JK
from gamer_tpu.ops import sinkhorn as JS
from gamer_tpu.train.state import OptimizerConfig as JaxOptimizerConfig
from gamer_tpu.train.state import make_optimizer as jax_make_optimizer
from gamer_tpu_torch.convert import load_jax_params, state_dict_from_jax, to_flax
from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig, rqvae_loss
from gamer_tpu_torch.ops import kmeans as TK
from gamer_tpu_torch.ops import sinkhorn as TS
from gamer_tpu_torch.tasks.rqvae import train_step
from gamer_tpu_torch.train.state import OptimizerConfig, make_optimizer
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)


def planted(n: int = 240, k: int = 8, d: int = 6, seed: int = 0, spread: float = 5.0):
    """`k` well-separated clusters of `n` points (no near-ties)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * spread
    return (centers[rng.integers(0, k, n)] + rng.normal(size=(n, d))).astype(np.float32)


def inertia(x: np.ndarray, centers, labels) -> float:
    return float(((x - np.asarray(centers)[np.asarray(labels)]) ** 2).sum())


# --------------------------------------------------------------------------- sinkhorn


@pytest.mark.parametrize("eps,iters", [(0.003, 50), (0.05, 20), (1.0, 5)])
def test_sinkhorn_and_balanced_assign_match_jax(eps, iters):
    rng = np.random.default_rng(int(eps * 1000))
    d = (rng.normal(size=(48, 12)) ** 2).astype(np.float32)
    np.testing.assert_allclose(TS.center_distance(torch.tensor(d)).numpy(),
                               np.asarray(JS.center_distance(jnp.asarray(d))), rtol=1e-5,
                               atol=1e-6)
    got = TS.sinkhorn(TS.center_distance(torch.tensor(d)), eps, iters).numpy()
    want = np.asarray(JS.sinkhorn(JS.center_distance(jnp.asarray(d)), eps, iters))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.sum(axis=1), np.ones(48), rtol=1e-3)
    np.testing.assert_array_equal(TS.balanced_assign(torch.tensor(d), eps, iters).numpy(),
                                  np.asarray(JS.balanced_assign(jnp.asarray(d), eps, iters)))


def test_balanced_assign_spreads_tied_rows():
    """tests/test_rqvae.py's case: near-identical rows crowd one cluster
    greedily; the balanced assignment spreads them, as JAX's does."""
    rng = np.random.default_rng(0)
    d = (np.tile(np.arange(8) * 0.01, (32, 1)) + 1e-4 * rng.normal(size=(32, 8))).astype(
        np.float32)
    idx = TS.balanced_assign(torch.tensor(d), 0.003, 100).numpy()
    assert np.bincount(idx, minlength=8).max() <= 8
    np.testing.assert_array_equal(idx, np.asarray(JS.balanced_assign(jnp.asarray(d), 0.003,
                                                                     100)))


# --------------------------------------------------------------------------- k-means


@pytest.mark.parametrize("k,seed", [(8, 0), (12, 1), (5, 2)])
def test_lloyd_from_jax_centers_matches_jax(k, seed):
    x = planted(k=max(k, 8), seed=seed)
    init = np.asarray(JK._init_centers(jnp.asarray(x), k, jax.random.PRNGKey(seed)))
    jc, jl = JK.kmeans(jnp.asarray(x), k, iters=10, seed=seed)
    tc, tl = TK.kmeans(x, k, iters=10, centers=torch.tensor(init))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,seed", [(8, 0), (6, 3)])
def test_balanced_lloyd_from_jax_centers_matches_jax(k, seed):
    x = planted(n=96, k=k, seed=seed)
    init = np.asarray(JK._init_centers(jnp.asarray(x), k, jax.random.PRNGKey(seed)))
    jc, jl = JK.balanced_kmeans(jnp.asarray(x), k, iters=10, seed=seed)
    tc, tl = TK.balanced_kmeans(x, k, iters=10, centers=torch.tensor(init))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)


def test_update_centers_reseeds_empty_clusters_as_jax():
    """Clusters 2 and 5 get no point: each takes one of the points farthest
    from its center, in JAX's stable order (ties included: duplicated
    points)."""
    x = planted(n=40, k=4, seed=4)
    x[10] = x[11]  # a tie in the reseed order
    labels = np.random.default_rng(0).choice([0, 1, 3, 4, 6], size=40).astype(np.int32)
    old = np.random.default_rng(1).normal(size=(7, x.shape[1])).astype(np.float32)
    want = np.asarray(JK._update_centers(jnp.asarray(x), jnp.asarray(labels), 7,
                                         jnp.asarray(old)))
    got = TK.update_centers(torch.tensor(x), torch.tensor(labels, dtype=torch.int64), 7,
                            torch.tensor(old)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not np.allclose(got[2], old[2]) and not np.allclose(got[5], old[5])


@pytest.mark.parametrize("n_init", [1, 4])
def test_kmeans_from_own_seeding_as_good_as_jax(n_init):
    x = planted(n=600, k=16, d=8, seed=5, spread=2.0)
    jc, jl = JK.kmeans(jnp.asarray(x), 16, iters=20, seed=0, n_init=n_init)
    tc, tl = TK.kmeans(x, 16, iters=20, seed=0, n_init=n_init)
    assert inertia(x, tc, tl) <= 1.05 * inertia(x, jc, jl)
    assert tl.dtype == torch.int64 and tl.shape == (600,)


def test_balanced_kmeans_from_own_seeding_as_balanced_as_jax():
    x = np.random.default_rng(1).normal(size=(64, 6)).astype(np.float32)
    jc, jl = JK.balanced_kmeans(jnp.asarray(x), 8, iters=10, seed=0)
    tc, tl = TK.balanced_kmeans(x, 8, iters=10, seed=0)
    jn, tn = np.bincount(np.asarray(jl), minlength=8), np.bincount(tl.numpy(), minlength=8)
    assert tn.min() >= 2 and tn.max() <= 16, tn  # tests/test_rqvae.py's bounds
    assert tn.max() - tn.min() <= jn.max() - jn.min() + 4, (tn, jn)
    assert inertia(x, tc, tl) <= 1.05 * inertia(x, jc, jl)
    labels = TK.cluster_codebook(x, 4, seed=0)
    assert labels.shape == (64,) and set(labels.tolist()) <= set(range(4))


def test_kmeans_seeding_is_reproducible():
    x = torch.tensor(planted(seed=6))
    a = TK.init_centers(x, 8, 3)
    b = TK.init_centers(x, 8, 3)
    assert torch.equal(a, b) and len(torch.unique(a, dim=0)) == 8


# --------------------------------------------------------------------------- RQ-VAE


def _cfg(**kw):
    d = dict(in_dim=16, num_emb_list=[8, 6, 8], e_dim=4, layers=[32, 8], alpha=0.02, beta=0.1,
             sk_epsilons=[0.0, 0.0, 0.003])
    d.update(kw)
    return d


def _pair(bn: bool, **kw):
    """A JAX RQ-VAE, its variables and the port's model on them."""
    jm = JaxRQVAE(JaxRQVAEConfig(**_cfg(bn=bn, **kw)))
    x = np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = RQVAE(RQVAEConfig(**_cfg(bn=bn, **kw)), device="cpu")
    load_jax_params(tm, variables)
    return jm, variables, tm, x


def _noise(rng, B: int, sizes) -> list[torch.Tensor]:
    """JAX's Gumbel noise of the diversity positives, level by level."""
    return [torch.tensor(np.asarray(jax.random.gumbel(jax.random.fold_in(rng, lvl), (B, n))))
            for lvl, n in enumerate(sizes)]


@pytest.mark.parametrize("bn", [False, True])
def test_rqvae_forward_and_losses_match_jax(bn):
    jm, v, tm, x = _pair(bn)
    rng = np.random.default_rng(1)
    cf = rng.normal(size=(16, 4)).astype(np.float32)
    labels = rng.integers(0, 3, (3, 8))
    drng = jax.random.PRNGKey(2)
    kws = dict(diversity_labels=jnp.asarray(labels), diversity_rng=drng, deterministic=False)
    if bn:
        jo, stats = jm.apply(v, jnp.asarray(x), mutable=["batch_stats"], **kws)
    else:
        jo = jm.apply(v, jnp.asarray(x), **kws)
    to = tm(torch.tensor(x), deterministic=False, diversity_labels=torch.tensor(labels),
            diversity_noise=_noise(drng, 16, [8, 6, 8]))
    np.testing.assert_array_equal(to["indices"].numpy(), np.asarray(jo["indices"]))
    for key in ("out", "x_e", "x_q", "rq_loss"):
        np.testing.assert_allclose(to[key].detach().numpy(), np.asarray(jo[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    jl, jaux = jax_rqvae_loss(jm.cfg, jo, jnp.asarray(x), jnp.asarray(cf))
    tl, taux = rqvae_loss(tm.cfg, to, torch.tensor(x), torch.tensor(cf))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for key in ("recon_loss", "quant_loss", "cf_loss"):
        np.testing.assert_allclose(float(taux[key].detach()), float(jaux[key]), rtol=1e-5,
                                   err_msg=key)
    if bn:  # the running statistics after one training forward
        want = state_dict_from_jax({"params": {}, "batch_stats": stats["batch_stats"]})
        for name, t in want.items():
            np.testing.assert_allclose(tm.get_buffer(name).numpy(), t.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("bn", [False, True])
def test_rqvae_eval_indices_and_distances_match_jax(bn):
    jm, v, tm, x = _pair(bn)
    for use_sk in (False, True):
        np.testing.assert_array_equal(
            tm.get_indices(torch.tensor(x), use_sk=use_sk).numpy(),
            np.asarray(jm.apply(v, jnp.asarray(x), use_sk=use_sk, method=JaxRQVAE.get_indices)))
    np.testing.assert_allclose(
        tm.last_level_distances(torch.tensor(x)).numpy(),
        np.asarray(jm.apply(v, jnp.asarray(x), method=JaxRQVAE.last_level_distances)),
        rtol=1e-5, atol=1e-6)


def test_rqvae_state_dict_round_trips_through_flax():
    jm, v, tm, _ = _pair(True)
    back = to_flax(dict(tm.state_dict()), v)
    assert set(back) == {"params", "batch_stats"}
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(v)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))


@pytest.mark.parametrize("optim,bn", [("adamw", False), ("sgd", True), ("adamw", True)])
def test_rqvae_train_steps_match_jax(optim, bn):
    """3 steps of the RQVAE task's step (BatchNorm statistics carried,
    diversity and CF losses on), JAX's `train_step` body against
    `tasks/rqvae.train_step` with JAX's Gumbel noise: losses, and every
    parameter and running statistic, at 1e-5. With bn, a Dense bias feeds a
    BatchNorm, whose batch mean removes it: its true gradient is 0, both
    packages' are rounding noise, and AdamW scales that noise to steps of up
    to lr (which the running means then carry); so bn's parameters are held
    under SGD, and under AdamW the losses only (they do not see the bias)."""
    jm, v, tm, _ = _pair(bn, beta=0.01)
    cfg = jm.cfg
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(3, 16, 16)).astype(np.float32)
    cfs = rng.normal(size=(3, 16, 4)).astype(np.float32)
    labels = rng.integers(0, 3, (3, 8))
    opt = dict(optim=optim, learning_rate=1e-3 if optim == "adamw" else 0.05,
               weight_decay=1e-4,
               lr_scheduler_type="constant", warmup_ratio=0.0, max_grad_norm=0.0, total_steps=3)
    tx = jax_make_optimizer(JaxOptimizerConfig(**opt))
    opt_state = tx.init(v)
    optimizer = make_optimizer(OptimizerConfig(**opt), tm)
    for step in range(3):
        drng = jax.random.PRNGKey(10 + step)
        bx, bcf = jnp.asarray(xs[step]), jnp.asarray(cfs[step])

        def loss_fn(var):
            kws = dict(use_sk=True, deterministic=False, diversity_labels=jnp.asarray(labels),
                       diversity_rng=drng)
            if bn:
                out, new = jm.apply(var, bx, mutable=["batch_stats"], **kws)
                loss, aux = jax_rqvae_loss(cfg, out, bx, bcf)
                return loss, new["batch_stats"]
            return jax_rqvae_loss(cfg, jm.apply(var, bx, **kws), bx, bcf)[0], None

        (jl, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(v)
        updates, opt_state = tx.update(grads, opt_state, v)
        v = optax.apply_updates(v, updates)
        if bn:
            v = dict(v, batch_stats=stats)
        tl, _ = train_step(tm, optimizer, torch.tensor(xs[step]), torch.tensor(cfs[step]),
                           torch.tensor(labels), torch.Generator().manual_seed(0),
                           diversity_noise=_noise(drng, 16, [8, 6, 8]))
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = state_dict_from_jax(v)
    got = tm.state_dict()
    assert set(got) == set(want)
    for name, t in want.items() if not (bn and optim == "adamw") else ():
        np.testing.assert_allclose(got[name].numpy(), t.numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_rqvae_hash_dropout_is_seeded():
    """dropout_prob > 0 draws its hash seeds from the generator: the same
    generator seed gives the same output, another seed another."""
    tm = RQVAE(RQVAEConfig(**_cfg(dropout_prob=0.3, beta=0.0)), device="cpu")
    x = torch.tensor(np.random.default_rng(0).normal(size=(16, 16)).astype(np.float32))
    run = lambda s: tm(x, deterministic=False, generator=torch.Generator().manual_seed(s))["out"]
    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="Generator"):
        tm(x, deterministic=False)
