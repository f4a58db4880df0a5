"""The port's discriminative zoo (`gamer_tpu_torch/models/discriminative`)
against the JAX package's on the same weights (`convert.py`): scores,
losses and grads of SASRec, GRU4Rec, BERT4Rec, MBSTR, MBHT and PBAT and
their flag variants at `tests/test_discriminative.py`'s tiny sizes, JAX's
masked-LM draws handed over; the flax trees' round trip and decay mask;
MBHT's incidence matrix; PBAT's Gaussian ops at covariance underflow and
its head's matmul form against the broadcast form.

JAX's init runs only as `jax.eval_shape` (its tree and shapes) and the
rest jitted: op by op, each JAX primitive compiles on first use, which
costs more than one compile of the whole function.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gamer_tpu.data.contract import DataFiles
from gamer_tpu.data.smb import SMBCorpus
from gamer_tpu.data.smb_dis import DisBatcher, SMBDisBuilder
from gamer_tpu.models.discriminative import DisModelConfig as JaxCfg
from gamer_tpu.tasks import train_smb_rec as JT
from gamer_tpu_torch.convert import flax_path, state_dict_from_jax, to_flax
from gamer_tpu_torch.models.discriminative import DisModelConfig
from gamer_tpu_torch.tasks import train_smb_rec as PT
from gamer_tpu_torch.train.state import decay_mask

B, N_USERS = 4, 24
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4  # relative; grads against each leaf's largest
TINY = dict(n_layers=1, n_heads=2, hidden_size=16, inner_size=32, dropout_prob=0.0,
            embedding_size=16, n_behaviors=3, scales=[4, 3, 9], hyper_len=3,
            num_buckets=8, max_distance=10)
MASKED = ("BERT4Rec", "MBSTR", "PBAT", "MBHT")

# (backbone, config overrides): every backbone, then the flag variants
CASES = [("SASRec", {}), ("GRU4Rec", {}), ("BERT4Rec", {}), ("MBSTR", {}), ("PBAT", {}),
         ("MBHT", {}), ("SASRec", {"loss_type": "BPR"}), ("GRU4Rec", {"loss_type": "BPR"}),
         ("GRU4Rec", {"n_layers": 2, "hidden_size": 24}),
         ("MBHT", {"enable_hg": False}), ("MBHT", {"enable_ms": False}),
         ("MBSTR", {"behavior_attention": False}), ("MBSTR", {"behavior_moe": False}),
         ("MBSTR", {"behavior_head": False}), ("MBSTR", {"behavior_position_bias": False})]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(synth_dir):
    corpus = SMBCorpus(DataFiles(synth_dir, "Synth"))
    return corpus, SMBDisBuilder(corpus, max_his_len=8)


def _batches(builder, backbone, loss_type):
    L = 9 if backbone == "MBHT" else 8
    train = builder.build_train("neg" if loss_type == "BPR" else "base")
    ev = builder.build_eval("test", append_mask_slot=backbone in MASKED)
    train_b = DisBatcher.for_examples(train, seq_len=L).collate(train[:B])
    eval_b = DisBatcher.for_examples(ev, seq_len=L).collate(ev[:B])
    train_b["row_valid"][-1] = 0  # one batch-padding row
    return L, train_b, eval_b


def _jax_init(model, backbone, batch, rng):
    M = type(model)
    rngs = {"params": rng, "dropout": jax.random.fold_in(rng, 1)}
    if backbone in ("SASRec", "GRU4Rec"):
        return model.init(rngs, batch["inputs"], batch["seq_len"], None, False,
                          method=M.encode_with_table)
    if backbone == "BERT4Rec":
        return model.init(rngs, batch["inputs"], batch["seq_len"], rng, None,
                          method=M.calculate_loss)
    if backbone == "MBSTR":
        return model.init(rngs, batch["inputs"], batch["behaviors"], rng, None,
                          method=M.calculate_loss)
    if backbone == "PBAT":
        return model.init(rngs, batch["inputs"], batch["behaviors"], batch["uid"], rng, None,
                          method=M.calculate_loss)
    return model.init(rngs, batch["inputs"], batch["behaviors"], batch["target"],
                      batch["behavior"] + 1, batch["seq_len"], rng, None,
                      method=M.calculate_loss)


def jax_uniforms(backbone, rng, shape):
    """The masked-LM draws JAX's `calculate_loss` makes from `rng`."""
    if backbone == "BERT4Rec":
        r_batch, r_mask = jax.random.split(rng)
        return (np.asarray(jax.random.uniform(r_batch, (shape[0], 1))),
                np.asarray(jax.random.uniform(r_mask, shape)))
    if backbone in MASKED:
        return np.asarray(jax.random.uniform(rng, shape))
    return None


def build_pair(builder, backbone, overrides, n_users=N_USERS):
    """(JAX model, its variables, the port model on the same weights, L,
    train batch, eval batch). The weights are the port's init plus seeded
    noise (so no grad sits at an init value), carried into the flax tree
    whose structure and shapes `jax.eval_shape` of JAX's init gives."""
    kw = {**TINY, **overrides}
    L, train_b, eval_b = _batches(builder, backbone, kw.get("loss_type", "CE"))
    jm = JT.build_dis_model(backbone, JaxCfg(**kw), builder.num_items, L, 3, n_users)
    template = jax.eval_shape(lambda: _jax_init(
        jm, backbone, {k: jnp.asarray(a) for k, a in train_b.items()}, jax.random.PRNGKey(0)))
    pm = PT.build_dis_model(backbone, DisModelConfig(**kw), builder.num_items, L, 3, n_users,
                            device="cpu", seed=1)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in pm.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    v = to_flax(pm.state_dict(), template)
    for (path, t), (_, a) in zip(jax.tree_util.tree_leaves_with_path(template),
                                 jax.tree_util.tree_leaves_with_path(v)):
        assert a.shape == t.shape, (backbone, jax.tree_util.keystr(path), a.shape, t.shape)
    return jm, jax.tree_util.tree_map(jnp.asarray, v), pm, L, train_b, eval_b


def _case_id(case):
    backbone, over = case
    return backbone + "".join(f"-{k}={v}" for k, v in over.items())


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _jax_scores(jm, backbone, v, jb):
    M = type(jm)
    if backbone in ("SASRec", "GRU4Rec"):
        seq_out, table = jm.apply(v, jb["inputs"], jb["seq_len"], None, True,
                                  method=M.encode_with_table)
        return seq_out @ table.T
    if backbone == "BERT4Rec":
        return jm.apply(v, jb["inputs"], jb["seq_len"], method=M.predict_scores)
    if backbone == "PBAT":
        return jm.apply(v, jb["inputs"], jb["behaviors"], jb["uid"], jb["seq_len"],
                        method=M.predict_scores)
    return jm.apply(v, jb["inputs"], jb["behaviors"], jb["seq_len"], method=M.predict_scores)


class _NoDropout:
    """flax.linen with every `nn.Dropout` at rate 0: MBHT's hypergraph
    branch drops at a fixed 0.2 whatever `dropout_prob` is, and JAX draws
    those masks from its rng stream, which torch cannot reproduce."""

    def __getattr__(self, name):
        import flax.linen as nn

        if name == "Dropout":
            return lambda rate, deterministic=None: nn.Dropout(0.0, deterministic=deterministic)
        return getattr(nn, name)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_scores_loss_and_grads_match_jax(data, case, monkeypatch):
    """Full-sort scores and the training loss at 1e-5 relative, every grad
    at 1e-4 of its largest entry, dropout 0 (JAX's masked-LM draws handed
    over)."""
    from gamer_tpu.models.discriminative import mbht as JM
    from gamer_tpu_torch.models.discriminative import mbht as PM

    monkeypatch.setattr(JM, "nn", _NoDropout())
    monkeypatch.setattr(PM, "HG_DROPOUT", 0.0)
    _, builder = data
    backbone, over = case
    jm, v, pm, L, train_b, eval_b = build_pair(builder, backbone, over)
    cfg = {**TINY, **over}

    jb = {k: jnp.asarray(a) for k, a in eval_b.items()}
    want = np.asarray(jax.jit(lambda p, b: _jax_scores(jm, backbone, p, b))(v, jb))
    got = PT.make_score_fn(backbone, pm)({k: torch.as_tensor(a) for k, a in eval_b.items()})
    assert got.shape == (B, builder.num_items + 1)
    assert _rel(got.numpy(), want) <= LOSS_TOL, backbone

    rng = jax.random.PRNGKey(5)
    loss_fn = JT.make_dis_loss_fn(backbone, jm, JaxCfg(**cfg))
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: loss_fn(p, b, rng)[0]))(
        v, {k: jnp.asarray(a) for k, a in train_b.items()})
    uniforms = jax_uniforms(backbone, rng, train_b["inputs"].shape)
    if uniforms is not None:
        uniforms = (tuple(torch.as_tensor(u) for u in uniforms) if isinstance(uniforms, tuple)
                    else torch.as_tensor(uniforms))
    ploss = PT.make_dis_loss_fn(backbone, pm, DisModelConfig(**cfg))(
        {k: torch.as_tensor(a) for k, a in train_b.items()}, torch.Generator().manual_seed(0),
        uniforms)
    ploss.backward()
    ploss = float(ploss.detach())
    assert np.isfinite(float(jloss))
    assert abs(ploss - float(jloss)) <= LOSS_TOL * abs(float(jloss)), (ploss, float(jloss))
    grads = to_flax({n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in pm.named_parameters()}, v)
    flat_j = jax.tree_util.tree_leaves_with_path(jgrads)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert len(flat_j) == len(flat_p) == len(list(pm.parameters()))
    # a leaf whose grad vanishes analytically (the attention's key bias:
    # softmax ignores a shift common to all keys) holds float noise in both
    floor = 1e-6 * max(float(np.max(np.abs(np.asarray(g)))) for _, g in flat_j)
    for path, gj in flat_j:
        gj, gp = np.asarray(gj), np.asarray(flat_p[path])
        scale = float(np.max(np.abs(gj)))
        if scale < floor:
            assert float(np.max(np.abs(gp))) < floor, (backbone, jax.tree_util.keystr(path))
            continue
        assert float(np.max(np.abs(gp - gj))) <= GRAD_TOL * scale, (
            backbone, jax.tree_util.keystr(path), float(np.max(np.abs(gp - gj))) / scale)


@pytest.mark.parametrize("backbone", ["SASRec", "GRU4Rec", "BERT4Rec", "MBSTR", "PBAT", "MBHT"])
def test_flax_tree_round_trip_and_decay_names(data, backbone):
    """The port's parameters carry into JAX's init tree (same paths and
    shapes, `build_pair`) and back bit for bit; `flax_path` names each as
    flax does, so the decay mask is JAX's."""
    _, builder = data
    _, v, pm, *_ = build_pair(builder, backbone, {})
    state = state_dict_from_jax(v)
    assert sorted(state) == sorted(pm.state_dict())
    for name, t in pm.state_dict().items():
        assert torch.equal(state[name], t), name
    names = {flax_path(pm, n) for n, _ in pm.named_parameters()}
    assert names == {"/".join(str(k.key) for k in p[1:])
                     for p, _ in jax.tree_util.tree_leaves_with_path(v)}
    decay = {flax_path(pm, n): d for n, d in decay_mask(pm).items()}
    # JAX's rule (gamer_tpu/train/state.py:78-85): no decay on */scale, */bias
    assert decay == {p: not p.endswith(("scale", "bias")) for p in names}
    if backbone == "BERT4Rec":
        assert decay["head_bias"] is False
    if backbone == "MBHT":
        assert decay["hypergraph/gating_bias"] is False and decay["hypergraph/hgc1_b"] is True


def test_mbht_incidence_matrix_is_jax_s(data, monkeypatch):
    """The hypergraph's incidence matrix against JAX's (captured from its
    branch): the same edges element for element (the top-k picks with ties
    at exactly 0.01, the self-loops, the same-item edges), the similarity
    weights on them within 1e-6 (fp32 summation order)."""
    from gamer_tpu.models.discriminative import mbht as JM

    _, builder = data
    jm, v, pm, L, _, eval_b = build_pair(builder, "MBHT", {})
    captured = []

    class Shim:
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def einsum(spec, *ops, **kw):
            if spec == "bl,ble,be,bme->blm":
                captured.append(np.asarray(ops[1]))
            return jnp.einsum(spec, *ops, **kw)

    monkeypatch.setattr(JM, "jnp", Shim())
    seq = eval_b["inputs"]
    emb = np.asarray(v["params"]["item_embedding"]["embedding"])[seq]
    JM.HypergraphBranch(jm.cfg, jm.mask_token).apply(
        {"params": v["params"]["hypergraph"]}, jnp.asarray(seq), jnp.asarray(emb),
        jnp.asarray(seq == jm.mask_token), True)
    assert len(captured) == 1
    want = captured[0]
    t = torch.as_tensor(seq)
    got = pm.hypergraph.incidence(t, pm.item_embedding(t.long()))[1].detach().numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    # set by construction: ties at 0.01, self-loops, the same-item half
    exact = ((want == np.float32(0.01)) | np.eye(L, 2 * L, dtype=bool)[None]
             | (np.arange(2 * L) >= L)[None, None])
    np.testing.assert_array_equal(got[exact], want[exact])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want == np.float32(0.01)).sum() > 1  # ties at the floor value occur
    assert want[..., L:].sum() > 0  # and same-item edges


def test_rel_pos_bucket_table_is_jax_s():
    from gamer_tpu.models.discriminative.mbstr import rel_pos_bucket as jax_bucket
    from gamer_tpu_torch.models.discriminative.mbstr import rel_pos_bucket

    for L, nb, md in ((21, 32, 40), (9, 8, 10), (64, 32, 40), (200, 32, 128)):
        np.testing.assert_array_equal(rel_pos_bucket(L, L, nb, md).numpy(),
                                      np.asarray(jax_bucket(L, L, nb, md)))


def test_pbat_gaussian_ops_finite_grads_at_cov_underflow():
    """The port's counterpart of test_discriminative.py's: elu(x)+1
    underflows to exactly 0 in f32; the Gaussian ops keep forward and
    backward finite there (the 1e-6 covariance floor), the head's matmul
    form included."""
    from gamer_tpu_torch.models.discriminative.pbat import (
        sagp, tri_sagp, w2_distance, w2_distance_matrix)

    m = torch.tensor([[1.0, -2.0], [300.0, -300.0]])
    c1 = torch.tensor([[0.5, 2.0], [80.0, 1e-30]])
    losses = {
        "tri": lambda c: (lambda mc: (mc[0] ** 2).sum() + mc[1].sum())(
            tri_sagp(m, 2 * m, -m, c, c1, torch.zeros(2, 2))),
        "sagp": lambda c: (lambda mc: (mc[0] ** 2).sum() + mc[1].sum())(sagp(m, 2 * m, c, c1)),
        "w2": lambda c: w2_distance(m, c, 2 * m, c1).sum(),
        "w2_matrix": lambda c: w2_distance_matrix(m, c, 2 * m, c1).sum(),
    }
    for name, f in losses.items():
        c0 = torch.zeros(2, 2, requires_grad=True)  # exact underflow
        val = f(c0)
        val.backward()
        assert torch.isfinite(val), name
        assert torch.isfinite(c0.grad).all(), name


# the head's matmul form against the broadcast form: its cancellation error
# is a few fp32 ulps of |a|^2 + |b|^2, held to 1e-5 of the largest distance
HEAD_TOL = 1e-5


def test_pbat_head_matmul_form_matches_broadcast_form():
    from gamer_tpu_torch.models.discriminative.pbat import w2_distance, w2_distance_matrix

    g = torch.Generator().manual_seed(0)
    N, V, H = 96, 301, 64
    # the head's inputs: elu outputs (means) and elu+1 tables (covariances)
    hm = torch.nn.functional.elu(torch.randn(N, H, generator=g) * 2)
    hc = torch.nn.functional.elu(torch.randn(N, H, generator=g) * 2)
    em = torch.nn.functional.elu(torch.randn(V, H, generator=g))
    ec = torch.nn.functional.elu(torch.randn(V, H, generator=g)) + 1
    for t in (hm, hc, em, ec):
        t.requires_grad_(True)
    w = torch.randn(N, V, generator=g)
    got = w2_distance_matrix(hm, hc, em, ec)
    want = w2_distance(hm[:, None], hc[:, None], em[None], ec[None])
    assert float((got - want).abs().max()) <= HEAD_TOL * float(want.abs().max())
    g_got = torch.autograd.grad((got * w).sum(), (hm, hc, em, ec))
    g_want = torch.autograd.grad((want * w).sum(), (hm, hc, em, ec))
    for a, b in zip(g_got, g_want):
        assert float((a - b).abs().max()) <= GRAD_TOL * float(b.abs().max())
