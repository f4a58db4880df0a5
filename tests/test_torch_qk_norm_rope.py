"""The attention prologue's q/k RMSNorm and RoPE (`ops/qk_norm_rope.py`):
the plain version against the JAX package's `GQAAttention` chain
(`gamer_tpu/modules/layers.py:215-219`) and its vjp on the CPU; kernels N1
and N2 against the plain version on the card (`gpu`-marked, skipped without
CUDA; run them there with

    python -m pytest --noconftest -m gpu tests/test_torch_qk_norm_rope.py -q

`--noconftest`: the shared conftest imports JAX, which the GPU machine need
not have; the CPU cases import JAX themselves and skip without it).
"""

import numpy as np
import pytest
import torch

from gamer_tpu_torch.core import trace
from gamer_tpu_torch.ops import qk_norm_rope as QN

THETA, EPS = 1e6, 1e-6


def _inputs(B, S, H, Hkv, D, dtype, seed, device="cpu", positions="train"):
    g = torch.Generator().manual_seed(seed)
    q = (2 * torch.randn(B, S, H, D, generator=g) + 0.3).to(device, dtype)
    k = torch.randn(B, S, Hkv, D, generator=g).to(device, dtype)
    wq = (1 + 0.5 * torch.randn(D, generator=g)).to(device)
    wk = (1 + 0.5 * torch.randn(D, generator=g)).to(device)
    if positions == "train":  # the train path's expanded arange
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    elif positions == "session":  # extended_session_ids: nondecreasing, with jumps
        pos = torch.cumsum(torch.randint(0, 3, (B, S), generator=g), 1).to(torch.int32)
    else:  # a decode step [B*K, 1]: each beam's next position
        pos = torch.randint(0, 600, (B, S), generator=g, dtype=torch.int64)
    return q, k, wq, wk, pos.to(device)


# --------------------------------------------------------------------------- CPU: the plain version


def _jax_chain(q, k, wq, wk, pos):
    """The JAX package's q_norm, k_norm, rope_cos_sin and apply_rope."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from gamer_tpu.modules import layers as JL

    dt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    as_j = lambda t: jnp.asarray(t.float().numpy()).astype(dt)
    jpos = jnp.asarray(pos.numpy())

    def chain(q, k, wq, wk):
        qn = JL.RMSNorm(EPS).apply({"params": {"scale": wq}}, q)
        kn = JL.RMSNorm(EPS).apply({"params": {"scale": wk}}, k)
        cos, sin = JL.rope_cos_sin(jpos, q.shape[-1], THETA)
        return JL.apply_rope(qn, cos, sin), JL.apply_rope(kn, cos, sin)

    return jax, chain, (as_j(q), as_j(k), jnp.asarray(wq.numpy()), jnp.asarray(wk.numpy()))


def _np(t):
    return np.asarray(t, dtype=np.float32) if not isinstance(t, torch.Tensor) else \
        t.detach().float().numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("positions,shape", [("train", (2, 13, 4, 2)), ("session", (3, 9, 6, 3)),
                                             ("decode", (10, 1, 4, 2))])
def test_plain_matches_jax(dtype, D, positions, shape):
    """The CPU route and the plain version in the kernels' summation order:
    fp32 within 1e-5; bf16 within two roundings of bf16 (the variance's
    summation order may move the bf16 rstd by one unit)."""
    q, k, wq, wk, pos = _inputs(*shape, D, dtype, D + len(positions), positions=positions)
    _, chain, jargs = _jax_chain(q, k, wq, wk, pos)
    want = chain(*jargs)
    got = QN.qk_norm_rope(q, k, wq, wk, pos, THETA, EPS)
    fixed = QN.qk_norm_rope_plain(q, k, wq, wk, pos, THETA, EPS, fixed_order=True)
    for g, w in zip(got + fixed, want + want):
        assert g.dtype == dtype and g.shape == w.shape
        w = _np(w)
        tol = 1e-5 if dtype == torch.float32 else 2 * 2 ** -8 * np.abs(w).max()
        np.testing.assert_allclose(_np(g), w, rtol=1e-5 if dtype == torch.float32 else 0,
                                   atol=tol)


@pytest.mark.parametrize("D", [32, 64, 128])
def test_plain_grads_match_jax_vjp(D):
    """fp32: the grads of q, k and both weights under a random cotangent
    against JAX's vjp of the same chain."""
    q, k, wq, wk, pos = _inputs(2, 11, 4, 2, D, torch.float32, 7 + D, positions="session")
    jax, chain, jargs = _jax_chain(q, k, wq, wk, pos)
    g = torch.Generator().manual_seed(D)
    cq, ck = torch.randn(q.shape, generator=g), torch.randn(k.shape, generator=g)
    _, vjp = jax.vjp(chain, *jargs)
    want = vjp((jax.numpy.asarray(cq.numpy()), jax.numpy.asarray(ck.numpy())))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, wq, wk)]
    oq, ok = QN.qk_norm_rope(*leaves, pos, THETA, EPS)
    torch.autograd.backward((oq, ok), (cq, ck))
    for leaf, w in zip(leaves, want):
        w = _np(w)
        np.testing.assert_allclose(_np(leaf.grad), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_sum_squares_order():
    """The halving tree over the RoPE pairs' sums: exactly the explicit
    order at D 6 (pairs padded from 3 to 4), and the sum within fp32
    rounding at D 200."""
    x = torch.tensor([[1e8, 1.0, 3.0, -1e8, 2.0, 5.0]])
    sq = x.square()
    p = [sq[0, i] + sq[0, i + 3] for i in range(3)] + [torch.tensor(0.0)]
    want = (p[0] + p[2]) + (p[1] + p[3])
    assert torch.equal(QN.sum_squares(x)[0, 0], want)
    y = torch.randn(5, 200, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(QN.sum_squares(y)[:, 0].numpy(),
                               (y.double() ** 2).sum(-1).numpy(), rtol=1e-6)


@pytest.mark.parametrize("D,dtype,want", [
    (64, torch.bfloat16, (8, 1, 4)), (64, torch.float32, (4, 1, 8)),
    (48, torch.bfloat16, (8, 1, 4)), (200, torch.bfloat16, (4, 1, 32)),
    (512, torch.float32, (4, 2, 32)), (2, torch.float32, (1, 1, 1)),
    (50, torch.bfloat16, (1, 1, 32)), (2048, torch.bfloat16, (8, 4, 32)),
    (258, torch.bfloat16, (1, 8, 32)), (1040, torch.float32, (4, 8, 32)),
    (8192, torch.bfloat16, (8, 16, 32))])
def test_geometry(D, dtype, want):
    """(vec, chunks, lanes): the widest vector dividing D/2, the padded pair
    sums spread over lanes, chunks past 32 lanes (past 4 chunks the wide
    kernels take the row)."""
    assert QN.geometry(D, dtype) == want


@pytest.mark.parametrize("case", ["odd_dim", "heads_dim", "batch", "float_positions",
                                  "positions_shape", "dtypes", "weights_bf16", "weights_shape",
                                  "strided", "too_wide", "meta_device"])
def test_bad_inputs_raise(case):
    q, k, wq, wk, pos = _inputs(2, 5, 4, 2, 16, torch.float32, 0)
    if case == "odd_dim":
        q, k, wq, wk = q[..., :15].contiguous(), k[..., :15].contiguous(), wq[:15], wk[:15]
    elif case == "heads_dim":
        k = torch.zeros(2, 5, 2, 8)
    elif case == "batch":
        k = torch.zeros(1, 5, 2, 16)
    elif case == "float_positions":
        pos = pos.float()
    elif case == "positions_shape":
        pos = pos[:, :4]
    elif case == "dtypes":
        k = k.to(torch.bfloat16)
    elif case == "weights_bf16":
        wq = wq.to(torch.bfloat16)
    elif case == "weights_shape":
        wk = wk[:8]
    elif case == "strided":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "too_wide":  # the wide kernels' pair sums and weight grads pass 227 KB
        with pytest.raises(ValueError):
            QN.geometry(32768, torch.bfloat16)
        return
    elif case == "meta_device":
        q, k = q.to("meta"), k.to("meta")
    with pytest.raises((ValueError, TypeError)):
        QN.qk_norm_rope(q, k, wq, wk, pos, THETA, EPS)


def test_cpu_launches_nothing():
    before = (trace.counter("launch.N1"), trace.counter("launch.N2"))
    leaves = [t.requires_grad_(True) for t in _inputs(2, 5, 4, 2, 16, torch.float32, 0)[:4]]
    oq, ok = QN.qk_norm_rope(*leaves, _inputs(2, 5, 4, 2, 16, torch.float32, 0)[4], THETA, EPS)
    (oq.sum() + ok.sum()).backward()
    assert (trace.counter("launch.N1"), trace.counter("launch.N2")) == before


# --------------------------------------------------------------------------- the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and bool((_bits(a) == _bits(b)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [2, 32, 48, 50, 64, 96, 128, 200, 256, 258, 320, 512, 1040])
@pytest.mark.parametrize("positions,shape", [("train", (3, 37, 6, 3)),
                                             ("session", (2, 61, 4, 1)),
                                             ("decode", (40, 1, 6, 3))])
def test_n1_bit_equal_to_plain(dev, dtype, D, positions, shape):
    """N1 against the plain version in the kernels' summation order on the
    card, bit for bit (token counts that leave a warp's last lane groups
    idle; D 258, and 1040 in fp32, take the wide kernels)."""
    q, k, wq, wk, pos = _inputs(*shape, D, dtype, D, dev, positions)
    before = trace.counter("launch.N1")
    got = QN.qk_norm_rope(q, k, wq, wk, pos, THETA, EPS)
    want = QN.qk_norm_rope_plain(q, k, wq, wk, pos, THETA, EPS, fixed_order=True)
    torch.cuda.synchronize()
    assert trace.counter("launch.N1") == before + 1
    for g, w in zip(got, want):
        assert _same(g, w), (g.float() - w.float()).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128, 320, 1040])
def test_n1_rstd_is_the_plain_rstd(dev, D):
    q, k, wq, wk, pos = _inputs(2, 9, 4, 2, D, torch.float32, 3, dev)
    _, _, rq, rk = QN.qk_norm_rope_fwd(q, k, wq, wk, pos.to(torch.int32).contiguous(),
                                       QN.rope_inv_freq(D, THETA, dev), EPS, True)
    for x, r in ((q, rq), (k, rk)):
        assert _same(r, torch.rsqrt(QN.sum_squares(x) * (1.0 / D) + EPS)[..., 0])


def _grads(q, k, wq, wk, pos, cq, ck, fn):
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, wq, wk)]
    oq, ok = fn(*leaves, pos, THETA, EPS)
    torch.autograd.backward((oq, ok), (cq, ck))
    return [t.grad for t in leaves]


@pytest.mark.gpu
@pytest.mark.parametrize("D,shape", [(32, (4, 77)), (64, (4, 77)), (128, (4, 77)),
                                     (200, (4, 77)), (258, (4, 77)), (512, (4, 77)),
                                     (1040, (4, 77)), (64, (256, 520)), (64, (256, 120))])
def test_n2_no_further_from_fp32_than_the_bf16_plain_path(dev, D, shape):
    """bf16: each of N2's grads (pre-norm q, k, both weights) no further
    from the fp32 plain grads on the same values than autograd through the
    bf16 plain version is; fp32: within 1e-5 of them (relative to the
    largest). B 256 x S 520 and x S 120 are the training cells' micro-batches,
    whose warps walk several token groups each."""
    q, k, wq, wk, pos = _inputs(*shape, 6, 3, D, torch.bfloat16, D, dev, "session")
    g = torch.Generator().manual_seed(1)
    cq, ck = (torch.randn(t.shape, generator=g).to(dev, torch.bfloat16) for t in (q, k))
    f32 = lambda *ts: [t.float() for t in ts]
    want = _grads(*f32(q, k), wq, wk, pos, *f32(cq, ck), QN.qk_norm_rope_plain)
    err = lambda got: [((a.float() - b).abs().max() / b.abs().max()).item()
                       for a, b in zip(got, want)]
    before = trace.counter("launch.N2")
    kernel = err(_grads(q, k, wq, wk, pos, cq, ck, QN.qk_norm_rope))
    assert trace.counter("launch.N2") == before + 1
    plain = err(_grads(q, k, wq, wk, pos, cq, ck, QN.qk_norm_rope_plain))
    assert all(a <= b for a, b in zip(kernel, plain)), (kernel, plain)
    fp32 = err(_grads(*f32(q, k), wq, wk, pos, *f32(cq, ck), QN.qk_norm_rope))
    assert max(fp32) <= 1e-5, fp32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_n2_reproduces_bit_for_bit(dev, dtype):
    """Two backward passes give the same bits: the weights' grads are a
    fixed-order sum of per-CTA partials (flagship widths, 64 x 505 tokens)."""
    q, k, wq, wk, pos = _inputs(64, 505, 6, 3, 64, dtype, 5, dev)
    cq, ck = torch.randn_like(q), torch.randn_like(k)
    first = _grads(q, k, wq, wk, pos, cq, ck, QN.qk_norm_rope)
    second = _grads(q, k, wq, wk, pos, cq, ck, QN.qk_norm_rope)
    assert all(_same(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_n1_n2_in_a_cuda_graph(dev, dtype):
    """N1 and N2 captured in a CUDA graph: a replay on new inputs gives the
    eager bits of the rotated q and k and of all four grads."""
    q, k, wq, wk, pos = _inputs(8, 101, 6, 3, 64, dtype, 9, dev)
    cq, ck = torch.randn_like(q), torch.randn_like(k)
    static = [t.clone() for t in (q, k, wq, wk, pos, cq, ck)]

    def step():
        leaves = [t.detach().requires_grad_(True) for t in static[:4]]
        oq, ok = QN.qk_norm_rope(*leaves, static[4], THETA, EPS)
        torch.autograd.backward((oq, ok), (static[5], static[6]))
        return [oq.detach(), ok.detach()] + [t.grad for t in leaves]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()
    fresh = _inputs(8, 101, 6, 3, 64, dtype, 10, dev)
    for s, t in zip(static, fresh + (torch.randn_like(q), torch.randn_like(k))):
        s.copy_(t)
    graph.replay()
    torch.cuda.synchronize()
    want = step()
    assert all(_same(a, b) for a, b in zip(out, want))


def _model_step(cfg, dev, batch):
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    model = QwenFamilyModel(cfg, device=dev, seed=0)
    before = (trace.counter("launch.N1"), trace.counter("launch.N2"))
    loss, _ = make_loss_fn(model, cfg, deterministic=False)(batch, torch.Generator().manual_seed(2))
    loss.backward()
    torch.cuda.synchronize()
    launches = (trace.counter("launch.N1") - before[0], trace.counter("launch.N2") - before[1])
    return loss.detach(), {n: p.grad for n, p in model.named_parameters()}, launches


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["off", "full", "attn", "dots"])
def test_step_launches_and_remat_policies(dev, policy):
    """A flagship Qwen3Multi training step (bf16, dropout 0.2, B 8 x 101
    blocks): N1 and N2 once an attention block (8 self + 4 cross: 12 and
    12); each remat policy runs N1 again in the backward (24 and 12), with
    the loss and every grad bit-identical to remat off's."""
    from gamer_tpu_torch.entry import flagship_config, make_batch

    cfg = flagship_config(dtype="bfloat16", dropout_rate=0.2)
    blocks = cfg.num_hidden_layers + len(cfg.cross_attention_layers)
    batch = make_batch(cfg, 8, 101)
    want, want_grads, launches = _model_step(cfg, dev, batch)
    assert launches == (blocks, blocks) == (12, 12)
    if policy == "off":
        return
    loss, grads, launches = _model_step(cfg.replace(remat=True, remat_policy=policy), dev, batch)
    assert launches == (2 * blocks, blocks)
    assert torch.equal(loss, want)
    for name, g in want_grads.items():
        assert torch.equal(grads[name], g), name


@pytest.mark.gpu
def test_scoring_and_search_launches(dev):
    """A scoring forward launches N1 once an attention block and no N2; an
    eager beam search call once a block for the prefill and for each of its
    L - 1 decode steps (12 x 4 at the flagship's 4 code levels)."""
    import chip_smoke as cs
    from gamer_tpu_torch.decode.beam import BeamSearchConfig, make_beam_search_fn
    from gamer_tpu_torch.models.generative.qwen_family import QwenFamilyModel
    from gamer_tpu_torch.tasks.train_smb_decoder import make_loss_fn

    cfg = cs.flagship_config()
    blocks = cfg.num_hidden_layers + len(cfg.cross_attention_layers)
    model = QwenFamilyModel(cfg, device=dev, seed=0)
    before = (trace.counter("launch.N1"), trace.counter("launch.N2"))
    with torch.no_grad():
        make_loss_fn(model, cfg, deterministic=True)(cs.make_batch(cfg, 4, 20),
                                                     torch.Generator().manual_seed(0))
    assert (trace.counter("launch.N1") - before[0], trace.counter("launch.N2") - before[1]) == (
        blocks, 0)
    trie, pbatch, beh = cs.make_trie_and_prompts(cfg, 4, 64, cs.LEVELS, cs.LEVEL_SIZE, 12)
    search = make_beam_search_fn(model, trie, BeamSearchConfig(num_beams=5), graphed=False)
    before = trace.counter("launch.N1")
    search(pbatch, beh)
    torch.cuda.synchronize()
    assert trace.counter("launch.N1") - before == blocks * cs.LEVELS == 48
