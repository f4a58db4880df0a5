"""Port parity of the enc-dec family (TIGER, PBATransformer) on the CPU: the
port's `EncDecModel`, `encdec_loss_fn`, `prepare_encdec_inputs`,
`EncDecBatcher` and enc-dec beam search against the JAX package's on the
same numpy inputs and, through `convert.py`, the same weights. PBATransformer
runs with `shared_expert` and behavior injection on one encoder and one
decoder layer. fp32; tolerances: logits 1e-5, losses 1e-5 relative, every
grad 1e-4 of its largest entry, beam scores 1e-4; index streams, batches and
beam codes exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gamer_tpu.data.batching import EncDecBatcher as JaxBatcher
from gamer_tpu.data.smb import SMBExample as JaxExample
from gamer_tpu.data.vocab import SemanticVocab as JaxVocab
from gamer_tpu.decode.beam import BeamSearchConfig as JaxBeamConfig
from gamer_tpu.decode.beam import make_beam_search_encdec_fn as jax_search_fn
from gamer_tpu.decode.trie import LeveledTrie as JaxTrie
from gamer_tpu.models.generative import encdec as JE
from gamer_tpu.models.generative import encdec_utils as JU
from gamer_tpu_torch.convert import load_jax_params, state_dict_from_jax, to_flax
from gamer_tpu_torch.data.batching import EncDecBatcher
from gamer_tpu_torch.data.smb import SMBExample
from gamer_tpu_torch.data.vocab import SemanticVocab
from gamer_tpu_torch.decode.beam import BeamSearchConfig, constrained_beam_search_encdec
from gamer_tpu_torch.decode.trie import LeveledTrie
from gamer_tpu_torch.models.generative import encdec as TE
from gamer_tpu_torch.models.generative import encdec_utils as TU
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)

CONFIGS = {
    "TIGER": dict(),
    "PBATransformer": dict(shared_expert=True, behavior_injection_encoder=[0],
                           behavior_injection_decoder=[1]),
}


def tiny_kwargs(backbone: str, **kw) -> dict:
    d = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2, num_decoder_layers=2,
             num_heads=4, dropout_rate=0.0, num_positions=3, num_experts=4, num_behavior=2,
             behavior_base=14, behavior_embedding_dim=8, **CONFIGS[backbone])
    d.update(kw)
    return d


def make_batch(cfg, B=3, Se=12, Sd=4, seed=0) -> dict:
    """Encoder item blocks [<behavior>, codes] (behavior tokens 14 and 15),
    right padding on row 0, labels ending in EOS, -100 on row 1's last."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(16, cfg.vocab_size, (B, Se)).astype(np.int32)
    ids[:, ::cfg.num_positions] = rng.integers(14, 14 + cfg.num_behavior,
                                               (B, -(-Se // cfg.num_positions)))
    attn = np.ones((B, Se), np.int32)
    attn[0, -4:] = 0
    ids[0, -4:] = 0
    ids[0, -5] = 1  # EOS
    labels = rng.integers(16, cfg.vocab_size, (B, Sd)).astype(np.int32)
    labels[:, -1] = 1
    labels[1, -1] = -100
    return {"input_ids": ids, "attention_mask": attn, "labels": labels,
            "row_valid": np.array([1] * (B - 1) + [0], np.int32)}


def jax_and_port(backbone: str, batch: dict, seed: int = 0, **kw):
    """(JAX model, its params, port model): the port's weights from `seed`
    (the HF T5 init), carried into the flax tree of the JAX model's
    parameter shapes by `convert.to_flax`."""
    jcfg = JE.build_encdec_config(backbone, **tiny_kwargs(backbone, **kw))
    jmodel = JE.EncDecModel(jcfg)
    inputs = JU.prepare_encdec_inputs(jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    shapes = jax.eval_shape(lambda key, inputs: jmodel.init(key, **inputs),
                            jax.random.PRNGKey(0), inputs)
    tcfg = TE.build_encdec_config(backbone, **tiny_kwargs(backbone, **kw))
    tmodel = TE.EncDecModel(tcfg, device="cpu", seed=seed)
    return jmodel, to_flax(tmodel.state_dict(), shapes), tmodel


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_rel_bucket_and_shift_right_match_jax():
    rel = np.arange(-400, 401, dtype=np.int32)[:, None] - np.arange(0, 7, dtype=np.int32)[None]
    for bidirectional in (True, False):
        for buckets, dist in ((32, 128), (16, 40)):
            want = JE.rel_bucket(jnp.asarray(rel), bidirectional, buckets, dist)
            got = TE.rel_bucket(torch.as_tensor(rel), bidirectional, buckets, dist)
            assert np.array_equal(got.numpy(), np.asarray(want))
    labels = np.array([[5, 6, -100], [7, 8, 9]], np.int32)
    want = JE.shift_right(jnp.asarray(labels), start_token=0, pad_id=0)
    got = TE.shift_right(torch.as_tensor(labels), start_token=0, pad_id=0)
    assert np.array_equal(got.numpy(), np.asarray(want)) and got.tolist() == [[0, 5, 6],
                                                                             [0, 7, 8]]


def test_prepare_inputs_and_collate_match_jax():
    cfg = TE.build_encdec_config("PBATransformer", **tiny_kwargs("PBATransformer"))
    batch = make_batch(cfg)
    want = JU.prepare_encdec_inputs(cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got = TU.prepare_encdec_inputs(cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert got["enc_behavior_index"].max() > 0  # behavior injection sees behaviors

    rng = np.random.default_rng(5)
    fields = lambda i: dict(prompt=rng.integers(14, 60, 3 * (i % 4)).astype(np.int32),
                            targets=rng.integers(16, 60, (1, 3)).astype(np.int32),
                            target_behaviors=np.array([i % 2]), session_ids=np.zeros(0, np.int32),
                            extended_session_ids=np.zeros(0, np.int32),
                            actions=np.zeros(0, np.int32), time=np.zeros(0, np.float32),
                            history_item_ids=np.zeros(0, np.int64), split="train")
    exs = [fields(i) for i in range(6)]
    jb = JaxBatcher.for_examples([JaxExample(**e) for e in exs], eos_id=1)
    tb = EncDecBatcher.for_examples([SMBExample(**e) for e in exs], eos_id=1)
    assert (tb.enc_len, tb.dec_len) == (jb.enc_len, jb.dec_len)
    want = jb.collate([JaxExample(**e) for e in exs])
    got = tb.collate([SMBExample(**e) for e in exs])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("backbone", list(CONFIGS))
def test_logits_loss_and_grads_match_jax(backbone):
    """Deterministic logits and eval loss (also of an untied head); the
    training loss (dropout 0) and every grad against JAX's
    `deterministic=False` step."""
    for untied in (False, True) if backbone == "TIGER" else (False,):
        kw = dict(temperature=0.7, tie_word_embeddings=not untied)
        batch = make_batch(TE.EncDecConfig(**{k: v for k, v in tiny_kwargs(backbone).items()}))
        jmodel, params, tmodel = jax_and_port(backbone, batch, **kw)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        want = jmodel.apply(params, **JU.prepare_encdec_inputs(jmodel.cfg, jb))["logits"]
        with torch.no_grad():
            got = tmodel(**TU.prepare_encdec_inputs(
                tmodel.cfg, {k: torch.as_tensor(v) for k, v in batch.items()}))["logits"]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

        want_eval, want_aux = JU.encdec_loss_fn(jmodel, jmodel.cfg, deterministic=True)(
            params, jb, None)
        got_eval, aux = TU.encdec_loss_fn(tmodel, deterministic=True)(batch)
        assert not got_eval.requires_grad
        assert abs(float(got_eval) / float(want_eval) - 1) <= 1e-5
        assert int(aux["denom"]) == int(want_aux["denom"]) == 7
        if untied:
            continue

        jloss = JU.encdec_loss_fn(jmodel, jmodel.cfg, deterministic=False)
        (want_loss, _), want_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
            params, jb, jax.random.PRNGKey(3))
        loss, _ = TU.encdec_loss_fn(tmodel)(batch, torch.Generator().manual_seed(3))
        loss.backward()
        loss = float(loss.detach())
        assert abs(loss / float(want_loss) - 1) <= 1e-5
        assert loss == float(got_eval)  # dropout 0: the training step is the eval loss
        grads = to_flax({n: p.grad for n, p in tmodel.named_parameters()}, want_grads)
        flat_g = jax.tree_util.tree_leaves_with_path(grads)
        flat_w = dict(jax.tree_util.tree_leaves_with_path(jax.device_get(want_grads)))
        assert len(flat_g) == len(flat_w) == sum(1 for _ in tmodel.parameters())
        for path, g in flat_g:
            w = flat_w[path]
            if "decoder_0/self_attn']['rel_bias" in jax.tree_util.keystr(path):
                # the decoder's bias puts every visible key in bucket 0
                # (test_decoder_bias_is_one_bucket_as_in_jax): both grads vanish
                assert np.abs(w).max() < 1e-6 and np.abs(g).max() < 1e-6
                continue
            assert _rel(g, w) <= 1e-4, (jax.tree_util.keystr(path), _rel(g, w))


@pytest.mark.parametrize("backbone,per_row", [("TIGER", True), ("PBATransformer", False)])
def test_beam_codes_match_jax(backbone, per_row):
    """The enc-dec search on the same weights: equal codes, scores within
    1e-4; per-row [start, behavior token] prefixes or one shared [start]."""
    levels = [5, 6, 4]
    kw = dict(vocab_size=14 + 2 + sum(levels))
    jvocab, tvocab = JaxVocab(levels, behaviors=["a", "b"]), SemanticVocab(levels,
                                                                          behaviors=["a", "b"])
    assert jvocab.vocab_size == tvocab.vocab_size == kw["vocab_size"]
    cfg = TE.build_encdec_config(backbone, **tiny_kwargs(backbone, **kw))
    batch = make_batch(cfg, B=4, Se=9, seed=2)
    batch["input_ids"] = np.minimum(batch["input_ids"], kw["vocab_size"] - 1)
    jmodel, params, tmodel = jax_and_port(backbone, batch, **kw)
    codes = np.unique(np.random.default_rng(1).integers(0, 4, (40, 3)), axis=0)
    jtrie = JaxTrie.from_token_rows(jvocab.encode_codes(codes), jvocab)
    ttrie = LeveledTrie.from_token_rows(tvocab.encode_codes(codes), tvocab)
    if per_row:
        prefix = np.stack([np.zeros(4, np.int32), np.array([14, 15, 15, 14], np.int32)], axis=1)
    else:
        prefix = np.array([0], np.int32)
    enc = {k: batch[k] for k in ("input_ids", "attention_mask")}
    for K in ((6,) if per_row else (len(codes) + 3,)):  # pruned beams; dead beams
        want_codes, want_scores = jax_search_fn(
            jmodel, jtrie, prefix.shape[-1], JaxBeamConfig(num_beams=K, cache_dtype="float32"))(
            params, {k: jnp.asarray(v) for k, v in enc.items()}, prefix)
        got_codes, got_scores = constrained_beam_search_encdec(
            tmodel, enc, ttrie, prefix, BeamSearchConfig(num_beams=K, cache_dtype="float32"))
        assert got_codes.shape == (4, K, 3) and got_scores.dtype == torch.float32
        live = np.asarray(want_scores) > -1e29
        assert np.array_equal(got_codes.numpy()[live], np.asarray(want_codes)[live])
        np.testing.assert_allclose(got_scores.numpy()[live], np.asarray(want_scores)[live],
                                   rtol=1e-4, atol=1e-4)
        assert (got_scores.numpy()[~live] < -1e29).all()


def test_decoder_bias_is_one_bucket_as_in_jax():
    """A fault of the reference, kept for parity (ROADMAP section 3): JAX's
    decoder passes query - key to `rel_bucket`, which negates it and clips
    it at 0 for the causal stack, so every key a decoder query may see falls
    in bucket 0 and the decoder's relative bias carries no position (HF T5
    buckets max(query - key, 0)). The encoder's bidirectional buckets are
    mirrored, not lost."""
    q = np.arange(6)
    rel = q[:, None] - q[None, :]
    visible = rel >= 0
    for rel_bucket, arr in ((JE.rel_bucket, jnp.asarray), (TE.rel_bucket, torch.as_tensor)):
        dec = np.asarray(rel_bucket(arr(rel), False, 32, 128))
        assert (dec[visible] == 0).all()
        enc = np.asarray(rel_bucket(arr(rel), True, 32, 128))
        assert len(np.unique(enc)) == 11  # 0..5 one way, 16 + 1..5 the other


def test_convert_round_trip():
    """Every enc-dec parameter crosses both ways, untied lm_head included:
    random arrays in the flax tree load into the port (strict) and come back
    from `to_flax` unchanged."""
    batch = make_batch(TE.EncDecConfig(**tiny_kwargs("PBATransformer")))
    rng = np.random.default_rng(0)
    for backbone, kw in (("PBATransformer", {}), ("TIGER", dict(tie_word_embeddings=False))):
        _, shapes, tmodel = jax_and_port(backbone, batch, **kw)
        params = jax.tree_util.tree_map(
            lambda t: rng.standard_normal(t.shape).astype(np.float32), shapes)
        load_jax_params(tmodel, params)
        back = to_flax(tmodel.state_dict(), params)
        flat = dict(jax.tree_util.tree_leaves_with_path(back))
        for path, w in jax.tree_util.tree_leaves_with_path(params):
            assert flat[path].shape == w.shape and np.array_equal(flat[path], w), path
        assert sorted(state_dict_from_jax(params)) == sorted(tmodel.state_dict())
    names = set(tmodel.state_dict())
    for name in ("shared.weight", "lm_head.weight", "encoder_0.self_attn.rel_bias.weight",
                 "decoder_0.self_attn.rel_bias.weight", "decoder_1.ln3.weight",
                 "encoder_norm.weight", "decoder_norm.weight"):
        assert name in names, name
    assert "decoder_1.self_attn.rel_bias.weight" not in names
    assert "['params']['encoder_0/self_attn']['q']['kernel']" in {
        jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(back)}
    pba = TE.EncDecModel(TE.build_encdec_config("PBATransformer",
                                                **tiny_kwargs("PBATransformer")), device="cpu")
    assert {"encoder_0.mlp.shared_wi", "encoder_0.mlp.behavior_embedding.weight",
            "decoder_1.mlp.experts_wo"} <= set(pba.state_dict())
    assert pba.encoder_0.mlp.experts_wo.shape == (4, 48, 16)  # routed half of d_model


def test_t5_init_keeps_attention_unsaturated():
    """The HF T5 init (analog of tests/test_encdec.py's test of the same
    name): q ~ N(0, (d_model d_kv)^-1/2), k ~ N(0, d_model^-1/2), o ~ N(0,
    (H d_kv)^-1/2), shared embedding N(0, 1), each within 15%; the same
    weights from the same seed."""
    cfg = TE.build_encdec_config("TIGER", **tiny_kwargs("TIGER", d_model=64, d_kv=16))
    model = TE.EncDecModel(cfg, device="cpu", seed=0)
    std = lambda t: float(t.detach().std())
    assert abs(std(model.encoder_0.self_attn.q.weight) / (64 * 16) ** -0.5 - 1) < 0.15
    assert abs(std(model.encoder_0.self_attn.k.weight) / 64 ** -0.5 - 1) < 0.15
    assert abs(std(model.decoder_0.cross_attn.o.weight) / (4 * 16) ** -0.5 - 1) < 0.15
    assert abs(std(model.shared.weight) - 1.0) < 0.15
    again = TE.EncDecModel(cfg, device="cpu", seed=0)
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


def test_dropout_is_seeded():
    """The training forward's hash dropout: the same generator seed gives the
    same loss and grads, another seed another loss, and the eval loss none."""
    cfg = TE.build_encdec_config("PBATransformer",
                                 **tiny_kwargs("PBATransformer", dropout_rate=0.2))
    model = TE.EncDecModel(cfg, device="cpu", seed=1)
    batch = make_batch(cfg)
    loss_fn = TU.encdec_loss_fn(model)

    def run(seed):
        model.zero_grad(set_to_none=True)
        loss, _ = loss_fn(batch, torch.Generator().manual_seed(seed))
        loss.backward()
        return float(loss.detach()), [p.grad.clone() for p in model.parameters()]

    (a, ga), (b, gb), (c, _) = run(4), run(4), run(5)
    assert a == b and all(torch.equal(x, y) for x, y in zip(ga, gb))
    assert a != c
    assert float(TU.encdec_loss_fn(model, deterministic=True)(batch)[0]) not in (a, c)
    with pytest.raises(ValueError, match="Generator"):
        loss_fn(batch)
