"""Port parity: trie-constrained beam search (gamer_tpu_torch.decode.beam) on
the CPU against the JAX package's `constrained_beam_search`, on the same
weights, batch (left-padded prompts) and behavior ids, fp32 caches.

Codes must be equal on live beams and scores agree within 1e-4 (1e-5 for the
behavior-token and MoeAction cases). Beams with score <= NEG/2 are dead (more
beams than trie paths); their codes are not compared, because top-k breaks
ties between equal dead scores differently.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gamer_tpu.decode import beam as JB
from gamer_tpu.decode.trie import LeveledTrie as JaxTrie
from gamer_tpu_torch.decode import beam as TB
from gamer_tpu_torch.decode.trie import LeveledTrie
from tests.test_torch_qwen_family import jax_and_port, tiny_kwargs

LEVELS, SIZE = 3, 8
CODE_BASE = 17  # 14 special tokens + 3 behavior tokens


def _prompts(n_items: int, B: int = 3, seed: int = 0, trailing_behavior: bool = True):
    """Left-padded prompts of whole item blocks, ending in the target
    behavior token unless `trailing_behavior` is False (the prompts of the
    behavior-token decode)."""
    rng = np.random.default_rng(seed)
    codes = np.unique(rng.integers(0, SIZE, (n_items, LEVELS)), axis=0)
    bases = [CODE_BASE + SIZE * lvl for lvl in range(LEVELS)]
    P = LEVELS + 1
    S = 3 * P + 1
    ids = np.zeros((B, S), np.int32)
    attn = np.zeros((B, S), np.int32)
    actions = np.zeros((B, S), np.int32)
    for b, blocks in enumerate([3, 1, 2][:B]):
        behs = rng.integers(0, 3, blocks + 1)
        toks = []
        for i in range(blocks):
            toks += [14 + behs[i], *(codes[rng.integers(0, len(codes))] + bases)]
        if trailing_behavior:
            toks.append(14 + behs[-1])
        ids[b, S - len(toks):] = toks
        attn[b, S - len(toks):] = 1
        actions[b, S - len(toks):] = np.repeat(behs + 1, P)[:len(toks)]
    batch = dict(input_ids=ids, attention_mask=attn, actions=actions,
                 session_ids=np.where(attn == 1, np.arange(S) // (2 * P), 0).astype(np.int32),
                 extended_session_ids=np.maximum(np.cumsum(attn, 1) - 1, 0).astype(np.int32),
                 prompt_len=attn.sum(1).astype(np.int32), labels=ids.copy())
    return codes, bases, batch


def test_trie_tables_match_jax():
    codes, bases, _ = _prompts(40)
    want = JaxTrie.build(codes, [SIZE] * LEVELS, bases)
    got = LeveledTrie.build(codes, [SIZE] * LEVELS, bases)
    for a, b in zip(want.allowed + want.child + [want.leaf_candidate],
                    got.allowed + got.child + [got.leaf_candidate]):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("n_items,num_beams", [(10, 12), (40, 6)])
@pytest.mark.parametrize("per_example", [False, True])
@pytest.mark.parametrize("backbone", ["Qwen3Multi", "Qwen3SessionMulti", "Qwen3MoeAction"])
def test_beam_search_matches_jax(backbone, per_example, n_items, num_beams):
    codes, bases, batch = _prompts(n_items)
    kw = tiny_kwargs(vocab_size=CODE_BASE + LEVELS * SIZE, num_positions=LEVELS + 1,
                     num_experts=LEVELS + 2)
    jmodel, params, tmodel = jax_and_port(backbone, batch, route_mode="onehot", **kw)
    behavior = np.array([3, 1, 2], np.int32) if per_example else 2
    prompt = {k: v for k, v in batch.items() if k != "labels"}

    want_codes, want_scores = JB.constrained_beam_search(
        jmodel, params, {k: jnp.asarray(v) for k, v in prompt.items()},
        JaxTrie.build(codes, [SIZE] * LEVELS, bases),
        jnp.asarray(behavior) if per_example else behavior,
        JB.BeamSearchConfig(num_beams=num_beams, cache_dtype="float32"))
    got_codes, got_scores = TB.make_beam_search_fn(
        tmodel, LeveledTrie.build(codes, [SIZE] * LEVELS, bases),
        TB.BeamSearchConfig(num_beams=num_beams))(prompt, behavior)

    want_codes, want_scores = np.asarray(want_codes), np.asarray(want_scores)
    got_codes, got_scores = got_codes.numpy(), got_scores.numpy()
    assert got_codes.shape == want_codes.shape == (3, num_beams, LEVELS)
    tol = 1e-5 if backbone == "Qwen3MoeAction" else 1e-4
    np.testing.assert_allclose(got_scores, want_scores, rtol=tol, atol=tol)
    live = want_scores > TB.NEG / 2
    assert live.any() and (live == (got_scores > TB.NEG / 2)).all()
    if n_items < num_beams:
        assert not live.all(), "this case must exercise dead beams"
    np.testing.assert_array_equal(got_codes[live], want_codes[live])


@pytest.mark.parametrize("backbone", ["Qwen3Multi", "Qwen3MoeAction"])
def test_behavior_token_decode_matches_jax(backbone):
    """`behavior_emb_id=None` (test_MB_decoder's BEHAVIOR_ITEM mode): level 0
    of the combined behavior + item trie is the behavior token (3 codes at
    the behavior base), each beam's behavior id is its level-0 code + 1 and
    follows its parent; prompts end at a block boundary. Codes equal, scores
    within 1e-5."""
    codes, bases, batch = _prompts(12, trailing_behavior=False)
    n_beh = 3
    combined = np.concatenate([np.repeat(np.arange(n_beh), len(codes))[:, None],
                               np.tile(codes, (n_beh, 1))], axis=1)
    sizes, tbases = [n_beh] + [SIZE] * LEVELS, [14] + bases
    kw = tiny_kwargs(vocab_size=CODE_BASE + LEVELS * SIZE, num_positions=LEVELS + 1,
                     num_experts=LEVELS + 2)
    jmodel, params, tmodel = jax_and_port(backbone, batch, route_mode="onehot", **kw)
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    want_codes, want_scores = JB.constrained_beam_search(
        jmodel, params, {k: jnp.asarray(v) for k, v in prompt.items()},
        JaxTrie.build(combined, sizes, tbases), None,
        JB.BeamSearchConfig(num_beams=8, cache_dtype="float32"))
    got_codes, got_scores = TB.make_beam_search_fn(
        tmodel, LeveledTrie.build(combined, sizes, tbases),
        TB.BeamSearchConfig(num_beams=8))(prompt, None)
    want_codes, want_scores = np.asarray(want_codes), np.asarray(want_scores)
    got_codes, got_scores = got_codes.numpy(), got_scores.numpy()
    assert got_codes.shape == want_codes.shape == (3, 8, LEVELS + 1)
    assert (want_scores > TB.NEG / 2).all() and len(set(want_codes[..., 0].ravel())) > 1
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_codes, want_codes)
