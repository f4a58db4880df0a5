"""The RQ-VAE's reclustering as one device function, on the CPU.

- The k-means++ seeding's uniforms (`ops/kmeans.seeding_uniforms`) against a
  numpy fmix32 of (seed, center, trial): integer hashes, so the CPU and the
  card draw the same uniforms (a candidate can then differ between them
  only where a uniform falls within the rounding of the two devices'
  cumulative sums; `tests/test_torch_kernels_gpu.py` shows that on the
  card).
- `init_centers` and `balanced_kmeans` run with reading a tensor into
  Python and making a tensor from host data patched to raise, from an int
  seed and from a seed in device memory; an int seed, the same seed as a
  one-element int32 tensor and as an `ops/seeds.DeviceSeed` give
  bit-identical centers and labels; `n_init` streams differ.
- `tasks/rqvae.RQVAERecluster`: its device part under the same patch; its
  labels, level by level, bit-identical to `cluster_codebook`'s (the host
  form the JAX task calls), non-uniform levels and a level smaller than
  `n_clusters` included, the rows past a level's codes 0.
- The tokenizer's repair of a prefix holding more items than the last level
  has codes (`tasks/tokenize.Tokenize._reroute_full_prefixes`).

The k-means's JAX parity and quality stay in `tests/test_torch_tokenizer.py`;
the graph itself runs only on the card (`tests/test_torch_kernels_gpu.py -k
recluster`, `chip_smoke.py` phase 12).
"""

import numpy as np
import pytest
import torch

from gamer_tpu_torch.models.tokenizer.rqvae import RQVAE, RQVAEConfig
from gamer_tpu_torch.ops import kmeans as K
from gamer_tpu_torch.ops.seeds import DeviceSeed
from gamer_tpu_torch.tasks import rqvae as RQ
from gamer_tpu_torch.tasks.tokenize import Tokenize, collision_groups
from tests.test_torch_grouped_capture import host_io_forbidden
from tests.test_torch_isolation import _one_torch_thread  # noqa: F401 (autouse fixture)


def _fmix32(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
    return x ^ (x >> np.uint64(15))


@pytest.mark.parametrize("seed,stream", [(0, 0), (7, 3), (2 ** 32 - 5, 1)])
def test_seeding_uniforms_are_the_fmix32_hash(seed, stream):
    k, trials = 9, 4
    rows = np.arange(k, dtype=np.uint64)[:, None]
    cols = np.arange(trials, dtype=np.uint64)[None, :]
    m = np.uint64(0xFFFFFFFF)
    x = (rows * np.uint64(0x9E3779B1) + cols * np.uint64(0x85EBCA6B)
         + np.uint64((stream * 0xC2B2AE35) & 0xFFFFFFFF) + np.uint64(seed & 0xFFFFFFFF)) & m
    want = _fmix32(x).astype(np.float64) / 2 ** 32
    got = K.seeding_uniforms(seed, k, trials, "cpu", stream).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float64 and (got >= 0).all() and (got < 1).all()


def _points(n=96, d=6, k=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 4.0
    return torch.tensor(centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)),
                        dtype=torch.float32)


@pytest.mark.parametrize("seed", [0, 11, 2 ** 31 + 3])
def test_seeding_from_a_device_seed_is_the_int_seeding(seed):
    """An int seed, the same seed as a one-element int32 tensor (its bits)
    and as entry 1 of a `DeviceSeed` table: bit-identical centers, and
    `balanced_kmeans` bit-identical centers and labels, the tensor forms
    run with host reads and host copies forbidden."""
    x = _points(seed=seed % 7)
    bits = np.array([seed], np.uint32).view(np.int32)
    table = torch.tensor(np.array([0, seed, 5], np.uint32).view(np.int32))
    want = K.init_centers(x, 8, seed)
    want_c, want_l = K.balanced_kmeans(x, 8, iters=4, seed=seed, sk_iters=20)
    seed_t = torch.tensor(bits)
    with host_io_forbidden():
        for dev_seed in (seed_t, seed_t.reshape(()), DeviceSeed(table, 1)):
            got = K.init_centers(x, 8, dev_seed)
            c, lab = K.balanced_kmeans(x, 8, iters=4, seed=dev_seed, sk_iters=20)
            assert torch.equal(got, want) and torch.equal(c, want_c) and torch.equal(lab, want_l)
    assert len(torch.unique(want, dim=0)) == 8
    assert not torch.equal(K.init_centers(x, 8, seed, stream=1), want)  # n_init's streams


def _rqvae(levels=(12, 6, 10), n_clusters=8, seed=0):
    cfg = RQVAEConfig(in_dim=16, num_emb_list=list(levels), e_dim=4, layers=[32, 8],
                      beta=0.1, n_clusters=n_clusters, sk_epsilons=[0.0] * (len(levels) - 1)
                      + [0.003])
    return RQVAE(cfg, device="cpu", seed=seed)


@pytest.mark.parametrize("graphed", [True, False])
def test_recluster_labels_equal_cluster_codebook(graphed):
    """Two reclusterings (epochs 0 and 3, seed 5) of levels of 12, 6 and 10
    codes into min(8, codes) clusters: the staged labels bit-identical to
    `cluster_codebook(level's codes, clusters, 5 + epoch + level)`, level by
    level, the padding rows 0; the device part under `host_io_forbidden`."""
    model = _rqvae()
    step = RQ.RQVAEStep(model, None, torch.zeros(4, 16), graphed=graphed)
    step.labels.fill_(-1)  # the rows past each level's codes must come back 0
    recluster = RQ.RQVAERecluster(model, step.labels, graphed)
    assert recluster.clusters == (8, 6, 8)
    books = model.codebooks.detach()
    for epoch in (0, 3):
        key, static = recluster.stage(5, epoch)
        with host_io_forbidden():
            recluster.staged.run(key, recluster.device_part, static)
        for lvl, (n, k) in enumerate(zip(model.cfg.num_emb_list, recluster.clusters)):
            want = K.cluster_codebook(books[lvl, :n], k, 5 + epoch + lvl)
            assert np.array_equal(step.labels[lvl, :n].numpy(), want), (epoch, lvl)
            assert (step.labels[lvl, n:] == 0).all()
        assert len(set(step.labels[1, :6].tolist())) > 1
        with torch.no_grad():
            model.codebooks.add_(0.1)  # the next epoch's codebooks moved
            books = model.codebooks.detach()
    assert recluster.staged.graphs == 0  # the CPU runs it eagerly


def test_reroute_full_prefixes_leaves_no_collision():
    """Seven items on prefix (0, 1) of a 3-level code space whose last level
    has 4 codes, four of them colliding after the last-level pass: the
    members but the first of each group move to the nearest second-level
    code whose prefix has room, and take its nearest free last-level code;
    items on other prefixes stay."""
    codes = np.array([[0, 1, 0], [0, 1, 1], [0, 1, 2], [0, 1, 3], [0, 1, 3], [0, 1, 3],
                      [0, 1, 2], [2, 0, 0], [0, 2, 0]], np.int64)
    before = codes.copy()
    rng = np.random.default_rng(0)
    d_mid, d_last = rng.random((9, 3)), rng.random((9, 3, 4))
    d_mid[:, 2] = 0.0  # every item's nearest second-level code: 2, whose prefix (0, 2) has room

    def scores(idx):
        return d_mid[idx], d_last[idx]

    out = Tokenize._reroute_full_prefixes(codes, scores)
    assert not collision_groups(out)
    moved = [i for i in range(9) if not np.array_equal(out[i], before[i])]
    assert moved == [4, 5, 6]
    for i in moved:
        assert tuple(out[i, :2]) == (0, 2)
    assert len({tuple(r) for r in out[moved]} | {(0, 2, 0)}) == 4  # distinct, beside item 8
    for i in moved:  # the nearest code left free in order of the moves
        free = [m for m in np.argsort(d_last[i, 2], kind="stable")
                if (0, 2, m) not in {tuple(r) for j, r in enumerate(out) if j != i}]
        assert out[i, 2] == free[0]
