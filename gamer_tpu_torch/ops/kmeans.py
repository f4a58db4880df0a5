"""K-means (plain and balanced).

The port's counterpart of `gamer_tpu/ops/kmeans.py`, plain PyTorch as the
JAX package's is plain `jnp` (no kernel); both replace the reference's
sklearn KMeans and `k_means_constrained` (ref: SeqRec/utils/kmeans.py:5-22,
SeqRec/models/tokenizer/RQVAE/layers.py:65-82). Balance is enforced with
Sinkhorn-regularized assignment instead of the exact min/max-size LP.

Seeding (`init_centers`, greedy k-means++) draws on the points' device from
a counter-based hash, as the dropout masks do: the uniforms are the port's
fmix32 hash (`ops/fused_attention.hash_bits`) of (seed, center, trial) over
2^32, the first center is the point they index, and each later center's
candidates are drawn by inverse CDF (`searchsorted` in the float64
cumulative sum of the running distances). It reads no value into Python and
makes no tensor from host data, so `balanced_kmeans` is one device function
of (points, seed) that a CUDA graph can hold (`tasks/rqvae.RQVAERecluster`);
the seed is an int, or read from device memory (an `ops/seeds.DeviceSeed`,
or a one-element int32 tensor), so a replay draws from the seed the host
staged. The CPU and the card draw the same uniforms: a candidate can differ
between them only where a uniform falls within the rounding of the two
devices' cumulative sums (or of the distances under them). The Lloyd loops
(`lloyd`, `balanced_lloyd`) start from any given centers. The JAX package
draws from `jax.random`, which torch cannot reproduce: from the same
initial centers the two agree, from their own seeding they agree in
quality. Ties resolve as in JAX: the first index for argmin/argmax, a
stable sort for the order in which empty clusters are reseeded.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gamer_tpu_torch.ops.fused_attention import hash_bits
from gamer_tpu_torch.ops.seeds import DeviceSeed
from gamer_tpu_torch.ops.sinkhorn import balanced_assign


def pairwise_sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return ((x * x).sum(dim=1, keepdim=True) + (centers * centers).sum(dim=1)[None, :]
            - 2.0 * x @ centers.T)


def seeding_uniforms(seed, k: int, trials: int, device, stream: int = 0) -> torch.Tensor:
    """[k, trials] float64 uniforms in [0, 1) of a seeding: the fmix32 hash
    of (seed, center, trial) over 2^32, in `stream` (one a seeding of
    `kmeans`'s `n_init`). `seed`: an int, a `DeviceSeed` or a one-element
    int32 tensor, read on the device."""
    if isinstance(seed, torch.Tensor):
        seed = DeviceSeed(seed.reshape(1), 0)
    rows = torch.arange(k, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(trials, dtype=torch.int64, device=device)[None, :]
    return hash_bits(seed, stream, rows, cols).double() / 4294967296.0


def seeding_trials(k: int) -> int:
    """Candidates drawn a center: 2 + log(k), as sklearn's greedy k-means++."""
    return 2 + int(math.log(max(k, 2)))


def init_centers(x: torch.Tensor, k: int, seed=0, stream: int = 0) -> torch.Tensor:
    """Greedy k-means++ seeding (sklearn's variant): the first center is the
    point of the hash's first uniform; each later one samples 2 + log(k)
    candidates proportional to the squared distance from the chosen set and
    keeps the one that most reduces the total potential. The draws are
    `seeding_uniforms(seed, k, trials, x.device, stream)`."""
    n = x.shape[0]
    u = seeding_uniforms(seed, k, seeding_trials(k), x.device, stream)
    first = (u[0, :1] * n).long().clamp_(max=n - 1)
    centers = x.index_select(0, first).repeat(k, 1)
    dmin = ((x - centers[:1]) ** 2).sum(dim=1)  # running min distance to the chosen set
    xx = (x * x).sum(dim=1)
    for i in range(1, k):
        # candidates by inverse CDF in proportion to dmin; indices stay on the device
        cum = torch.cumsum(dmin.clamp(min=1e-12).double(), 0)
        cand = torch.searchsorted(cum, u[i] * cum[-1:], right=True).clamp_(max=n - 1)
        cx = x.index_select(0, cand)  # [T, D]
        d_cand = xx[None, :] + (cx * cx).sum(dim=1)[:, None] - 2.0 * cx @ x.T  # [T, N]
        d_new = torch.minimum(dmin[None, :], d_cand)
        best = torch.argmin(d_new.sum(dim=1)).reshape(1)
        centers[i] = cx.index_select(0, best)[0]
        dmin = d_new.index_select(0, best)[0]
    return centers


def update_centers(x: torch.Tensor, labels: torch.Tensor, k: int,
                   old: torch.Tensor) -> torch.Tensor:
    """Cluster means; an empty cluster is reseeded at one of the k points
    farthest from their assigned center."""
    one_hot = F.one_hot(labels, k).to(x.dtype)  # [N, K]
    counts = one_hot.sum(dim=0)
    centers = (one_hot.T @ x) / counts.clamp(min=1.0)[:, None]
    own = pairwise_sq_dists(x, centers).gather(1, labels[:, None])[:, 0]
    reseeded = x[torch.argsort(-own, stable=True)[:k]]
    empty = (counts == 0)[:, None]
    return torch.where(empty, reseeded, torch.where(counts[:, None] > 0, centers, old))


def lloyd(x: torch.Tensor, centers: torch.Tensor, iters: int):
    """Lloyd iterations from `centers`: (centers, labels, inertia)."""
    k = centers.shape[0]
    for _ in range(iters):
        centers = update_centers(x, torch.argmin(pairwise_sq_dists(x, centers), dim=1), k,
                                 centers)
    d = pairwise_sq_dists(x, centers)
    return centers, torch.argmin(d, dim=1), d.min(dim=1).values.sum()


def balanced_lloyd(x: torch.Tensor, centers: torch.Tensor, iters: int, epsilon: float = 0.03,
                   sk_iters: int = 50):
    """Lloyd iterations from `centers` with Sinkhorn-balanced assignment
    each step: (centers, labels)."""
    k = centers.shape[0]
    for _ in range(iters):
        labels = balanced_assign(pairwise_sq_dists(x, centers), epsilon, sk_iters)
        centers = update_centers(x, labels, k, centers)
    return centers, balanced_assign(pairwise_sq_dists(x, centers), epsilon, sk_iters)


def _as_float(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(np.asarray(x, dtype=np.float32))


def kmeans(x, k: int, iters: int = 10, seed: int = 0, n_init: int = 1,
           centers: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain Lloyd k-means, greedy-++ seeded from `seed` (seeding r of
    `n_init` in stream r; or from `centers`); the best of the `n_init` runs
    by inertia, compared on the host. Returns (centers [K, D], labels [N])
    on x's device."""
    x = _as_float(x)
    if centers is not None:
        return lloyd(x, centers.to(x), iters)[:2]
    best = None
    for r in range(n_init):
        run = lloyd(x, init_centers(x, k, seed, stream=r), iters)
        if best is None or run[2] < best[2]:
            best = run
    return best[0], best[1]


def balanced_kmeans(x, k: int, iters: int = 10, seed=0, epsilon: float = 0.03,
                    sk_iters: int = 50, centers: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Size-balanced k-means: Sinkhorn assignment each Lloyd step, seeded
    from `seed` (an int or a device seed, `seeding_uniforms`; or from
    `centers`). Replaces `constrained_km` (ref utils/kmeans.py:5-22).
    Returns (centers [K, D], labels [N]); cluster sizes concentrate near
    N/K. On a tensor `x` it reads nothing into Python: JAX's jitted
    `_balanced_impl`, which a CUDA graph can hold."""
    x = _as_float(x)
    if centers is None:
        centers = init_centers(x, k, seed)
    return balanced_lloyd(x, centers.to(x), iters, epsilon, sk_iters)


def codebook_labels(codebook, n_clusters: int = 10, seed=0) -> torch.Tensor:
    """Per-epoch diversity clustering of a codebook (ref
    trainers/RQVAE.py:163-177): int64 labels [n_codes] on its device, from
    an int or a device seed; no host read."""
    return balanced_kmeans(codebook, n_clusters, iters=10, seed=seed)[1]


def cluster_codebook(codebook, n_clusters: int = 10, seed: int = 0) -> np.ndarray:
    """`codebook_labels` on the host: int labels [n_codes]."""
    return codebook_labels(codebook, n_clusters, seed).cpu().numpy()
