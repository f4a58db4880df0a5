"""K-means (plain and balanced).

The port's counterpart of `gamer_tpu/ops/kmeans.py`, plain PyTorch as the
JAX package's is plain `jnp` (no kernel); both replace the reference's
sklearn KMeans and `k_means_constrained` (ref: SeqRec/utils/kmeans.py:5-22,
SeqRec/models/tokenizer/RQVAE/layers.py:65-82). Balance is enforced with
Sinkhorn-regularized assignment instead of the exact min/max-size LP.

Seeding (`init_centers`, greedy k-means++) is a function of its own and
draws from an explicit CPU `torch.Generator`, so the same seed seeds the
same centers on the CPU and the card; the Lloyd loops (`lloyd`,
`balanced_lloyd`) start from any given centers. The JAX package draws from
`jax.random`, which torch cannot reproduce: from the same initial centers
the two agree, from their own seeding they agree in quality. Ties resolve
as in JAX: the first index for argmin/argmax, a stable sort for the order
in which empty clusters are reseeded.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from gamer_tpu_torch.ops.sinkhorn import balanced_assign


def pairwise_sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    return ((x * x).sum(dim=1, keepdim=True) + (centers * centers).sum(dim=1)[None, :]
            - 2.0 * x @ centers.T)


def init_centers(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """Greedy k-means++ seeding (sklearn's variant): sample 2 + log(k)
    candidate centers proportional to the squared distance from the chosen
    set and keep the one that most reduces the total potential. The draws
    come from `generator` (a CPU generator)."""
    n = x.shape[0]
    trials = 2 + int(math.log(max(k, 2)))
    first = int(torch.randint(0, n, (), generator=generator))
    centers = x[first][None].repeat(k, 1)
    dmin = ((x - x[first][None]) ** 2).sum(dim=1)  # running min distance to the chosen set
    xx = (x * x).sum(dim=1)
    for i in range(1, k):
        weights = dmin.clamp(min=1e-12).double().cpu()
        cand = torch.multinomial(weights, trials, replacement=True, generator=generator)
        cx = x[cand.to(x.device)]  # [T, D]
        d_cand = xx[None, :] + (cx * cx).sum(dim=1)[:, None] - 2.0 * cx @ x.T  # [T, N]
        d_new = torch.minimum(dmin[None, :], d_cand)
        best = int(torch.argmin(d_new.sum(dim=1)))
        centers[i] = cx[best]
        dmin = d_new[best]
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
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x).float()


def kmeans(x, k: int, iters: int = 10, seed: int = 0, n_init: int = 1,
           centers: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain Lloyd k-means, greedy-++ seeded from `seed` (or from `centers`);
    the best of `n_init` seedings by inertia. Returns (centers [K, D],
    labels [N]) on x's device."""
    x = _as_float(x)
    if centers is not None:
        return lloyd(x, centers.to(x), iters)[:2]
    gen = torch.Generator().manual_seed(seed)
    best = None
    for _ in range(n_init):
        run = lloyd(x, init_centers(x, k, gen), iters)
        if best is None or run[2] < best[2]:
            best = run
    return best[0], best[1]


def balanced_kmeans(x, k: int, iters: int = 10, seed: int = 0, epsilon: float = 0.03,
                    sk_iters: int = 50, centers: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Size-balanced k-means: Sinkhorn assignment each Lloyd step, seeded
    from `seed` (or from `centers`). Replaces `constrained_km` (ref
    utils/kmeans.py:5-22). Returns (centers [K, D], labels [N]); cluster
    sizes concentrate near N/K."""
    x = _as_float(x)
    if centers is None:
        centers = init_centers(x, k, torch.Generator().manual_seed(seed))
    return balanced_lloyd(x, centers.to(x), iters, epsilon, sk_iters)


def cluster_codebook(codebook, n_clusters: int = 10, seed: int = 0) -> np.ndarray:
    """Per-epoch diversity clustering of a codebook (ref
    trainers/RQVAE.py:163-177); int labels [n_codes]."""
    _, labels = balanced_kmeans(codebook, n_clusters, iters=10, seed=seed)
    return labels.cpu().numpy()
