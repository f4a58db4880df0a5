"""Sinkhorn balanced assignment.

The port's counterpart of `gamer_tpu/ops/sinkhorn.py`, plain PyTorch as the
JAX package's is plain `jnp` (no kernel). Math of the reference (ref:
SeqRec/models/tokenizer/RQVAE/layers.py:85-104 and utils/kmeans.py:25-34):
distances are centered/normalized to [-1, 1], Q = exp(-d/eps) is alternately
row- and column-normalized, and the result is scaled so each sample row sums
to 1. Like the JAX package it runs in log space in float32 (the reference
upcasts to float64 because exp(-d/eps) overflows float32 for small eps), and
its first logsumexp runs over all elements.
"""

from __future__ import annotations

import math

import torch


def center_distance(distances: torch.Tensor) -> torch.Tensor:
    """Normalize distances to ~[-1, 1] (ref utils/kmeans.py:25-34)."""
    mx, mn = distances.max(), distances.min()
    middle = (mx + mn) / 2
    amplitude = mx - middle + 1e-5
    return (distances - middle) / amplitude


def sinkhorn(distances: torch.Tensor, epsilon: float, iterations: int) -> torch.Tensor:
    """[B, K] distances -> [B, K] balanced soft-assignment (rows sum to 1)."""
    logq = (-distances / epsilon).float()
    B, K = logq.shape
    logq = logq - torch.logsumexp(logq.reshape(-1), dim=0)
    for _ in range(iterations):
        # per-sample mass 1/B, then per-centroid mass 1/K
        logq = logq - torch.logsumexp(logq, dim=1, keepdim=True) - math.log(B)
        logq = logq - torch.logsumexp(logq, dim=0, keepdim=True) - math.log(K)
    return torch.exp(logq + math.log(B))


def balanced_assign(distances: torch.Tensor, epsilon: float, iterations: int) -> torch.Tensor:
    """Hard balanced assignment: argmax of the Sinkhorn plan over centered
    distances (the first index on ties, as `jnp.argmax`)."""
    return torch.argmax(sinkhorn(center_distance(distances), epsilon, iterations), dim=-1)
