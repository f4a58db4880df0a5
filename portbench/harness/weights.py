"""Weights made from the seed on the device, one draw for the whole model:
a standard normal vector from a `torch.Generator` seeded with the run's
seed, cut into the parameters in `spec` order and scaled by each one's std;
the norms' scales are 1. Both the program and the reference are given these
values."""

from __future__ import annotations

import math

import torch


def make(spec, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: fp32 tensor} of (name, shape, kind, std) `spec`."""
    normal = [(n, s, std) for n, s, kind, std in spec if kind == "normal"]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=gen, device=device)
    out, at = {}, 0
    for name, shape, std in normal:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape) * std
        at += n
    for name, shape, kind, _ in spec:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
    return {n: out[n] for n, *_ in spec}


@torch.no_grad()
def load(model: torch.nn.Module, weights: dict[str, torch.Tensor]) -> None:
    """Copies `weights` into the program's parameters, which must have the
    same names and shapes."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameter names differ: program only {sorted(set(params) - set(weights))},"
                         f" benchmark only {sorted(set(weights) - set(params))}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, benchmark "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])
