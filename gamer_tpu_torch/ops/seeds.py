"""Dropout seeds, as Python ints or read from device memory.

A dropout site's seed is a Python int (the eager path) or a `DeviceSeed`:
entry `index` of a step's int32 seed table plus a static `add`, mod 2^32.
`add` carries what the call site adds to its seed (the row offsets of
`modules/dropout.row_seed`, a MoE slice's expert shift, an expert's `+ e`),
so both forms hash the same value and draw the same mask bit for bit.

The kernels take a seed as (pointer, add) and read the word on the card
(`gamer::Seed`, `csrc/common.cuh`); an int passes a null pointer. So a
captured training step (`train/loop.Trainer`) draws new masks at every replay
once the host has rewritten the table, where seeds passed by value would be
frozen at capture. The plain versions add the table's entry to their hash as
a tensor (`hash_term`), so neither route reads a seed back into Python. The
autograd Functions keep the `DeviceSeed` (the table and the add), not a value.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class DeviceSeed:
    """(table[index] + add) mod 2^32; `table` is an int32 tensor on the
    device of the tensors the seed's kernels read."""

    table: torch.Tensor
    index: int
    add: int = 0

    def __add__(self, k: int) -> "DeviceSeed":
        return DeviceSeed(self.table, self.index, (self.add + int(k)) & U32)

    __radd__ = __add__


def shift(seed, k: int):
    """seed + k mod 2^32, an int or a `DeviceSeed`."""
    return seed + k if isinstance(seed, DeviceSeed) else (int(seed) + int(k)) & U32


def kernel_args(seed, device: torch.device) -> tuple[int | None, int]:
    """(pointer or None, add) of a seed, as the C entry points take it."""
    if not isinstance(seed, DeviceSeed):
        return None, int(seed) & U32
    t = seed.table
    if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
        raise ValueError(f"a device seed table must be a contiguous int32 tensor on {device}, "
                         f"not {t.dtype} on {t.device}")
    if not 0 <= seed.index < t.numel():
        raise IndexError(f"seed {seed.index} of a table of {t.numel()}")
    return t.data_ptr() + 4 * seed.index, seed.add


def hash_term(seed, device=None):
    """The seed as the plain hashes add it: an int, or for a `DeviceSeed`
    an int64 0-d tensor holding the uint32 value (no read into Python)."""
    if not isinstance(seed, DeviceSeed):
        return int(seed) & U32
    return (seed.table[seed.index].to(device=device, dtype=torch.int64) + seed.add) & U32


def draw(generator: torch.Generator, n: int) -> torch.Tensor:
    """The `n` int32 seeds of a training forward's dropout sites, in site
    order, from a CPU generator (int64 on the CPU)."""
    return torch.randint(0, 2 ** 31 - 1, (n,), generator=generator)


def site_seeds(source, n: int, device: torch.device) -> list:
    """The seeds of `n` dropout sites from `source`: a CPU `torch.Generator`
    (`draw`, as ints) or the step's seed table itself, an [n] int32 tensor
    on `device` (as `DeviceSeed`s)."""
    if isinstance(source, torch.Tensor):
        if source.shape != (n,) or source.dtype != torch.int32 or source.device != device:
            raise ValueError(f"the seed table must be [{n}] int32 on {device}, not "
                             f"{list(source.shape)} {source.dtype} on {source.device}")
        return [DeviceSeed(source, i) for i in range(n)]
    if source is None:
        raise ValueError("the training forward needs a torch.Generator or a seed table for its "
                         "dropout seeds")
    return draw(source, n).tolist()
