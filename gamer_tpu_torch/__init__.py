"""gamer_tpu_torch — the PyTorch/CUDA port of `gamer_tpu` for NVIDIA Hopper.

The package mirrors `gamer_tpu/` module for module and imports nothing of it
(and no JAX). Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a hand-written CUDA C++ kernel under `ops/csrc/`, built with
`nvcc` for `sm_90a` at first use (`ops/_build.py`). Each kernel wrapper
launches its kernel for CUDA tensors and runs the kernel's plain PyTorch
version for CPU tensors; there is no silent fallback between the two.
Kernels with a backward sit behind `torch.autograd.Function`s whose backward
is a kernel too.

Entry points (`QwenFamilyModel`, and through it `make_loss_fn`,
`train.loop.Trainer`, `entry.entry` and `constrained_beam_search`) run on
`cuda` unless the caller passes `device="cpu"`; without CUDA and without that
argument they raise.
"""
