"""Kernel K1 wrapper: exact Poisson draws, dispatched by device.

Counterpart of ``mcmctoffitting_tpu/ops/pallas_poisson.py`` (the TPU
kernel) and of the JAX package's dispatch
``mcmctoffitting_tpu/ops/poisson.py::poisson_auto``.  A CPU
tensor takes the plain version (``ops/poisson.py::poisson_ptrs``); a CUDA
tensor launches ``csrc/poisson.cu`` or raises.  Both draw from the same
Philox stream keyed by ``seed``, so on the card they agree element by
element.  ``poisson.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .cuda_build import check, load_library
from .poisson import poisson_ptrs


def poisson(lam: torch.Tensor, seed: tuple[int, int]) -> torch.Tensor:
    """Exact Poisson draws of a contiguous float32 rate tensor; ``seed``
    is two 32-bit words drawn on the host (``poisson.seed_words``)."""
    if lam.dtype != torch.float32:
        raise TypeError(f"poisson: rates must be float32, got {lam.dtype}")
    if lam.device.type == "cpu":
        return poisson_ptrs(lam, seed)
    if lam.device.type != "cuda":
        raise ValueError(f"poisson: no kernel for device {lam.device}")
    if not lam.is_contiguous():
        raise ValueError("poisson: rates must be contiguous")
    out = torch.empty_like(lam)
    if lam.numel() == 0:
        return out
    lib = load_library().lib
    stream = torch.cuda.current_stream(lam.device).cuda_stream
    check(lib.mcmctof_poisson(lam.data_ptr(), out.data_ptr(), lam.numel(),
                              int(seed[0]) & 0xFFFFFFFF,
                              int(seed[1]) & 0xFFFFFFFF, lam.device.index,
                              stream), "poisson kernel launch")
    poisson.launches += 1
    return out


poisson.launches = 0


def philox_cuda(words: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 on the card: (n, 6) int32 words (counter c0..c3, key
    k0, k1; bit patterns of uint32) -> (n, 4) int32 output words.  The
    known-answer check of the generator inside the Poisson kernel."""
    if words.device.type != "cuda" or words.dtype != torch.int32 \
            or words.dim() != 2 or words.shape[1] != 6:
        raise ValueError("philox_cuda: expects a (n, 6) int32 CUDA tensor")
    words = words.contiguous()
    out = torch.empty((words.shape[0], 4), dtype=torch.int32,
                      device=words.device)
    lib = load_library().lib
    stream = torch.cuda.current_stream(words.device).cuda_stream
    check(lib.mcmctof_philox(words.data_ptr(), out.data_ptr(),
                             words.shape[0], words.device.index, stream),
          "philox kernel launch")
    return out
