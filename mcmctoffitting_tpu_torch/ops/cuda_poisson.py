"""Kernel K1 wrapper: exact Poisson draws, dispatched by device.

Counterpart of ``mcmctoffitting_tpu/ops/pallas_poisson.py`` (the TPU
kernel) and of the JAX package's dispatch
``mcmctoffitting_tpu/ops/poisson.py::poisson_auto``.  A CPU
tensor takes the plain version (``ops/poisson.py::poisson_ptrs``); a CUDA
tensor launches ``csrc/poisson.cu`` or raises.  Both draw from the same
Philox stream keyed by ``seed``, so on the card they agree element by
element.  ``poisson.launches`` counts the wrapper's calls that launch
the kernel: a call made while a CUDA graph is captured counts, and a
replay of the graph, which calls no wrapper, adds nothing
(``models/logp_graph.py`` counts replays).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from .cuda_build import check, current_stream_ptr, load_library
from .poisson import check_counter_layout, poisson_ptrs

Seed = Union[tuple, torch.Tensor]


def poisson(lam: torch.Tensor, seed: Seed,
            n_runs: Optional[int] = None, *, offset: int = 0,
            blocks: Optional[tuple] = None) -> torch.Tensor:
    """Exact Poisson draws of a contiguous float32 rate tensor.

    ``seed`` is two 32-bit words: a pair of ints drawn on the host
    (``poisson.seed_words``), or an int64 tensor of two words on the rates'
    device, which the kernel reads when it runs (a launch captured in a
    CUDA graph then draws anew when the tensor is refilled between
    replays).  With ``n_runs``, rates (..., C) are drawn once per run,
    (..., n_runs, C): the draws of the rates copied along a run axis,
    without the copy.  ``offset`` (and ``blocks``, (block, stride)) give
    the output's elements their indices in a larger array of which this
    draw is a part (``ops/poisson.counter_indices``): the draws equal that
    array's, e.g. rows [r0, r0 + n) of (W, R, C) draws with ``offset =
    r0 R C``.
    """
    check_counter_layout(offset, blocks)
    if lam.dtype != torch.float32:
        raise TypeError(f"poisson: rates must be float32, got {lam.dtype}")
    by_tensor = isinstance(seed, torch.Tensor)
    if by_tensor:
        if seed.dtype != torch.int64 or seed.shape != (2,):
            raise TypeError("poisson: a seed tensor holds two int64 words")
        if seed.device != lam.device:
            raise ValueError(f"poisson: seed on {seed.device}, rates on "
                             f"{lam.device}")
    elif len(seed) != 2:
        raise ValueError("poisson: seed is two 32-bit words")
    shape = lam.shape
    if n_runs is not None:
        if n_runs < 1 or lam.dim() < 1:
            raise ValueError(f"poisson: n_runs={n_runs} on rates of shape "
                             f"{tuple(shape)}")
        shape = shape[:-1] + (n_runs, shape[-1])
    if lam.device.type == "cpu":
        rates = lam if n_runs is None else lam[..., None, :].expand(shape)
        return poisson_ptrs(rates, seed, offset=offset, blocks=blocks)
    if lam.device.type != "cuda":
        raise ValueError(f"poisson: no kernel for device {lam.device}")
    if not lam.is_contiguous():
        raise ValueError("poisson: rates must be contiguous")
    out = torch.empty(shape, dtype=torch.float32, device=lam.device)
    n = out.numel()
    if n == 0:
        return out
    if by_tensor:
        words, s0, s1 = seed.data_ptr(), 0, 0
    else:
        words, s0, s1 = None, int(seed[0]) & 0xFFFFFFFF, \
            int(seed[1]) & 0xFFFFFFFF
    block, stride = (0, 0) if blocks is None or blocks[0] >= n else blocks
    check(load_library().lib.mcmctof_poisson(
        lam.data_ptr(), out.data_ptr(), n, shape[-1], n_runs or 1, words,
        s0, s1, offset, block, stride, lam.device.index,
        current_stream_ptr(lam.device)), "poisson kernel launch")
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
    check(load_library().lib.mcmctof_philox(
        words.data_ptr(), out.data_ptr(), words.shape[0],
        words.device.index, current_stream_ptr(words.device)),
        "philox kernel launch")
    return out
