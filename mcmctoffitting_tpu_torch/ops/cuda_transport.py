"""Kernel K4 wrapper: fused RK4 transport + moment histograms, by device.

Counterpart of ``mcmctoffitting_tpu/ops/pallas_forward.py``
(``fused_transport_moments``, the TPU kernel ``_fused_kernel``).  A CPU
tensor takes :func:`transport_moments_plain`; a CUDA tensor launches
``csrc/transport_moments.cu`` or raises.  Forward only (the JAX package
has no backward).  ``transport_moments.launches`` counts the wrapper's
calls that launch the kernel: a call made while a CUDA graph is captured
counts, and a replay of the graph, which calls no wrapper, adds nothing
(``models/logp_graph.py`` counts replays).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import check, load_library
from .fixed_point import channel_shifts, dequantise, quantise
from .stopping import RK4Constants, rk4_transport

_PLAIN_CHUNK = 1 << 24     # (rows x M x samples) elements per plain chunk
# steps of the kernel's fixed-point d, d^2, d^3 sums (its counts are
# integers; csrc/transport_moments.cu)
KERNEL_STEPS = (2.0 ** -14, 2.0 ** -15, 2.0 ** -16)
# samples per row the kernel takes: each sample adds at most 2^13 to an
# int64 cell, so a cell stays below 2^44 (exact in float64)
KERNEL_MAX_SAMPLES = 1 << 31
# bounds of the channels (1, d, d^2, d^3), |d| <= 1/2
MOMENT_BOUNDS = (1.0, 0.5, 0.25, 0.125)


class MomentBins(NamedTuple):
    """The eD histogram of the moments: [lo, hi] in n_bins, with the
    float32 scale n_bins / (hi - lo)."""

    lo: float
    hi: float
    n_bins: int

    @property
    def inv_width(self) -> float:
        return float(np.float32(self.n_bins / (self.hi - self.lo)))


def moment_channels(e: torch.Tensor, bins: MomentBins):
    """Bin index and the (1, d, d^2, d^3) channels of energies ``e``
    (zero outside [lo, hi]): (...) -> ((...) int64, (..., 4))."""
    lo, hi = float(np.float32(bins.lo)), float(np.float32(bins.hi))
    u = (e - lo) * bins.inv_width
    idx = torch.clamp(torch.floor(u), 0, bins.n_bins - 1)
    in_range = (e >= lo) & (e <= hi)
    delta = (u - idx) - 0.5
    base = in_range.to(e.dtype)
    d2 = delta * delta
    chans = torch.stack([base, base * delta, base * d2, base * d2 * delta],
                        dim=-1)
    # out-of-range (and NaN) energies: index 0, all channels 0
    return torch.where(in_range, idx, 0.0).long(), torch.where(
        in_range[..., None], chans, 0.0)


def moment_check(moments: torch.Tensor, e: torch.Tensor,
                 bins: MomentBins):
    """Hold moment histograms ``moments`` (R, M, 4, n_bins) from the kernel
    against the float64 sums of the channels of the energies ``e``
    (R, M, N) it binned, channel by channel.  The kernel counts exactly
    and rounds each d, d^2, d^3 to a multiple of its fixed-point step
    (half a step per sample) before its exact int64 sum is rounded to
    float32 once: the tolerance of a d-channel is one step per sample plus
    2^-20 of the sum of the channel's magnitudes.  Returns (counts equal,
    the worst d-channel error over its tolerance)."""
    n_rows, n_x, _ = e.shape
    idx, chans = moment_channels(e, bins)
    cells = (torch.arange(4, device=e.device) * bins.n_bins
             + idx[..., None]).reshape(n_rows, n_x, -1)
    chans = chans.double().reshape(n_rows, n_x, -1)
    del idx
    sums = torch.zeros((n_rows, n_x, 4 * bins.n_bins), dtype=torch.float64,
                       device=e.device)
    mags = torch.zeros_like(sums)
    sums = sums.scatter_add_(-1, cells, chans).reshape(moments.shape)
    mags = mags.scatter_add_(-1, cells, chans.abs()).reshape(moments.shape)
    counts_equal = torch.equal(moments[:, :, 0].double(), sums[:, :, 0])
    steps = torch.tensor(KERNEL_STEPS, dtype=torch.float64, device=e.device)
    tol = sums[:, :, :1] * steps[:, None] + 2.0 ** -20 * mags[:, :, 1:]
    err = (moments[:, :, 1:].double() - sums[:, :, 1:]).abs()
    return counts_equal, (err / tol.clamp_min(1e-300)).max().item()


def kernel_sums_to_moments(sums: torch.Tensor) -> torch.Tensor:
    """The kernel's last step, on the int64 fixed-point sums (..., 4,
    n_bins) of its workspace: each sum times its channel's step (1, then
    ``KERNEL_STEPS``) in float64, rounded to float32 once, as
    ``fixed_point_to_float`` in ``csrc/transport_moments.cu`` does."""
    steps = torch.tensor((1.0, *KERNEL_STEPS), dtype=torch.float64,
                         device=sums.device)
    return (sums.double() * steps[:, None]).float()


def energy_moments(transport, e0: torch.Tensor, n_x: int,
                   bins: MomentBins) -> torch.Tensor:
    """(R, N) initial energies -> (R, M, 4, n_bins) moment histograms of
    the energies ``transport(e0)`` (R, M, n) at the M = ``n_x`` depths: a
    ``scatter_add_`` of the channels over (depth, channel, bin) indices,
    in chunks of samples.  The float32 channel values are summed as int64
    fixed-point numbers (``ops/fixed_point``; |d| <= 1/2) and rounded to
    float32 once, so the sums do not depend on the order of the additions:
    the same on every call, and on the CPU and the GPU, for the same
    energies."""
    n_rows, n = e0.shape
    nb = bins.n_bins
    shifts = channel_shifts(max(1, n), MOMENT_BOUNDS)
    out = torch.zeros((n_rows, n_x * 4 * nb), dtype=torch.int64,
                      device=e0.device)
    chunk = max(1, _PLAIN_CHUNK // max(1, n_rows * n_x))
    offs = (torch.arange(n_x, device=e0.device)[:, None, None] * 4
            + torch.arange(4, device=e0.device)[None, None, :]) * nb
    for start in range(0, n, chunk):
        e = transport(e0[:, start:start + chunk])             # (R, M, n_c)
        idx, chans = moment_channels(e, bins)                 # (R, M, n_c, 4)
        flat = (offs + idx[..., None]).reshape(n_rows, -1)
        out.scatter_add_(1, flat, quantise(chans, shifts).reshape(n_rows, -1))
    return dequantise(out.reshape(n_rows, n_x, 4, nb), shifts, 2)


def transport_moments_plain(e0: torch.Tensor, c: RK4Constants,
                            bins: MomentBins) -> torch.Tensor:
    """(R, N) initial energies -> (R, M, 4, n_bins) moment histograms:
    :func:`ops.stopping.rk4_transport`, then :func:`energy_moments`."""
    return energy_moments(lambda e: rk4_transport(c, e), e0, len(c.h), bins)


def tile_spans(n_x: int, n_bins: int) -> int:
    """Depths per tile of the CUDA kernel at (n_x, n_bins), as its C
    library decides: n_x where one launch holds every depth's histogram,
    fewer where the depths go in tiles, 0 where it cannot take the shape
    (one depth's 4 x n_bins int32 histogram above 200 KiB)."""
    return load_library().lib.mcmctof_transport_moments_tile(n_x, n_bins)


@functools.lru_cache(maxsize=16)
def _steps_tensor(c: RK4Constants, device: torch.device) -> torch.Tensor:
    """(3, M) float32 (h, h/2, h/6) on the device, copied there once
    (a copy per launch would wait for the stream)."""
    return torch.tensor([c.h, c.half_h, c.sixth_h], dtype=torch.float32,
                        device=device)


def transport_moments(e0: torch.Tensor, c: RK4Constants, bins: MomentBins,
                      *, energies_out: bool = False):
    """Per-row moment histograms, (R, N) float32 -> (R, M, 4, n_bins).

    ``energies_out`` (CUDA only) also returns the kernel's transported
    energies (R, M, N), for checks against the plain version.  Where one
    block's shared memory cannot hold every depth's histogram (the
    templates' M = 100 x Be = 150), the kernel takes the depths in tiles
    (:func:`tile_spans`) and carries the energies between them in an
    (R, N) float32 buffer allocated here; a shape it cannot take raises.
    The blocks add their exact fixed-point sums into an int64 workspace
    (R, M, 4, n_bins), allocated and zeroed here, which the kernel's second
    pass rounds to float32 once (:func:`kernel_sums_to_moments`): the
    output is the same bits on every call.
    """
    if e0.dtype != torch.float32 or e0.dim() != 2:
        raise TypeError("transport_moments: expects (R, N) float32 energies")
    if e0.device.type == "cpu":
        if energies_out:
            raise ValueError("transport_moments: energies_out is a check "
                             "of the CUDA kernel")
        return transport_moments_plain(e0, c, bins)
    if e0.device.type != "cuda":
        raise ValueError(f"transport_moments: no kernel for device "
                         f"{e0.device}")
    if not e0.is_contiguous():
        raise ValueError("transport_moments: e0 must be contiguous")
    n_rows, n = e0.shape
    n_x = len(c.h)
    shape = (n_rows, n_x, 4, bins.n_bins)
    e_out = (torch.empty((n_rows, n_x, n), dtype=torch.float32,
                         device=e0.device) if energies_out else None)
    tile = tile_spans(n_x, bins.n_bins)
    if tile < 1:
        raise ValueError(f"transport_moments: the CUDA kernel cannot take "
                         f"{n_x} depths x {bins.n_bins} bins")
    if n >= KERNEL_MAX_SAMPLES:
        raise ValueError(f"transport_moments: {n} samples per row, the "
                         f"kernel's int64 sums take fewer than 2^31")
    if not (n_rows and n):
        out = torch.zeros(shape, dtype=torch.float32, device=e0.device)
    else:
        lib = load_library().lib
        stream = torch.cuda.current_stream(e0.device).cuda_stream
        steps = _steps_tensor(c, e0.device)
        carry = torch.empty_like(e0) if tile < n_x else None
        # the blocks' exact sums meet in this int64 workspace; the kernel's
        # second pass writes every cell of out from it
        acc = torch.zeros(shape, dtype=torch.int64, device=e0.device)
        out = torch.empty(shape, dtype=torch.float32, device=e0.device)
        check(lib.mcmctof_transport_moments(
            e0.data_ptr(), steps.data_ptr(), acc.data_ptr(), out.data_ptr(),
            e_out.data_ptr() if e_out is not None else None,
            None if carry is None else carry.data_ptr(), n_rows, n,
            n_x, c.n_substeps, bins.n_bins, c.a, c.p, c.q, c.energy_floor,
            float(np.float32(bins.lo)), float(np.float32(bins.hi)),
            bins.inv_width, e0.device.index, stream),
            "transport_moments kernel launch")
        transport_moments.launches += 1
    return (out, e_out) if energies_out else out


transport_moments.launches = 0
