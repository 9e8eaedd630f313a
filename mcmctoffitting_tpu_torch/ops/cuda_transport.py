"""Kernel K4 wrapper: fused RK4 transport + moment histograms, by device.

Counterpart of ``mcmctoffitting_tpu/ops/pallas_forward.py``
(``fused_transport_moments``, the TPU kernel ``_fused_kernel``).  A CPU
tensor takes :func:`transport_moments_plain`; a CUDA tensor launches
``csrc/transport_moments.cu`` or raises.  ``transport_moments.launches``
counts kernel launches.  Forward only (the JAX package has no backward).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import check, load_library
from .stopping import RK4Constants, rk4_transport

_PLAIN_CHUNK = 1 << 24     # (rows x M x samples) elements per plain chunk


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


def transport_moments_plain(e0: torch.Tensor, c: RK4Constants,
                            bins: MomentBins) -> torch.Tensor:
    """(R, N) initial energies -> (R, M, 4, n_bins) moment histograms:
    :func:`ops.stopping.rk4_transport`, then a ``scatter_add_`` of the
    channels over (depth, channel, bin) indices, in chunks of samples."""
    n_rows, n = e0.shape
    n_x = len(c.h)
    nb = bins.n_bins
    out = torch.zeros((n_rows, n_x * 4 * nb), dtype=torch.float32,
                      device=e0.device)
    chunk = max(1, _PLAIN_CHUNK // max(1, n_rows * n_x))
    offs = (torch.arange(n_x, device=e0.device)[:, None, None] * 4
            + torch.arange(4, device=e0.device)[None, None, :]) * nb
    for start in range(0, n, chunk):
        e = rk4_transport(c, e0[:, start:start + chunk])      # (R, M, n_c)
        idx, chans = moment_channels(e, bins)                 # (R, M, n_c, 4)
        flat = (offs + idx[..., None]).reshape(n_rows, -1)
        out.scatter_add_(1, flat, chans.reshape(n_rows, -1))
    return out.reshape(n_rows, n_x, 4, nb)


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
    energies (R, M, N), for checks against the plain version.
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
    out = torch.zeros((n_rows, n_x, 4, bins.n_bins), dtype=torch.float32,
                      device=e0.device)
    e_out = (torch.empty((n_rows, n_x, n), dtype=torch.float32,
                         device=e0.device) if energies_out else None)
    if n_rows and n:
        # enough blocks for ~4 per SM of an H100 (132 SMs), each >= 2048
        # samples
        n_split = int(min(max(1, -(-528 // n_rows)), max(1, n // 2048),
                          65535))
        lib = load_library().lib
        stream = torch.cuda.current_stream(e0.device).cuda_stream
        steps = _steps_tensor(c, e0.device)
        check(lib.mcmctof_transport_moments(
            e0.data_ptr(), steps.data_ptr(), out.data_ptr(),
            e_out.data_ptr() if e_out is not None else None, n_rows, n,
            n_x, c.n_substeps, bins.n_bins, c.a, c.p, c.q, c.energy_floor,
            float(np.float32(bins.lo)), float(np.float32(bins.hi)),
            bins.inv_width, n_split, e0.device.index, stream),
            "transport_moments kernel launch")
        transport_moments.launches += 1
    return (out, e_out) if energies_out else out


transport_moments.launches = 0
