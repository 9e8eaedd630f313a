"""Kernel K3 wrapper: weighted histograms over the trailing axis, by
device.

Counterpart of ``mcmctoffitting_tpu/ops/pallas_hist.py`` (the TPU kernel)
and of the function it was built to replace,
``mcmctoffitting_tpu/ops/histogram.py::weighted_histogram``.  A CPU tensor
takes :func:`weighted_histogram_plain`; a CUDA tensor launches
``csrc/weighted_hist.cu`` or raises.  ``weighted_histogram.launches``
counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cuda_build import check, load_library


def _scale(lo: float, hi: float, n_bins: int) -> float:
    """float32(n_bins / (hi - lo)), the bin scale every version uses."""
    return float(np.float32(n_bins / (hi - lo)))


def weighted_histogram_plain(values: torch.Tensor, lo: float, hi: float,
                             n_bins: int, weights: torch.Tensor,
                             n_valid: Optional[int] = None) -> torch.Tensor:
    """np.histogram(v, n_bins, (lo, hi), weights=w) of every row:
    (..., N) -> (..., n_bins) float32; only the first ``n_valid`` entries
    of each row count.  A ``scatter_add_`` over computed bin indices,
    summed in float64 as the kernel sums (then rounded to float32)."""
    if n_valid is not None:
        values, weights = values[..., :n_valid], weights[..., :n_valid]
    lo32, hi32 = float(np.float32(lo)), float(np.float32(hi))
    in_range = (values >= lo32) & (values <= hi32)
    scaled = torch.floor((values - lo32) * _scale(lo, hi, n_bins))
    # out-of-range (and NaN) values get index 0 and weight 0
    idx = torch.where(in_range, scaled, 0.0).to(torch.int64)
    idx = torch.clamp(idx, 0, n_bins - 1)
    w = torch.where(in_range, weights, 0.0).to(torch.float64)
    out = torch.zeros(values.shape[:-1] + (n_bins,), dtype=torch.float64,
                      device=values.device)
    return out.scatter_add_(-1, idx, w).to(torch.float32)


def weighted_histogram(values: torch.Tensor, lo: float, hi: float,
                       n_bins: int, weights: torch.Tensor,
                       n_valid: Optional[int] = None) -> torch.Tensor:
    """Weighted histogram over the trailing axis, (..., N) -> (..., n_bins)
    float32, with np.histogram's rules."""
    if values.shape != weights.shape:
        raise ValueError(f"weighted_histogram: values {tuple(values.shape)} "
                         f"and weights {tuple(weights.shape)} differ")
    if values.device != weights.device:
        raise ValueError("weighted_histogram: inputs on two devices")
    if values.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("weighted_histogram: float32 values and weights")
    row_len = values.shape[-1]
    n_valid = row_len if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= row_len:
        raise ValueError(f"weighted_histogram: n_valid {n_valid} outside "
                         f"[0, {row_len}]")
    if values.device.type == "cpu":
        return weighted_histogram_plain(values, lo, hi, n_bins, weights,
                                        n_valid)
    if values.device.type != "cuda":
        raise ValueError(f"weighted_histogram: no kernel for device "
                         f"{values.device}")
    if not (values.is_contiguous() and weights.is_contiguous()):
        raise ValueError("weighted_histogram: inputs must be contiguous")
    out = torch.empty(values.shape[:-1] + (n_bins,), dtype=torch.float32,
                      device=values.device)
    n_rows = out.numel() // n_bins
    if n_rows == 0:
        return out
    lib = load_library().lib
    stream = torch.cuda.current_stream(values.device).cuda_stream
    check(lib.mcmctof_weighted_hist(
        values.data_ptr(), weights.data_ptr(), out.data_ptr(), n_rows,
        row_len, n_valid, float(np.float32(lo)), float(np.float32(hi)),
        _scale(lo, hi, n_bins), n_bins, values.device.index, stream),
        "weighted_hist kernel launch")
    weighted_histogram.launches += 1
    return out


weighted_histogram.launches = 0
