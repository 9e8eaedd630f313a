"""Fixed-range weighted histograms.

Port of ``weighted_histogram``, ``weighted_histogram_multi_window`` and
``histogram_density`` of ``mcmctoffitting_tpu/ops/histogram.py``.
``weighted_histogram`` (one range over the trailing axis) dispatches by
device to kernel K3 and lives with it in ``ops/cuda_hist.py``.  The JAX package builds its
histograms as one-hot matmuls for the TPU's matrix unit; here they are a
plain ``scatter_add_``, summed in float32.  Semantics are np.histogram's: values
outside [lo, hi] are dropped and a value equal to ``hi`` lands in the last
bin.  Bins at or beyond a run's ``n_bins`` (padding up to the widest
window) stay zero.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cuda_hist import weighted_histogram  # noqa: F401  (dispatch to K3)


class WindowConstants(NamedTuple):
    """Per-run TOF window constants as small device tensors, plus the
    padded bin count.  ``scale`` is float32(n_bins / (hi - lo)), fixed once
    on the host: every histogram (plain or kernel) uses these exact values.
    """

    lo: torch.Tensor       # (R,) float32
    hi: torch.Tensor       # (R,) float32
    scale: torch.Tensor    # (R,) float32
    nb1: torch.Tensor      # (R,) int32, n_bins - 1
    n_pad: int


def window_constants(windows, *, device) -> WindowConstants:
    """Window constants of a tuple of ``constants.TofWindow``."""
    def f32(vals):
        return torch.as_tensor(np.asarray(vals, np.float32), device=device)

    return WindowConstants(
        f32([w.lo for w in windows]), f32([w.hi for w in windows]),
        f32([np.float32(w.n_bins / (w.hi - w.lo)) for w in windows]),
        torch.as_tensor(np.asarray([w.n_bins - 1 for w in windows], np.int32),
                        device=device),
        max(w.n_bins for w in windows))


def weighted_histogram_multi_window(values: torch.Tensor,
                                    win: WindowConstants,
                                    weights: torch.Tensor,
                                    sum_dtype=torch.float32) -> torch.Tensor:
    """Per-run histograms: values/weights (..., R, N) -> (..., R, n_pad),
    row r binned against window r; the float32 weights are summed, and
    returned, in ``sum_dtype``."""
    lo, hi = win.lo[:, None], win.hi[:, None]
    in_range = (values >= lo) & (values <= hi)
    scaled = torch.floor((values - lo) * win.scale[:, None])
    # out-of-range (and NaN) values get index 0 and weight 0
    idx = torch.where(in_range, scaled, 0.0).to(torch.int64)
    idx = torch.minimum(torch.clamp_min(idx, 0), win.nb1[:, None].long())
    w = torch.where(in_range, weights.to(torch.float32), 0.0).to(sum_dtype)
    out = torch.zeros(values.shape[:-1] + (win.n_pad,), dtype=sum_dtype,
                      device=values.device)
    return out.scatter_add_(-1, idx, w)


def histogram_density(hist: torch.Tensor, lo: float, hi: float):
    """A count/weight histogram in np.histogram(density=True) form."""
    width = (hi - lo) / hist.shape[-1]
    return hist / (torch.sum(hist, dim=-1, keepdim=True) * width)
