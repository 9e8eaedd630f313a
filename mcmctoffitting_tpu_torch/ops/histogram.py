"""Fixed-range weighted histograms.

Port of ``weighted_histogram``, ``weighted_histogram_multi_window``,
``histogram_density``, ``delta_moment_histogram`` and ``bin_index`` of
``mcmctoffitting_tpu/ops/histogram.py``.
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


def bin_index(values: torch.Tensor, lo: float, hi: float, n_bins: int):
    """np.histogram-compatible bin index of every value: (idx int32,
    in_range bool), the shape of ``values``.  idx = floor((v - lo) n_bins /
    (hi - lo)) clipped to [0, n_bins - 1] (v == hi in the last bin);
    in_range = lo <= v <= hi (NaN: False, its index 0)."""
    v = torch.as_tensor(values)
    scaled = torch.floor((v - lo) * (n_bins / (hi - lo)))
    idx = torch.clamp(torch.nan_to_num(scaled, nan=0.0), 0, n_bins - 1)
    return idx.to(torch.int32), (v >= lo) & (v <= hi)


def window_bins(values: torch.Tensor, win: WindowConstants):
    """np.histogram's bin of every value of (..., R, N) in its run's window:
    (index (..., R, N) int64, in_range (..., R, N) bool).  A value counts
    when lo <= v <= hi (NaN does not), and v == hi lands in the last bin;
    out-of-range values get index 0."""
    lo, hi = win.lo[:, None], win.hi[:, None]
    in_range = (values >= lo) & (values <= hi)
    scaled = torch.floor((values - lo) * win.scale[:, None])
    idx = torch.where(in_range, scaled, 0.0).to(torch.int64)
    idx = torch.minimum(torch.clamp_min(idx, 0), win.nb1[:, None].long())
    return idx, in_range


def weighted_histogram_multi_window(values: torch.Tensor,
                                    win: WindowConstants,
                                    weights: torch.Tensor,
                                    sum_dtype=torch.float32) -> torch.Tensor:
    """Per-run histograms: values/weights (..., R, N) -> (..., R, n_pad),
    row r binned against window r; the float32 weights are summed, and
    returned, in ``sum_dtype``."""
    idx, in_range = window_bins(values, win)
    w = torch.where(in_range, weights.to(torch.float32), 0.0).to(sum_dtype)
    out = torch.zeros(values.shape[:-1] + (win.n_pad,), dtype=sum_dtype,
                      device=values.device)
    return out.scatter_add_(-1, idx, w)


def histogram_density(hist: torch.Tensor, lo: float, hi: float):
    """A count/weight histogram in np.histogram(density=True) form."""
    width = (hi - lo) / hist.shape[-1]
    return hist / (torch.sum(hist, dim=-1, keepdim=True) * width)


def delta_moment_histogram(values: torch.Tensor, lo: float, hi: float,
                           n_bins: int, n_moments: int = 4, *,
                           extra_weight=None) -> torch.Tensor:
    """Within-bin offset moment histograms: for each bin j, M_p[j] = sum
    over its samples of w_s delta_s^p, p = 0 .. n_moments - 1, with delta_s
    = (v_s - lo) n_bins / (hi - lo) - j - 0.5 in [-0.5, 0.5) and w_s the
    optional ``extra_weight`` (else 1).  np.histogram's rules: values
    outside [lo, hi] add nothing, v == hi lands in the last bin.
    (..., N) -> (..., n_moments, n_bins) float32.

    The JAX package builds it as a one-hot matmul (an XLA op, no Pallas
    kernel, and no caller outside its tests); here one ``scatter_add_``
    over (channel, bin) indices, summed in float32."""
    v = values.to(torch.float32)
    u = (v - lo) * (n_bins / (hi - lo))
    idx = torch.clamp(torch.floor(u), 0, n_bins - 1)
    in_range = (v >= lo) & (v <= hi)
    delta = u - idx - 0.5
    base = in_range.to(torch.float32)
    if extra_weight is not None:
        base = base * extra_weight.to(torch.float32)
    chans = [base]
    for _ in range(n_moments - 1):
        chans.append(chans[-1] * delta)
    chans = torch.stack(chans, dim=-2)                  # (..., C, N)
    cells = (torch.arange(n_moments, device=v.device)[:, None] * n_bins
             + torch.where(in_range, idx, 0.0).long()[..., None, :])
    out = torch.zeros(v.shape[:-1] + (n_moments * n_bins,),
                      dtype=torch.float32, device=v.device)
    out.scatter_add_(-1, cells.reshape(v.shape[:-1] + (-1,)),
                     torch.where(in_range[..., None, :], chans, 0.0)
                     .reshape(v.shape[:-1] + (-1,)))
    return out.reshape(v.shape[:-1] + (n_moments, n_bins))
