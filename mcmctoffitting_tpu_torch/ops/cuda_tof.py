"""Kernel K2 wrapper: zero-degree-segment TOF histograms, by device.

Counterpart of ``mcmctoffitting_tpu/ops/pallas_tof.py`` (the TPU kernel)
and of the JAX package's dispatch
``mcmctoffitting_tpu/models/forward.py::_segments_hist_auto``.  A CPU
tensor takes :func:`tof_hist_segments_plain`; a CUDA tensor launches
``csrc/tof_hist.cu`` or raises.  Forward only.
``tof_hist_segments.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from .cuda_build import check, load_library
from .histogram import WindowConstants, weighted_histogram_multi_window


def tof_hist_segments_plain(base_tof: torch.Tensor, draws: torch.Tensor,
                            zt: torch.Tensor, zw: torch.Tensor,
                            win: WindowConstants) -> torch.Tensor:
    """Expand every lattice cell over the K segments, then histogram:
    base_tof/draws (..., R, M, Be), zt/zw (Be, K) -> (..., R, n_pad)."""
    values = base_tof[..., None] + zt                  # (..., R, M, Be, K)
    weights = draws[..., None] * zw
    lead = base_tof.shape[:-2]
    return weighted_histogram_multi_window(
        values.reshape(lead + (-1,)), win, weights.reshape(lead + (-1,)))


def _check_args(base_tof, draws, zt, zw, win):
    tensors = (base_tof, draws, zt, zw, win.lo, win.hi, win.scale, win.nb1)
    if any(t.device != base_tof.device for t in tensors):
        raise ValueError("tof_hist_segments: all inputs must be on one device")
    if any(t.dtype != torch.float32 for t in tensors[:7]) \
            or win.nb1.dtype != torch.int32:
        raise TypeError("tof_hist_segments: float32 inputs and int32 nb1")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("tof_hist_segments: inputs must be contiguous")
    n_runs = win.lo.shape[0]
    if (draws.shape != base_tof.shape or base_tof.dim() < 3
            or base_tof.shape[-3] != n_runs
            or zt.shape != zw.shape or zt.dim() != 2
            or zt.shape[0] != base_tof.shape[-1]):
        raise ValueError(
            f"tof_hist_segments: shapes base {tuple(base_tof.shape)}, draws "
            f"{tuple(draws.shape)}, zt {tuple(zt.shape)}, zw "
            f"{tuple(zw.shape)} for {n_runs} runs")


def tof_hist_segments(base_tof: torch.Tensor, draws: torch.Tensor,
                      zt: torch.Tensor, zw: torch.Tensor,
                      win: WindowConstants) -> torch.Tensor:
    """Per-(walker, run) TOF histograms, (..., R, M, Be) -> (..., R, n_pad)."""
    _check_args(base_tof, draws, zt, zw, win)
    if base_tof.device.type == "cpu":
        return tof_hist_segments_plain(base_tof, draws, zt, zw, win)
    if base_tof.device.type != "cuda":
        raise ValueError(f"tof_hist_segments: no kernel for device "
                         f"{base_tof.device}")
    n_runs = win.lo.shape[0]
    n_x, n_ed = base_tof.shape[-2:]
    n_rows = base_tof.numel() // (n_x * n_ed)
    out = torch.empty(base_tof.shape[:-2] + (win.n_pad,),
                      dtype=torch.float32, device=base_tof.device)
    if n_rows == 0:
        return out
    lib = load_library().lib
    stream = torch.cuda.current_stream(base_tof.device).cuda_stream
    check(lib.mcmctof_tof_hist(
        base_tof.data_ptr(), draws.data_ptr(), zt.data_ptr(), zw.data_ptr(),
        win.lo.data_ptr(), win.hi.data_ptr(), win.scale.data_ptr(),
        win.nb1.data_ptr(), out.data_ptr(), n_rows, n_runs, n_x * n_ed,
        n_ed, zt.shape[1], win.n_pad, base_tof.device.index, stream),
        "tof_hist kernel launch")
    tof_hist_segments.launches += 1
    return out


tof_hist_segments.launches = 0
