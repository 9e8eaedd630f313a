"""Kernel K2 wrapper: zero-degree-segment TOF histograms, by device,
forward and backward.

Counterpart of ``mcmctoffitting_tpu/ops/pallas_tof.py`` (the TPU kernel
and its custom VJP) and of the JAX package's dispatch
``mcmctoffitting_tpu/models/forward.py::_segments_hist_auto``.  A CPU
tensor takes :func:`tof_hist_segments_plain`, under autograd; a CUDA
tensor launches ``csrc/tof_hist.cu`` or raises.  The kernel sums each row
in fixed point (the same output on every call, each bin the float32
nearest to its exact sum); the plain version sums float32 weights.  Where
a CUDA input needs a gradient, :class:`TofHistSegments` takes the forward
kernel and the backward kernel ``tof_hist_bwd``: the gather of the
output's cotangent at each sample's bin, which the forward kernels share
one bin function with.  ``tof_hist_segments.launches`` and
``tof_hist_segments.backward_launches`` count the wrapper's calls that
launch each kernel: a call made while a CUDA graph is captured counts,
and a replay of the graph, which calls no wrapper, adds nothing
(``models/logp_graph.py`` counts replays).
"""
from __future__ import annotations

import torch

from .cuda_build import check, current_stream_ptr, load_library
from .histogram import (WindowConstants, weighted_histogram_multi_window,
                        window_bins)


def tof_hist_segments_plain(base_tof: torch.Tensor, draws: torch.Tensor,
                            zt: torch.Tensor, zw: torch.Tensor,
                            win: WindowConstants,
                            sum_dtype=torch.float32) -> torch.Tensor:
    """Expand every lattice cell over the K segments, then histogram:
    base_tof/draws (..., R, M, Be), zt/zw (Be, K) -> (..., R, n_pad).
    Times and weights are float32; ``sum_dtype=torch.float64`` sums the
    weights exactly enough to hold the kernel's rounding against."""
    values = base_tof[..., None] + zt                  # (..., R, M, Be, K)
    weights = draws[..., None] * zw
    lead = base_tof.shape[:-2]
    return weighted_histogram_multi_window(
        values.reshape(lead + (-1,)), win, weights.reshape(lead + (-1,)),
        sum_dtype)


def tof_hist_segments_bwd_plain(gbar: torch.Tensor, base_tof: torch.Tensor,
                                zt: torch.Tensor, zw: torch.Tensor,
                                win: WindowConstants,
                                sum_dtype=torch.float32) -> torch.Tensor:
    """The histogram's backward by an explicit gather, the JAX package's
    ``_fn_bwd``: gbar (..., R, n_pad) -> grad_draws (..., R, M, Be) =
    sum_k zw[b, k] gbar[bin(base_tof[m, b] + zt[b, k])] over the in-window
    samples, binned as :func:`tof_hist_segments_plain` bins them.  The
    gathered terms are summed over k in ``sum_dtype``; float64 is the
    reference the kernel is held against."""
    values = base_tof[..., None] + zt                  # (..., R, M, Be, K)
    lead = base_tof.shape[:-2]
    idx, in_range = window_bins(values.reshape(lead + (-1,)), win)
    g = torch.gather(gbar.to(sum_dtype), -1, idx)
    g = torch.where(in_range, g, 0.0).reshape(values.shape)
    return torch.sum(g * zw.to(sum_dtype), dim=-1)


def _check_static(zt, zw, lo, hi, scale, nb1):
    """The tables and window constants: one device, float32 (nb1 int32),
    contiguous, (Be, K) twice and (R,) four times."""
    dev, f32 = zt.device, torch.float32
    if not (zw.device == dev and lo.device == dev and hi.device == dev
            and scale.device == dev and nb1.device == dev):
        raise ValueError("tof_hist_segments: all inputs must be on one device")
    if not (zt.dtype == f32 and zw.dtype == f32 and lo.dtype == f32
            and hi.dtype == f32 and scale.dtype == f32
            and nb1.dtype == torch.int32):
        raise TypeError("tof_hist_segments: float32 inputs and int32 nb1")
    if not (zt.is_contiguous() and zw.is_contiguous() and lo.is_contiguous()
            and hi.is_contiguous() and scale.is_contiguous()
            and nb1.is_contiguous()):
        raise ValueError("tof_hist_segments: inputs must be contiguous")
    if (zt.shape != zw.shape or zt.dim() != 2 or lo.dim() != 1
            or not (hi.shape == scale.shape == nb1.shape == lo.shape)):
        raise ValueError(
            f"tof_hist_segments: shapes zt {tuple(zt.shape)}, zw "
            f"{tuple(zw.shape)}, windows {tuple(lo.shape)}, "
            f"{tuple(hi.shape)}, {tuple(scale.shape)}, {tuple(nb1.shape)}")


# the tables and window tensors that passed _check_static last: a forward
# model hands over the same six tensors on every call, and a tensor's
# device, dtype and shape do not change, so they are checked once
_checked = (None,) * 6


def _check_args(base_tof, draws, zt, zw, win):
    """Raise on what the kernel does not take (straight-line: this runs
    on every call of the forward model)."""
    global _checked
    lo, hi, scale, nb1, _ = win
    c = _checked
    if not (zt is c[0] and zw is c[1] and lo is c[2] and hi is c[3]
            and scale is c[4] and nb1 is c[5]):
        _check_static(zt, zw, lo, hi, scale, nb1)
        _checked = (zt, zw, lo, hi, scale, nb1)
    dev = zt.device
    if not (base_tof.device == dev and draws.device == dev):
        raise ValueError("tof_hist_segments: all inputs must be on one device")
    if not (base_tof.dtype == torch.float32
            and draws.dtype == torch.float32):
        raise TypeError("tof_hist_segments: float32 inputs and int32 nb1")
    if not (base_tof.is_contiguous() and draws.is_contiguous()):
        raise ValueError("tof_hist_segments: inputs must be contiguous")
    shape = base_tof.shape
    if (draws.shape != shape or len(shape) < 3 or shape[-3] != lo.shape[0]
            or shape[-1] != zt.shape[0]):
        raise ValueError(
            f"tof_hist_segments: shapes base {tuple(shape)}, draws "
            f"{tuple(draws.shape)}, zt {tuple(zt.shape)} for "
            f"{lo.shape[0]} runs")


# the tables as the kernel reads them, made once per pair of tables: the
# pair (identity and in-place version counters) and what was made of it
_tables = (None, None, -1, -1, None)


def _kernel_tables(zt: torch.Tensor, zw: torch.Tensor):
    """(zt, zw) segment-major, (K, Be) each, and max_b sum_k |zw[b, k]| as a
    one-element tensor: device memory the kernel reads, no synchronize."""
    global _tables
    c = _tables
    if (zt is c[0] and zw is c[1] and zt._version == c[2]
            and zw._version == c[3]):
        return c[4]
    made = (zt.t().contiguous(), zw.t().contiguous(),
            zw.abs().sum(dim=1).max().reshape(1))
    # made while a CUDA graph is captured, the copies are filled only when
    # the graph is replayed: such copies serve that graph, not later calls
    if not torch.cuda.is_current_stream_capturing():
        _tables = (zt, zw, zt._version, zw._version, made)
    return made


def _launch(base_tof, draws, zt, zw, win) -> torch.Tensor:
    """The forward kernel on checked CUDA inputs."""
    dev = base_tof.device
    n_x, n_ed = base_tof.shape[-2:]
    out = torch.empty(base_tof.shape[:-2] + (win.n_pad,),
                      dtype=torch.float32, device=dev)
    zt_t, zw_t, zw_abs_max = _kernel_tables(zt, zw)
    n_rows = out.numel() // win.n_pad
    check(load_library().lib.mcmctof_tof_hist(
        base_tof.data_ptr(), draws.data_ptr(), zt_t.data_ptr(),
        zw_t.data_ptr(), zw_abs_max.data_ptr(), win.lo.data_ptr(),
        win.hi.data_ptr(), win.scale.data_ptr(), win.nb1.data_ptr(),
        out.data_ptr(), n_rows, win.lo.shape[0], n_x * n_ed, n_ed,
        zt.shape[1], win.n_pad, dev.index, current_stream_ptr(dev)),
        "tof_hist kernel launch")
    tof_hist_segments.launches += 1
    return out


def tof_hist_segments_backward(gbar: torch.Tensor, base_tof: torch.Tensor,
                               zt: torch.Tensor, zw: torch.Tensor,
                               win: WindowConstants) -> torch.Tensor:
    """The histogram's backward, (..., R, n_pad) cotangent -> (..., R, M,
    Be) gradient of the draws: :func:`tof_hist_segments_bwd_plain` for a
    CPU tensor, the ``tof_hist_bwd`` kernel for a CUDA one."""
    _check_args(base_tof, base_tof, zt, zw, win)   # the draws' shape is base's
    out_shape = base_tof.shape[:-2] + (win.n_pad,)
    if gbar.shape != out_shape:
        raise ValueError(f"tof_hist_segments_backward: cotangent "
                         f"{tuple(gbar.shape)}, output {tuple(out_shape)}")
    if gbar.device != base_tof.device:
        raise ValueError("tof_hist_segments_backward: all inputs must be on "
                         "one device")
    if base_tof.device.type == "cpu":
        return tof_hist_segments_bwd_plain(gbar, base_tof, zt, zw, win)
    gbar = gbar.to(torch.float32).contiguous()
    dev = base_tof.device
    grad = torch.empty_like(base_tof)
    if grad.numel() == 0:
        return grad
    zt_t, zw_t, _ = _kernel_tables(zt, zw)
    n_x, n_ed = base_tof.shape[-2:]
    check(load_library().lib.mcmctof_tof_hist_bwd(
        gbar.data_ptr(), base_tof.data_ptr(), zt_t.data_ptr(),
        zw_t.data_ptr(), win.lo.data_ptr(), win.hi.data_ptr(),
        win.scale.data_ptr(), win.nb1.data_ptr(), grad.data_ptr(),
        gbar.numel() // win.n_pad, win.lo.shape[0], n_x * n_ed, n_ed,
        zt.shape[1], win.n_pad, dev.index, current_stream_ptr(dev)),
        "tof_hist_bwd kernel launch")
    tof_hist_segments.backward_launches += 1
    return grad


def tof_hist_backward_variant(n_seg: int) -> str:
    """Which backward kernel the C library launches for ``n_seg``
    segments: ``'K = 10'`` or ``'K = 1'`` (K fixed at compile time), else
    ``'general'``."""
    k = load_library().lib.mcmctof_tof_hist_bwd_plan(n_seg)
    return f"K = {k}" if k else "general"


class TofHistSegments(torch.autograd.Function):
    """K2 under autograd on the card: the forward kernel, and as backward
    the ``tof_hist_bwd`` kernel for the draws.  The output is linear in the
    draws and piecewise constant in the sample times, so ``base_tof``,
    ``zt`` and ``zw`` get no gradient (the JAX package's ``_fn_bwd``
    returns zeros for them)."""

    @staticmethod
    def forward(ctx, base_tof, draws, zt, zw, win):
        ctx.save_for_backward(base_tof, zt, zw)
        ctx.win = win
        return _launch(base_tof, draws, zt, zw, win)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gbar):
        base_tof, zt, zw = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[1]:
            grad = tof_hist_segments_backward(gbar, base_tof, zt, zw,
                                              ctx.win)
        return None, grad, None, None, None


def tof_hist_segments(base_tof: torch.Tensor, draws: torch.Tensor,
                      zt: torch.Tensor, zw: torch.Tensor,
                      win: WindowConstants) -> torch.Tensor:
    """Per-(walker, run) TOF histograms, (..., R, M, Be) -> (..., R, n_pad).
    Any bin count: the C library picks the kernel that has room for it.
    On the card, an input that needs a gradient goes through
    :class:`TofHistSegments`; on the CPU the plain version is differentiated
    by autograd."""
    _check_args(base_tof, draws, zt, zw, win)
    dev = base_tof.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"tof_hist_segments: no kernel for device {dev}")
    out_shape = base_tof.shape[:-2] + (win.n_pad,)
    if base_tof.numel() == 0:          # no rows, or rows without cells
        return torch.zeros(out_shape, dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return tof_hist_segments_plain(base_tof, draws, zt, zw, win)
    if torch.is_grad_enabled() and (base_tof.requires_grad
                                    or draws.requires_grad
                                    or zt.requires_grad or zw.requires_grad):
        return TofHistSegments.apply(base_tof, draws, zt, zw, win)
    return _launch(base_tof, draws, zt, zw, win)


tof_hist_segments.launches = 0
tof_hist_segments.backward_launches = 0
