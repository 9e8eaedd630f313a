"""The counts estimator's rate stage as one kernel, dispatched on its input.

``csrc/counts_rates.cu`` computes, in one launch for every walker, what
the plain version ``ops/e0grid.py::counts_lambdas`` computes in some 500
PyTorch operations: the Poisson rates of the F fine cells and of the two
overflow cells, the conditional moments, and the three e0 means.  It
repeats the plain version's arithmetic operation for operation, so on the
card the two agree bit for bit.

Dispatch, on the device: the CPU takes ``counts_lambdas`` as it is, in
any dtype and with or without a gradient; a CUDA device launches the
kernel, which takes float32 parameters that do not require a gradient
and refuses anything else, as it refuses any other device, rather than
run the plain version's operations there.  ``counts_rates.launches``
counts kernel launches.
"""
from __future__ import annotations

import torch

from .cuda_build import check, current_stream_ptr, load_library
from .e0grid import CountsRates, E0Grid, counts_lambdas

CLOSURES = ("exact", "cell")


def counts_rates(grid: E0Grid, params: torch.Tensor, n_samples,
                 truncated: bool, closure: str = "exact") -> CountsRates:
    """Part 1 of the counts estimator for the walkers' parameters ``params``
    (W, P), P >= 4, the first four columns (beamE, eLoss, scale, s): lam
    (W, F+2), m (W, 4, F) and the three (W,) means of
    :class:`~.e0grid.CountsRates`.  From the kernel, the five are views of
    one buffer, lam first and contiguous."""
    if closure not in CLOSURES:
        raise ValueError(f"counts_rates: unknown moment closure {closure!r} "
                         f"(expected one of {CLOSURES})")
    if params.dim() != 2 or params.shape[1] < 4:
        raise ValueError("counts_rates: params must be (W, P) with P >= 4, "
                         f"got {tuple(params.shape)}")
    edges = grid.edges
    if params.dtype != edges.dtype:
        raise TypeError(f"counts_rates: params are {params.dtype}, the grid "
                        f"is {edges.dtype}")
    if params.device != edges.device:
        raise ValueError(f"counts_rates: params on {params.device}, the grid "
                         f"on {edges.device}")
    if params.device.type == "cpu":
        return counts_lambdas(grid, params[:, 0], params[:, 1], params[:, 2],
                              params[:, 3], n_samples, truncated, closure)
    if params.device.type != "cuda":
        raise ValueError(f"counts_rates: no kernel for {params.device}")
    if params.dtype != torch.float32:
        raise TypeError(f"counts_rates: the kernel takes float32, got "
                        f"{params.dtype}")
    if params.requires_grad:
        raise ValueError("counts_rates: the kernel has no gradient; the "
                         "gradient path is the 'expected' estimator")
    w, f = params.shape[0], grid.n_fine
    out = torch.empty(w * (5 * f + 5), dtype=torch.float32,
                      device=params.device)
    if w:
        # in float64 as the plain version's: the 'cell' closure's constants,
        # and 1 / t_scale (PyTorch's CUDA division by a Python number is a
        # product with the reciprocal, taken in float64)
        h = (grid.e0_hi - grid.e0_lo) / (grid.n_fine * grid.t_scale)
        check(load_library().lib.mcmctof_counts_rates(
            params.data_ptr(), params.stride(0), params.stride(1),
            edges.data_ptr(), grid.t_edges.data_ptr(), out.data_ptr(), w, f,
            int(truncated), int(closure == "exact"), grid.t_ref,
            1.0 / grid.t_scale, grid.e0_lo, grid.e0_hi, float(n_samples),
            h * h / 12.0, 0.1 * h * h, params.device.index,
            current_stream_ptr(params.device)), "counts_rates kernel launch")
        counts_rates.launches += 1
    return rates_views(out, w, f)


counts_rates.launches = 0


def rates_views(buffer: torch.Tensor, n_walkers: int,
                n_fine: int) -> CountsRates:
    """The kernel's output, one buffer of W (5F + 5) floats, as
    :class:`~.e0grid.CountsRates` views: lam (W, F+2) first, then m
    (W, 4, F), then mean_below, mean_above and e0_mean_expected, (W,)
    each."""
    w, f = n_walkers, n_fine
    n_lam, n_m = w * (f + 2), w * 4 * f
    means = buffer[n_lam + n_m:].view(3, w)
    return CountsRates(buffer[:n_lam].view(w, f + 2),
                       buffer[n_lam:n_lam + n_m].view(w, 4, f),
                       means[0], means[1], means[2])
