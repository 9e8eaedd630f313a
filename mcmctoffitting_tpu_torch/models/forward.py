"""The batched counts-mode TOF forward model.

Port of the counts branch of ``mcmctoffitting_tpu/models/forward.py``
(``grid_and_mean``, ``_e0grid_contract``, ``cell_tof_lattice``,
``_zero_degree_spread``, the segments TOF stage and ``tof_spectra_multi``).
The JAX package evaluates one walker under ``vmap``; here every stage takes
the whole batch, walkers then runs, ``(W, R, ...)``:

  1. closed-form Poisson rates of the F fine e0 cells (``ops/e0grid``);
  2. one Poisson launch for all (W, R, F+2) rates (kernel K1);
  3. counts -> fine-cell moments -> (M, Be) grid by one float32 matmul
     against the static A operator;
  4. normalise, scale to ``n_samples`` draws, ``rint``;
  5. the TOF lattice of every (x, eD) cell, spread over the zero-degree
     segments and histogrammed into each run's window (kernel K2);
  6. density normalisation, the exGaussian timing convolution, run scale.

:class:`TofForward` holds the static tables as buffers on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mcmctoffitting_tpu.config import Binning
from mcmctoffitting_tpu.constants import CellGeometry, masses

from ..ops.cuda_poisson import poisson
from ..ops.cuda_tof import tof_hist_segments
from ..ops.e0grid import (CountsRates, E0Grid, E0GridTable, counts_lambdas,
                          expected_e0_mean, moments_from_counts)
from ..ops.histogram import WindowConstants, window_constants
from ..ops.kinematics import dd_neutron_energy_np, tof, tof_np
from ..ops.poisson import seed_words
from ..ops.stopping import StoppingTable
from ..ops.timing import (ExGaussianTiming, ZeroDegreeTimingSpread,
                          apply_same_matrix, same_conv_matrix)

# where each value the port does not run yet arrives (ROADMAP.md Queue 1)
_NOT_YET = {
    ("sampling", "mc"): "slice 2",
    ("sampling", "expected"): "slice 2",
    ("xs_mode", "taylor"): "slice 5",
    ("xs_mode", "exact"): "slice 5",
    ("a_dtype", "bfloat16"): "slice 3",
    ("cell_attenuation", True): "slice 3",
    ("zero_degree", "expo"): "slice 3",
    ("zero_degree", "none"): "slice 5",
}
_SUPPORTED = {
    "sampling": ("counts",), "xs_mode": ("e0grid",),
    "a_dtype": ("float32",), "cell_attenuation": (False,),
    "zero_degree": ("segments",), "moment_closure": ("exact", "cell"),
    "e0_mean_mode": ("sample", "expected"),
}


def not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mcmctoffitting_tpu_torch yet "
        f"(ROADMAP.md Queue 1, {slice_})")


@dataclasses.dataclass(frozen=True)
class ForwardSpec:
    """Static configuration of the forward model: the fields of the JAX
    package's ``ForwardSpec`` that change the result.  Fields that only
    chose a TPU/XLA schedule (``moment_radix``, ``tof_hist_radix``,
    ``run_axis``, ``histogram_chunk``, ``moment_dtype``, ``use_pallas``)
    have no counterpart; values the port does not run yet raise
    ``NotImplementedError`` naming the ROADMAP slice that adds them.
    """

    geometry: CellGeometry
    ed_binning: Binning
    x_binning: Binning
    stopping_table: Optional[StoppingTable] = None
    beam_timing: ExGaussianTiming = ExGaussianTiming()
    # zero-degree detector transit: 'segments' (10-segment spread)
    zero_degree: str = "segments"
    cell_attenuation: bool = False
    n_samples: int = 200_000
    # round the normalised (x, eD) grid to integer draw counts
    rint_draws: bool = True
    # -1: draws conditioned on e0 > 0 (the reference's redraw loop);
    # 0: no conditioning — only the sign matters to the closed forms
    n_redraw_rounds: int = -1
    xs_mode: str = "taylor"
    e0_grid_table: Optional[E0GridTable] = None
    e0_grid_fine: int = 1024
    # 'counts': Poissonized Rao-Blackwell MC over the fine e0 cells
    sampling: str = "mc"
    # which e0 mean feeds the TOF lattice: the per-eval 'sample' mean or
    # the closed-form 'expected' one
    e0_mean_mode: str = "sample"
    # within-cell moment closure: 'exact' or 'cell'
    moment_closure: str = "exact"
    a_dtype: str = "float32"

    def __post_init__(self):
        for field, allowed in _SUPPORTED.items():
            value = getattr(self, field)
            if value in allowed:
                continue
            if (field, value) in _NOT_YET:
                raise not_ported(f"ForwardSpec.{field}={value!r}",
                                 _NOT_YET[(field, value)])
            raise ValueError(f"unknown ForwardSpec.{field}={value!r} "
                             f"(expected one of {allowed})")

    @property
    def truncated(self) -> bool:
        return self.n_redraw_rounds != 0

    def en_centers(self) -> np.ndarray:
        return dd_neutron_energy_np(self.ed_binning.centers)


@dataclasses.dataclass(frozen=True)
class ForwardTables:
    """The host tables the forward reads (numpy).  Built by the port
    (:func:`forward_tables`) or converted from the JAX package's arrays
    (:func:`forward_tables_from_numpy`)."""

    e0_grid: E0GridTable
    timing_kernel: np.ndarray     # (T,) exGaussian taps
    zt: np.ndarray                # (Be, K) zero-degree segment times
    zw: np.ndarray                # (Be, K) zero-degree segment weights


def forward_tables(spec: ForwardSpec) -> ForwardTables:
    """Tables of ``spec``, built by the port in numpy."""
    tab = spec.e0_grid_table
    if tab is None:
        raise ValueError("xs_mode='e0grid' requires e0_grid_table "
                         "(ops.e0grid.build_e0_grid_table)")
    zd = ZeroDegreeTimingSpread(length=spec.geometry.zero_deg_length)
    zt, zw = zd.times_and_weights(spec.en_centers())
    return ForwardTables(tab, spec.beam_timing.kernel, zt, zw)


def forward_tables_from_numpy(*, a_matrix, e0_lo, e0_hi, n_fine, t_ref,
                              t_scale, n_x, n_ed, ed_lo, ed_hi,
                              timing_kernel, zt, zw) -> ForwardTables:
    """Forward tables from plain arrays, e.g. the JAX package's
    ``E0GridTable`` fields, ``ExGaussianTiming().kernel`` and the
    zero-degree ``(zt, zw)``: a test can then tell "same tables" apart
    from "same forward arithmetic"."""
    grid = E0GridTable(float(e0_lo), float(e0_hi), int(n_fine),
                       float(t_ref), float(t_scale),
                       np.asarray(a_matrix, np.float32), int(n_x),
                       int(n_ed), float(ed_lo), float(ed_hi))
    return ForwardTables(grid, np.asarray(timing_kernel, np.float64),
                         np.asarray(zt), np.asarray(zw))


def _validate_e0grid_table(spec: ForwardSpec, tab: E0GridTable) -> None:
    """Reject an operator compiled for other binnings (matching shapes
    would silently attribute every bin's weight to shifted energies)."""
    eb, xb = spec.ed_binning, spec.x_binning
    if (tab.n_x != xb.n or tab.n_ed != eb.n or tab.ed_lo != eb.lo
            or tab.ed_hi != eb.hi):
        raise ValueError(
            f"e0_grid_table was built for a ({tab.n_x} x, {tab.n_ed} eD, "
            f"[{tab.ed_lo}, {tab.ed_hi}] keV) grid; spec has ({xb.n} x, "
            f"{eb.n} eD, [{eb.lo}, {eb.hi}] keV)")


def _f32(array, device):
    return torch.as_tensor(np.array(array, np.float32), device=device)


def _e0grid_contract(grid: E0Grid, moments: torch.Tensor) -> torch.Tensor:
    """(..., 4, F) fine-cell moments -> (..., M, Be) grid: one float32
    matmul (W*R, 4F) @ (4F, M*Be) against the static A operator."""
    lead = moments.shape[:-2]
    flat = moments.reshape(-1, 4 * grid.n_fine)
    return (flat @ grid.a_matrix).reshape(lead + (grid.n_x, grid.n_ed))


class TofForward(torch.nn.Module):
    """Counts-mode forward of a set of runs on one device:
    (W, 4 + R) thetas -> (W, R, n_pad) model spectra.

    Buffers: the e0-grid operator (``e0grid``), x and eD bin centres, the
    neutron leg of every (run, x, eD) lattice cell, the zero-degree
    segment tables, the window constants (``win_*``), the
    timing-convolution matrix and the per-run padding mask.  Building on a
    CUDA device turns TF32 off for matmuls: the JAX package pins full
    float32 precision (``precision='highest'``) on the contraction and the
    convolution.
    """

    def __init__(self, spec: ForwardSpec, standoffs, windows, *, device,
                 tables: Optional[ForwardTables] = None):
        super().__init__()
        if spec.stopping_table is None:
            raise ValueError("the e0grid operator inverts the stopping "
                             "table: spec.stopping_table is required")
        tables = forward_tables(spec) if tables is None else tables
        _validate_e0grid_table(spec, tables.e0_grid)
        device = torch.device(device)
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.spec = spec
        self.windows = tuple(windows)
        self.n_runs = len(self.windows)
        if len(standoffs) != self.n_runs:
            raise ValueError("one standoff per window")
        self.area = spec.ed_binning.width * spec.x_binning.width

        self.e0grid = E0Grid(tables.e0_grid, device=device)
        x = spec.x_binning.centers.astype(np.float32)
        self.register_buffer("x", _f32(x, device))                    # (M,)
        self.register_buffer("ed", _f32(spec.ed_binning.centers, device))
        # neutron leg of the lattice: static per run, (R, M, Be), in the
        # JAX package's float32 operation order (it sets TOF bin edges)
        en = spec.en_centers().astype(np.float32)
        n_dist = (np.float32(spec.geometry.cell_length) - x[None, :, None]
                  + np.asarray(standoffs, np.float32)[:, None, None])
        self.register_buffer("tof_n", _f32(
            tof_np(masses.neutron, en[None, None, :], n_dist), device))
        self.register_buffer("zt", _f32(tables.zt, device))           # (Be, K)
        self.register_buffer("zw", _f32(tables.zw, device))
        win = window_constants(self.windows, device=device)
        for name in ("lo", "hi", "scale", "nb1"):
            self.register_buffer(f"win_{name}", getattr(win, name))  # (R,)
        n_pad = win.n_pad
        self.register_buffer("bin_widths", _f32(
            [[(w.hi - w.lo) / w.n_bins] for w in self.windows], device))
        self.register_buffer("timing", _f32(
            same_conv_matrix(tables.timing_kernel, n_pad), device))
        self.register_buffer("pad_mask", torch.as_tensor(
            np.arange(n_pad)[None, :]
            < np.asarray([w.n_bins for w in self.windows])[:, None],
            device=device))                                   # (R, n_pad)

    @property
    def win(self) -> WindowConstants:
        """The runs' TOF window constants (buffers) for the K2 histogram."""
        return WindowConstants(self.win_lo, self.win_hi, self.win_scale,
                               self.win_nb1, self.pad_mask.shape[-1])

    def counts_rates(self, params: torch.Tensor):
        """Poisson rates and conditional moments per walker: params
        (W, 4) = (beamE, eLoss, scale, s) -> ops.e0grid.CountsRates."""
        spec = self.spec
        return counts_lambdas(self.e0grid, params[:, 0], params[:, 1],
                              params[:, 2], params[:, 3], spec.n_samples,
                              spec.truncated, spec.moment_closure)

    def grid_and_mean(self, params: torch.Tensor,
                      generator: torch.Generator):
        """XS-weighted (x, eD) grids and e0 means of every walker and run:
        params (W, 4) -> ((W, R, M, Be), (W, R)).  Each run draws its own
        Poisson cell counts; ``generator`` (host) seeds the draw."""
        rates = self.counts_rates(params)
        n_walkers = params.shape[0]
        lam = rates.lam[:, None, :].expand(
            n_walkers, self.n_runs, rates.lam.shape[-1]).contiguous()
        counts = poisson(lam, seed_words(generator))          # (W, R, F+2)
        per_run = CountsRates(*(t[:, None] for t in rates))  # run axis
        moments, e0_means = moments_from_counts(self.e0grid, counts, per_run)
        grids = _e0grid_contract(self.e0grid, moments)
        if self.spec.e0_mean_mode == "expected":
            e0_means = expected_e0_mean(
                params[:, 0], params[:, 1], params[:, 2], params[:, 3],
                self.spec.truncated)[:, None].expand_as(e0_means)
        return grids, e0_means

    def lattice(self, grids: torch.Tensor, e0_means: torch.Tensor):
        """Draw counts and TOF of every (x, eD) lattice cell:
        ((W, R, M, Be), (W, R)) -> (base_tof, draws), both (W, R, M, Be)."""
        grids = grids / (torch.sum(grids, dim=(-2, -1), keepdim=True)
                         * self.area)
        draws = grids * self.spec.n_samples
        if self.spec.rint_draws:
            draws = torch.round(draws)
        return self.cell_tof_lattice(e0_means), draws

    def cell_tof_lattice(self, e0_means: torch.Tensor) -> torch.Tensor:
        """tof_d((e0_mean + eD)/2, x) + tof_n(eN, L - x + standoff):
        (W, R) -> (W, R, M, Be)."""
        eff_ed = (e0_means[..., None] + self.ed) / 2.0         # (W, R, Be)
        tof_d = tof(masses.deuteron, eff_ed[..., None, :], self.x[:, None])
        return tof_d + self.tof_n

    def spectra(self, base_tof: torch.Tensor, draws: torch.Tensor,
                scales: torch.Tensor):
        """TOF stage: lattice -> (W, R, n_pad) density spectra times the
        run scales (W, R), zero past each run's n_bins."""
        hist = tof_hist_segments(base_tof.contiguous(), draws.contiguous(),
                                 self.zt, self.zw, self.win)
        hist = hist / (torch.sum(hist, dim=-1, keepdim=True)
                       * self.bin_widths)
        hist = apply_same_matrix(hist, self.timing)
        return torch.where(self.pad_mask, scales[..., None] * hist, 0.0)

    def tof_spectra_multi(self, thetas: torch.Tensor,
                          generator: torch.Generator,
                          bg_levels=None) -> torch.Tensor:
        """All runs of all walkers: thetas (W, 4 + R) -> (W, R, n_pad)."""
        if bg_levels is not None:
            raise not_ported("the Poisson/expected background", "slice 3")
        grids, e0_means = self.grid_and_mean(thetas[:, :4], generator)
        base_tof, draws = self.lattice(grids, e0_means)
        return self.spectra(base_tof, draws, thetas[:, 4:4 + self.n_runs])

    forward = tof_spectra_multi
