"""The batched TOF forward model: the counts and mc estimators.

Port of ``mcmctoffitting_tpu/models/forward.py``: ``grid_and_mean`` for
``sampling='counts'`` (``_e0grid_contract``) and for ``sampling='mc'`` on
the literal ODE path (``transport='rk4'``: ``sample_beam_energies``,
``energy_weight_grid`` with ``xs_mode`` 'taylor' or 'exact'), then
``cell_tof_lattice``, ``_zero_degree_spread``, the segments TOF stage and
``tof_spectra_multi``.  The JAX package evaluates one walker under
``vmap``; here every stage takes the whole batch, walkers then runs,
``(W, R, ...)``.  The grid stage, by estimator:

  counts: closed-form Poisson rates of the F fine e0 cells
    (``ops/e0grid``); one Poisson launch for all (W, R, F+2) rates
    (kernel K1); counts -> fine-cell moments -> (M, Be) grid by one
    float32 matmul against the static A operator.
  mc: N initial energies per (walker, run), drawn on the device
    (``ops/pdfs``); then for 'taylor' the fused RK4 transport + moment
    histograms (kernel K4) contracted with the cross section's Taylor
    coefficients at the eD bin centres, and for 'exact' the RK4 transport,
    per-sample cross sections and a weighted histogram per (walker, run,
    x) (kernel K3).

Then, for both: normalise, scale to ``n_samples`` draws, ``rint``; the TOF
lattice of every (x, eD) cell, spread over the zero-degree segments and
histogrammed into each run's window (kernel K2); density normalisation,
the exGaussian timing convolution, run scale.

:class:`TofForward` holds the static tables as buffers on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import Binning
from ..constants import CellGeometry, masses
from ..ops.cuda_hist import weighted_histogram
from ..ops.cuda_poisson import poisson
from ..ops.cuda_tof import tof_hist_segments
from ..ops.cuda_transport import MomentBins, transport_moments
from ..ops.e0grid import (CountsRates, E0Grid, E0GridTable, counts_lambdas,
                          expected_e0_mean, moments_from_counts)
from ..ops.histogram import WindowConstants, window_constants
from ..ops.interp import UniformCubicSpline1D, eval_uniform_spline
from ..ops.kinematics import dd_neutron_energy_np, tof, tof_np
from ..ops.pdfs import beam_energies_from_uniforms, draw_beam_uniforms
from ..ops.poisson import seed_words
from ..ops.stopping import (BetheStopping, StoppingTable,
                            bethe_closed_form_constants, rk4_constants,
                            rk4_transport)
from ..ops.timing import (ExGaussianTiming, ZeroDegreeTimingSpread,
                          apply_same_matrix, same_conv_matrix)
from ..ops.xs import ddn_xs_uniform

# where each value the port does not run yet arrives (ROADMAP.md Queue 1)
_NOT_YET = {
    ("sampling", "expected"): "slice 2",
    ("a_dtype", "bfloat16"): "slice 3",
    ("cell_attenuation", True): "slice 3",
    ("zero_degree", "expo"): "slice 3",
    ("zero_degree", "none"): "slice 5",
}
_SUPPORTED = {
    "sampling": ("counts", "mc"), "xs_mode": ("e0grid", "taylor", "exact"),
    "transport": ("table", "rk4"),
    "a_dtype": ("float32",), "cell_attenuation": (False,),
    "zero_degree": ("segments",), "moment_closure": ("exact", "cell"),
    "e0_mean_mode": ("sample", "expected"),
}
# (rows x M x samples) elements transported at once on the 'exact' path
_EXACT_CHUNK = 1 << 27


def exact_rows_per_chunk(n_x: int, n: int) -> int:
    """(walker, run) rows transported at once on the 'exact' path: at
    most ``_EXACT_CHUNK`` (row, x, sample) elements."""
    return max(1, _EXACT_CHUNK // (n_x * max(1, n)))


def not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mcmctoffitting_tpu_torch yet "
        f"(ROADMAP.md Queue 1, {slice_})")


def resolve_device(device) -> torch.device:
    """The device of an entry point: a CUDA device unless the caller asks
    for the CPU.  A CUDA device without a GPU is an error, never a silent
    fall back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "mcmctoffitting_tpu_torch runs on a CUDA GPU by default and "
            "none is available (torch.cuda.is_available() is False); pass "
            "device='cpu' to run the kernels' plain PyTorch versions on "
            "the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class ForwardSpec:
    """Static configuration of the forward model: the fields of the JAX
    package's ``ForwardSpec`` that change the result.  Fields that only
    chose a TPU/XLA schedule (``moment_radix``, ``tof_hist_radix``,
    ``run_axis``, ``histogram_chunk``, ``moment_dtype``, ``use_pallas``)
    have no counterpart; values the port does not run yet raise
    ``NotImplementedError`` naming the ROADMAP slice that adds them, and
    combinations the JAX package rejects raise ``ValueError`` as it does.
    """

    geometry: CellGeometry
    ed_binning: Binning
    x_binning: Binning
    # the medium of the RK4 transport (the mc path)
    stopping: Optional[BetheStopping] = None
    # cross section: weights of 'exact', Taylor coefficients of 'taylor'
    xs: UniformCubicSpline1D = ddn_xs_uniform
    # 'rk4': per-sample RK4 transport (the reference's ODE path);
    # 'table': the stopping-table surrogate (read through the e0grid)
    transport: str = "rk4"
    stopping_table: Optional[StoppingTable] = None
    rk4_substeps: int = 4
    beam_timing: ExGaussianTiming = ExGaussianTiming()
    # zero-degree detector transit: 'segments' (10-segment spread)
    zero_degree: str = "segments"
    cell_attenuation: bool = False
    n_samples: int = 200_000
    # round the normalised (x, eD) grid to integer draw counts
    rint_draws: bool = True
    # -1: draws conditioned on e0 > 0 (the reference's redraw loop);
    # 0: no conditioning (one untruncated draw)
    n_redraw_rounds: int = -1
    # mc: 'taylor' (moments x Taylor coefficients) or 'exact' (per-sample
    # cross sections); counts: 'e0grid'
    xs_mode: str = "taylor"
    e0_grid_table: Optional[E0GridTable] = None
    e0_grid_fine: int = 1024
    # 'mc': N draws per eval (the reference's estimator); 'counts':
    # Poissonized Rao-Blackwell MC over the fine e0 cells
    sampling: str = "mc"
    # which e0 mean feeds the TOF lattice: the per-eval 'sample' mean or
    # the closed-form 'expected' one
    e0_mean_mode: str = "sample"
    # within-cell moment closure of the counts estimator: 'exact' or 'cell'
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
        if self.sampling == "counts":
            if self.xs_mode != "e0grid":
                raise ValueError("sampling='counts' requires "
                                 "xs_mode='e0grid'")
            if self.transport != "table":
                raise ValueError("xs_mode='e0grid' requires "
                                 "transport='table' (the preimages invert "
                                 "the stopping table)")
            return
        if self.transport == "table":
            raise not_ported("sampling='mc' with transport='table' (the "
                             "e0grid and table-lookup mc paths)", "slice 2")
        if self.xs_mode == "e0grid":
            raise ValueError("xs_mode='e0grid' requires transport='table' "
                             "(the preimages invert the stopping table)")
        if self.stopping is None:
            raise ValueError("transport='rk4' requires stopping")
        if self.n_redraw_rounds > 0:
            raise not_ported(f"n_redraw_rounds={self.n_redraw_rounds} with "
                             "sampling='mc'", "slice 5")

    @property
    def truncated(self) -> bool:
        return self.n_redraw_rounds != 0

    def en_centers(self) -> np.ndarray:
        return dd_neutron_energy_np(self.ed_binning.centers)


def taylor_coeffs(spec: ForwardSpec) -> np.ndarray:
    """(4, Be) contraction constants: the cross section and its first
    three derivatives at the eD bin centres, times w, w^2/2 and w^3/6
    (the JAX package's ``forward.py::_taylor_coeffs``)."""
    eb = spec.ed_binning
    s0, s1, s2, s3 = spec.xs.eval_np(eb.centers, derivatives=True)
    w = eb.width
    return np.stack([s0, s1 * w, 0.5 * s2 * w * w,
                     (1.0 / 6.0) * s3 * w ** 3])


@dataclasses.dataclass(frozen=True)
class ForwardTables:
    """The host tables the forward reads (numpy).  Built by the port
    (:func:`forward_tables`) or converted from the JAX package's arrays
    (:func:`forward_tables_from_numpy`).  The counts estimator reads
    ``e0_grid``; the mc estimator ``taylor``, ``bethe`` and ``xs_coeffs``.
    """

    timing_kernel: np.ndarray     # (T,) exGaussian taps
    zt: np.ndarray                # (Be, K) zero-degree segment times
    zw: np.ndarray                # (Be, K) zero-degree segment weights
    e0_grid: Optional[E0GridTable] = None
    taylor: Optional[np.ndarray] = None      # (4, Be)
    bethe: Optional[tuple] = None            # closed-form (A, P, Q)
    xs_coeffs: Optional[np.ndarray] = None   # (4, n_cells) of spec.xs


def forward_tables(spec: ForwardSpec) -> ForwardTables:
    """Tables of ``spec``, built by the port in numpy."""
    zd = ZeroDegreeTimingSpread(length=spec.geometry.zero_deg_length)
    zt, zw = zd.times_and_weights(spec.en_centers())
    common = dict(timing_kernel=spec.beam_timing.kernel, zt=zt, zw=zw)
    if spec.sampling == "counts":
        if spec.e0_grid_table is None:
            raise ValueError("xs_mode='e0grid' requires e0_grid_table "
                             "(ops.e0grid.build_e0_grid_table)")
        return ForwardTables(**common, e0_grid=spec.e0_grid_table)
    return ForwardTables(**common, taylor=taylor_coeffs(spec),
                         bethe=bethe_closed_form_constants(spec.stopping),
                         xs_coeffs=spec.xs.coeffs)


def forward_tables_from_numpy(*, timing_kernel, zt, zw, a_matrix=None,
                              e0_lo=None, e0_hi=None, n_fine=None,
                              t_ref=None, t_scale=None, n_x=None, n_ed=None,
                              ed_lo=None, ed_hi=None, taylor=None,
                              bethe=None, xs_coeffs=None) -> ForwardTables:
    """Forward tables from plain arrays, e.g. the JAX package's
    ``E0GridTable`` fields (counts), its ``_taylor_coeffs``, Bethe
    (A, P, Q) and cross-section spline coefficients (mc),
    ``ExGaussianTiming().kernel`` and the zero-degree ``(zt, zw)``: a test
    can then tell "same tables" apart from "same forward arithmetic"."""
    grid = None
    if a_matrix is not None:
        grid = E0GridTable(float(e0_lo), float(e0_hi), int(n_fine),
                           float(t_ref), float(t_scale),
                           np.asarray(a_matrix, np.float32), int(n_x),
                           int(n_ed), float(ed_lo), float(ed_hi))
    return ForwardTables(
        np.asarray(timing_kernel, np.float64), np.asarray(zt),
        np.asarray(zw), grid,
        None if taylor is None else np.asarray(taylor, np.float64),
        None if bethe is None else tuple(float(v) for v in bethe),
        None if xs_coeffs is None else np.asarray(xs_coeffs, np.float64))


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
    """Forward of a set of runs on one device: (W, 4 + R) thetas ->
    (W, R, n_pad) model spectra.  ``device`` defaults to the GPU.

    Buffers: for the counts estimator the e0-grid operator (``e0grid``),
    for the mc estimator the Taylor coefficients (``taylor``) and the
    cross-section spline (``xs_coeffs``); then the x and eD bin centres,
    the neutron leg of every (run, x, eD) lattice cell, the zero-degree
    segment tables, the window constants (``win_*``), the
    timing-convolution matrix and the per-run padding mask.  Building on a
    CUDA device turns TF32 off for matmuls: the JAX package pins full
    float32 precision (``precision='highest'``) on the contraction and the
    convolution.
    """

    def __init__(self, spec: ForwardSpec, standoffs, windows, *,
                 device="cuda", tables: Optional[ForwardTables] = None):
        super().__init__()
        device = resolve_device(device)
        tables = forward_tables(spec) if tables is None else tables
        if device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.spec = spec
        self.windows = tuple(windows)
        self.n_runs = len(self.windows)
        if len(standoffs) != self.n_runs:
            raise ValueError("one standoff per window")
        self.area = spec.ed_binning.width * spec.x_binning.width

        if spec.sampling == "counts":
            if spec.stopping_table is None:
                raise ValueError("the e0grid operator inverts the stopping "
                                 "table: spec.stopping_table is required")
            _validate_e0grid_table(spec, tables.e0_grid)
            self.e0grid = E0Grid(tables.e0_grid, device=device)
        else:
            eb = spec.ed_binning
            self.e0grid = None
            self.rk4 = rk4_constants(spec.stopping, spec.x_binning.centers,
                                     spec.rk4_substeps, bethe=tables.bethe)
            self.moment_bins = MomentBins(eb.lo, eb.hi, eb.n)
            self.register_buffer("taylor", _f32(tables.taylor, device))
            self.register_buffer("xs_coeffs", _f32(tables.xs_coeffs, device))
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

    # --- the counts estimator -------------------------------------------

    def counts_rates(self, params: torch.Tensor):
        """Poisson rates and conditional moments per walker: params
        (W, 4) = (beamE, eLoss, scale, s) -> ops.e0grid.CountsRates."""
        spec = self.spec
        return counts_lambdas(self.e0grid, params[:, 0], params[:, 1],
                              params[:, 2], params[:, 3], spec.n_samples,
                              spec.truncated, spec.moment_closure)

    def _counts_grid_and_mean(self, params, generator):
        rates = self.counts_rates(params)
        # every run of a walker draws from the walker's rates: the kernel
        # reads them once per run, no copy along the run axis
        counts = poisson(rates.lam, seed_words(generator),
                         n_runs=self.n_runs)                  # (W, R, F+2)
        per_run = CountsRates(*(t[:, None] for t in rates))  # run axis
        moments, e0_means = moments_from_counts(self.e0grid, counts, per_run)
        return _e0grid_contract(self.e0grid, moments), e0_means

    # --- the mc estimator -----------------------------------------------

    def sample_beam_energies(self, params: torch.Tensor,
                             generator: torch.Generator) -> torch.Tensor:
        """N initial deuteron energies per walker and run, drawn on the
        params' device (seeded from the host ``generator``):
        (W, 4) -> (W, R, N)."""
        spec = self.spec
        u = draw_beam_uniforms((params.shape[0], self.n_runs,
                                spec.n_samples), spec.truncated, generator,
                               params.device)
        return beam_energies_from_uniforms(u, params[:, 0], params[:, 1],
                                           params[:, 2], params[:, 3],
                                           spec.truncated)

    def energy_weight_grid(self, e0: torch.Tensor) -> torch.Tensor:
        """Cross-section-weighted (x, eD) grids of initial energies:
        (..., N) -> (..., M, Be).

        'taylor': kernel K4's moments (..., M, 4, Be), contracted with the
        Taylor coefficients over the channel axis.  'exact': RK4 transport,
        the cross section of every transported energy, and kernel K3 over
        the (..., M) rows; rows go in chunks of at most ``_EXACT_CHUNK``
        (row, x, sample) elements, which bounds the peak memory of the
        transported energies (4.1 GB per half-step of the production fit
        unchunked).
        """
        lead, n = e0.shape[:-1], e0.shape[-1]
        rows = e0.reshape(-1, n).contiguous()
        n_x, eb = len(self.rk4.h), self.spec.ed_binning
        if self.spec.xs_mode == "taylor":
            moments = transport_moments(rows, self.rk4, self.moment_bins)
            grid = torch.sum(moments * self.taylor, dim=-2)
        else:
            grid = torch.empty((rows.shape[0], n_x, eb.n),
                               dtype=torch.float32, device=rows.device)
            step = exact_rows_per_chunk(n_x, n)
            for start in range(0, rows.shape[0], step):
                e_at_x = rk4_transport(self.rk4, rows[start:start + step])
                w = eval_uniform_spline(self.spec.xs, e_at_x,
                                        self.xs_coeffs)
                grid[start:start + step] = weighted_histogram(
                    e_at_x, eb.lo, eb.hi, eb.n, w)
        return grid.reshape(lead + (n_x, eb.n))

    def _mc_grid_and_mean(self, params, generator):
        e0 = self.sample_beam_energies(params, generator)    # (W, R, N)
        return self.energy_weight_grid(e0), torch.mean(e0, dim=-1)

    # --- shared stages --------------------------------------------------

    def grid_and_mean(self, params: torch.Tensor,
                      generator: torch.Generator):
        """XS-weighted (x, eD) grids and e0 means of every walker and run:
        params (W, 4) -> ((W, R, M, Be), (W, R)).  Each run draws its own
        Poisson cell counts (counts) or initial energies (mc);
        ``generator`` (host) seeds the draw."""
        if self.spec.sampling == "counts":
            grids, e0_means = self._counts_grid_and_mean(params, generator)
        else:
            grids, e0_means = self._mc_grid_and_mean(params, generator)
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
        hist = tof_hist_segments(base_tof, draws, self.zt, self.zw, self.win)
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
