"""The batched TOF forward model: the mc, counts and expected estimators.

Port of ``mcmctoffitting_tpu/models/forward.py``: ``grid_and_mean`` for
the three ``sampling`` modes, the three beam sources of the mc estimator
('lognorm', 'skewnorm', 'gaussian'), ``energy_weight_grid`` for every
pair of ``transport`` ('rk4', 'table') and ``xs_mode`` ('e0grid',
'taylor', 'exact') the JAX package runs, the cell attenuation,
``cell_tof_lattice`` (with or without the detector's half-length), the
three zero-degree stages ('segments', 'expo', 'none'), the per-run
background and ``tof_spectra_multi``.  The JAX package evaluates one
walker under ``vmap``; here every stage takes the whole batch, walkers
then runs, ``(W, R, ...)``.  The grid stage, by estimator:

  counts: closed-form Poisson rates of the F fine e0 cells
    (``ops/e0grid``); one Poisson launch for all (W, R, F+2) rates
    (kernel K1); counts -> fine-cell moments -> (M, Be) grid by one
    float32 matmul against the static A operator.
  expected: the closed-form fine-cell moments themselves, contracted with
    A: no draw, one grid and one e0 mean shared by every run.
  mc: N initial energies per (walker, run), drawn on the device
    (``ops/pdfs``; beamE - lognorm, a skew normal or a normal, by
    ``beam_source``); then by ``xs_mode``: 'e0grid', the per-sample
    fine-cell moments (``ops/e0grid.fine_cell_moments``) contracted with
    A; 'taylor', the moment histograms of the transported energies
    (kernel K4 on 'rk4', fused with the transport; the table lookup and
    the plain moment channels on 'table') contracted with the cross
    section's Taylor coefficients at the eD bin centres; 'exact', the
    transport (RK4 or table lookup), per-sample cross sections and a
    weighted histogram per (walker, run, x) (kernel K3).

Then, for all: the cell attenuation (oneBD), normalise, scale to
``n_samples`` draws, ``rint``; the TOF lattice of every (x, eD) cell,
histogrammed into each run's window (kernel K2: spread over the ten
zero-degree segments, or as it is, one segment, for 'expo' and 'none');
density normalisation, for 'expo' the causal exponential kernel and the
padding bins re-zeroed, the beam-timing convolution, run scale, and the
background (its expectation or one Poisson draw per bin, kernel K1) on
the real bins.

:class:`TofForward` holds the static tables as buffers on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..config import Binning, cell_attenuation_coeffs
from ..constants import CellGeometry, masses
from ..ops.cuda_hist import weighted_histogram
from ..ops.cuda_poisson import poisson
from ..ops.cuda_rates import counts_rates
from ..ops.cuda_tof import tof_hist_segments
from ..ops.cuda_transport import (MomentBins, energy_moments,
                                  transport_moments)
from ..ops.e0grid import (CountsRates, E0Grid, E0GridTable, contract,
                          expected_e0_mean, expected_grid, fine_cell_moments,
                          moments_from_counts)
from ..ops.histogram import WindowConstants, window_constants
from ..ops.interp import UniformCubicSpline1D, eval_uniform_spline
from ..ops.kinematics import dd_neutron_energy_np, tof, tof_np
from ..ops.pdfs import (beam_energies_from_uniforms, beam_energies_redrawn,
                        device_normals, draw_beam_uniforms,
                        skewnorm_from_normals)
from ..ops.poisson import launch_seed
from ..ops.stopping import (BetheStopping, StoppingTable,
                            bethe_closed_form_constants, eval_stopped,
                            rk4_constants, rk4_transport)
from ..ops.timing import (ExGaussianTiming, GaussianTiming,
                          ZeroDegreeTimingSpread, apply_same_matrix,
                          causal_conv_matrix, same_conv_matrix,
                          zero_degree_expo_kernel)
from ..ops.xs import ddn_xs_uniform
from ..utils.profiling import span

_SUPPORTED = {
    "sampling": ("counts", "mc", "expected"),
    "xs_mode": ("e0grid", "taylor", "exact"),
    "transport": ("table", "rk4"),
    "a_dtype": ("float32", "bfloat16"), "cell_attenuation": (False, True),
    "zero_degree": ("segments", "expo", "none"),
    "bg_mode": ("poisson", "expected"),
    "beam_source": ("lognorm", "skewnorm", "gaussian"),
    "moment_closure": ("exact", "cell"),
    "e0_mean_mode": ("sample", "expected"),
}
# (rows x M x samples) elements transported at once on the 'exact' path
_EXACT_CHUNK = 1 << 27


def exact_rows_per_chunk(n_x: int, n: int) -> int:
    """(walker, run) rows transported at once on the 'exact' path: at
    most ``_EXACT_CHUNK`` (row, x, sample) elements."""
    return max(1, _EXACT_CHUNK // (n_x * max(1, n)))


def k1_counters(walker_offset: int, walker_blocks, per_walker: int) -> dict:
    """K1's counter layout (``ops.cuda_poisson.poisson``'s ``offset`` and
    ``blocks``) for a draw of ``per_walker`` elements per walker from a
    batch that is a part of a larger walker batch: its walker i is walker
    ``walker_offset + i`` of that batch, or with ``walker_blocks = (m,
    n)`` (m walkers of each n, a shard of every rung of a tempered
    ensemble) walker ``walker_offset + (i // m) n + i % m``.  The draw
    then equals those rows of the larger batch's draw; offset 0 and no
    blocks are the whole batch's launch."""
    blocks = (None if walker_blocks is None
              else (walker_blocks[0] * per_walker,
                    walker_blocks[1] * per_walker))
    return {"offset": walker_offset * per_walker, "blocks": blocks}


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
    have no counterpart; an unknown value, and a combination the JAX
    package rejects, raise ``ValueError`` as it does.
    """

    geometry: CellGeometry
    ed_binning: Binning
    x_binning: Binning
    # the medium of the RK4 transport (mc with transport='rk4')
    stopping: Optional[BetheStopping] = None
    # cross section: weights of 'exact', Taylor coefficients of 'taylor'
    xs: UniformCubicSpline1D = ddn_xs_uniform
    # 'rk4': per-sample RK4 transport (the reference's ODE path);
    # 'table': the stopping-table surrogate, looked up per sample ('taylor',
    # 'exact') or read through the e0grid operator
    transport: str = "rk4"
    stopping_table: Optional[StoppingTable] = None
    rk4_substeps: int = 4
    beam_timing: Union[ExGaussianTiming, GaussianTiming] = ExGaussianTiming()
    # zero-degree detector transit: 'segments' (10-segment spread,
    # simultFit), 'expo' (7-tap exponential kernel, oneBD) or 'none'
    zero_degree: str = "segments"
    # multiply the grid's x slices by the exp(-x / 20 cm) beam attenuation
    cell_attenuation: bool = False
    # add the detector's half-length to the neutron flight path (the
    # v1-era models and the templates; simultFit dropped it)
    add_half_zero_deg: bool = False
    # the initial-energy law of mc (TofForward.sample_beam_energies):
    # 'lognorm' (beamE - lognorm, simultFit / oneBD), 'skewnorm' (the
    # ppcTools-era chains) or 'gaussian' (v2.5)
    beam_source: str = "lognorm"
    # per-run background: 'poisson' draws fresh counts per evaluation (the
    # reference), 'expected' adds the level itself
    bg_mode: str = "poisson"
    n_samples: int = 200_000
    # round the normalised (x, eD) grid to integer draw counts
    rint_draws: bool = True
    # -1: draws conditioned on e0 > 0 (the reference's redraw loop);
    # 0: no conditioning (one untruncated draw); k > 0: k redraw rounds of
    # the draws that are still <= 0 (lognorm)
    n_redraw_rounds: int = -1
    # mc: 'e0grid' (fine-cell moments x the A operator; transport='table'),
    # 'taylor' (moments x Taylor coefficients) or 'exact' (per-sample cross
    # sections); counts and expected: 'e0grid'
    xs_mode: str = "taylor"
    e0_grid_table: Optional[E0GridTable] = None
    e0_grid_fine: int = 1024
    # 'mc': N draws per eval (the reference's estimator); 'counts':
    # Poissonized Rao-Blackwell MC over the fine e0 cells; 'expected': the
    # closed-form moments, no draw (the N -> infinity limit)
    sampling: str = "mc"
    # which e0 mean feeds the TOF lattice: the per-eval 'sample' mean or
    # the closed-form 'expected' one
    e0_mean_mode: str = "sample"
    # within-cell moment closure of the counts and expected estimators:
    # 'exact' or 'cell'
    moment_closure: str = "exact"
    # 'bfloat16' rounds the A operator (not the moments) to bfloat16
    a_dtype: str = "float32"

    def __post_init__(self):
        for field, allowed in _SUPPORTED.items():
            value = getattr(self, field)
            if value in allowed:
                continue
            raise ValueError(f"unknown ForwardSpec.{field}={value!r} "
                             f"(expected one of {allowed})")
        if self.sampling != "mc" and self.xs_mode != "e0grid":
            raise ValueError(f"sampling={self.sampling!r} requires "
                             "xs_mode='e0grid'")
        if self.xs_mode == "e0grid" and self.transport != "table":
            raise ValueError("xs_mode='e0grid' requires transport='table' "
                             "(the preimages invert the stopping table)")
        if self.transport == "table" and self.stopping_table is None:
            raise ValueError("transport='table' requires stopping_table")
        if self.beam_source != "lognorm" and (
                self.sampling != "mc" or self.e0_mean_mode == "expected"):
            raise ValueError(
                f"sampling={self.sampling!r} with e0_mean_mode="
                f"{self.e0_mean_mode!r} requires the lognorm beam source")
        if self.sampling != "mc":
            return
        if self.transport == "rk4" and self.stopping is None:
            raise ValueError("transport='rk4' requires stopping")

    @property
    def truncated(self) -> bool:
        return self.n_redraw_rounds != 0

    def en_centers(self) -> np.ndarray:
        return dd_neutron_energy_np(self.ed_binning.centers)


def draw_beam(spec: ForwardSpec, shape, generator: torch.Generator,
              device) -> torch.Tensor:
    """The random input of :func:`beam_energies_from_draws` for initial
    energies of ``shape`` (W, R, N), float32 on ``device`` (seeded from the
    host ``generator``): 'lognorm' with ``n_redraw_rounds`` -1 or 0, the
    uniforms or normals of ``ops.pdfs.draw_beam_uniforms`` (``shape``);
    with k > 0 rounds, (1 + k, *shape) normals; 'skewnorm', (3, *shape)
    normals (the two of the skew normal, and the fallback's); 'gaussian',
    (1, *shape) normals."""
    if spec.beam_source == "lognorm" and spec.n_redraw_rounds <= 0:
        return draw_beam_uniforms(shape, spec.truncated, generator, device)
    sets = {"lognorm": 1 + spec.n_redraw_rounds, "skewnorm": 3,
            "gaussian": 1}[spec.beam_source]
    return device_normals((sets,) + tuple(shape), generator, device)


def beam_energies_from_draws(spec: ForwardSpec, u: torch.Tensor,
                             params: torch.Tensor) -> torch.Tensor:
    """Deterministic core of the beam draw: the draws of :func:`draw_beam`
    and params (W, 4) -> initial energies (W, ...).

    * 'lognorm': params (beamE, eLoss, scale, s); e0 = beamE - lognorm(s,
      loc=eLoss, scale), truncated, drawn once, or redrawn
      ``n_redraw_rounds`` times (``ops/pdfs``).
    * 'skewnorm': params (e0, sigma0, skew0, ...); a skew normal with
      a = skew0, loc = e0, scale = e0 sigma0 (the Azzalini construction
      of ``ops.pdfs.skewnorm_from_normals`` on the first two sets), and
      where e0 sigma0 <= 0 the reference's fallback, a normal of scale 1
      around e0 on the third (``utilities/ppcTools.py:213-217``).
    * 'gaussian': params (e0, sigma0, ...); e0 + e0 sigma0 z.
    """
    p = [params[:, k] for k in range(4)]
    if spec.beam_source == "lognorm":
        if spec.n_redraw_rounds > 0:
            return beam_energies_redrawn(u, *p)
        return beam_energies_from_uniforms(u, *p, spec.truncated)
    lead = (slice(None),) + (None,) * (u.dim() - 2)
    e0, sigma0 = p[0][lead], p[1][lead]
    if spec.beam_source == "gaussian":
        return e0 + e0 * sigma0 * u[0]
    scale = e0 * sigma0
    safe = torch.where(scale > 0, scale, 1.0)
    sn = skewnorm_from_normals(u[0], u[1], p[2][lead], e0, safe)
    return torch.where(scale > 0, sn, e0 + safe * u[2])


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
    (:func:`forward_tables_from_numpy`).  ``xs_mode='e0grid'`` reads
    ``e0_grid``; the other two ``taylor`` and ``xs_coeffs``, and on
    ``transport='rk4'`` ``bethe``; ``zero_degree='expo'`` reads
    ``expo_kernel`` and, as 'none' does, a single segment (``zt`` zeros,
    ``zw`` ones).  The stopping table's spline is read from
    ``spec.stopping_table``.
    """

    timing_kernel: np.ndarray     # (T,) beam-timing taps
    zt: np.ndarray                # (Be, K) zero-degree segment times
    zw: np.ndarray                # (Be, K) zero-degree segment weights
    e0_grid: Optional[E0GridTable] = None
    taylor: Optional[np.ndarray] = None      # (4, Be)
    bethe: Optional[tuple] = None            # closed-form (A, P, Q)
    xs_coeffs: Optional[np.ndarray] = None   # (4, n_cells) of spec.xs
    expo_kernel: Optional[np.ndarray] = None  # (7,) zero-degree 'expo' taps


def forward_tables(spec: ForwardSpec) -> ForwardTables:
    """Tables of ``spec``, built by the port in numpy."""
    expo = None
    if spec.zero_degree == "segments":
        zd = ZeroDegreeTimingSpread(length=spec.geometry.zero_deg_length)
        zt, zw = zd.times_and_weights(spec.en_centers())
    else:
        # 'expo' and 'none' have no segments: the lattice is histogrammed
        # as it is
        zt = np.zeros((spec.ed_binning.n, 1), np.float32)
        zw = np.ones((spec.ed_binning.n, 1), np.float32)
        if spec.zero_degree == "expo":
            expo = zero_degree_expo_kernel()
    if spec.xs_mode == "e0grid" and spec.e0_grid_table is None:
        raise ValueError("xs_mode='e0grid' requires e0_grid_table "
                         "(ops.e0grid.build_e0_grid_table)")
    common = dict(timing_kernel=spec.beam_timing.kernel, zt=zt, zw=zw,
                  expo_kernel=expo)
    if spec.xs_mode == "e0grid":
        return ForwardTables(**common, e0_grid=spec.e0_grid_table)
    return ForwardTables(
        **common, taylor=taylor_coeffs(spec), xs_coeffs=spec.xs.coeffs,
        bethe=(bethe_closed_form_constants(spec.stopping)
               if spec.transport == "rk4" else None))


def forward_tables_from_numpy(*, timing_kernel, zt, zw, a_matrix=None,
                              e0_lo=None, e0_hi=None, n_fine=None,
                              t_ref=None, t_scale=None, n_x=None, n_ed=None,
                              ed_lo=None, ed_hi=None, taylor=None,
                              bethe=None, xs_coeffs=None,
                              expo_kernel=None) -> ForwardTables:
    """Forward tables from plain arrays, e.g. the JAX package's
    ``E0GridTable`` fields (counts), its ``_taylor_coeffs``, Bethe
    (A, P, Q) and cross-section spline coefficients (mc),
    the beam-timing kernel, the zero-degree ``(zt, zw)`` and the 'expo'
    kernel: a test can then tell "same tables" apart from "same forward
    arithmetic"."""
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
        None if xs_coeffs is None else np.asarray(xs_coeffs, np.float64),
        None if expo_kernel is None else np.asarray(expo_kernel, np.float64))


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


class TofForward(torch.nn.Module):
    """Forward of a set of runs on one device: (W, 4) beam parameters,
    (W, R) run scales and, for oneBD, (W, R) background levels ->
    (W, R, n_pad) model spectra.  ``device`` defaults to the GPU.

    Buffers, as the spec needs them: the e0-grid operator (``e0grid``),
    the Taylor coefficients (``taylor``), the cross-section spline
    (``xs_coeffs``), the stopping table's spline (``table_coeffs``), the
    attenuation per x slice (``atten``); then the x and eD bin centres,
    the neutron leg of every (run, x, eD) lattice cell, the zero-degree
    segment tables, the window constants (``win_*``), the 'expo' and
    beam-timing convolution matrices and the per-run padding mask.
    Building on a CUDA device turns TF32 off for matmuls: the JAX package
    pins full float32 precision (``precision='highest'``) on the
    contraction and the convolutions.
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
        eb = spec.ed_binning

        self.e0grid = None
        if spec.xs_mode == "e0grid":
            _validate_e0grid_table(spec, tables.e0_grid)
            self.e0grid = E0Grid(tables.e0_grid, device=device,
                                 a_dtype=spec.a_dtype)
        else:
            self.moment_bins = MomentBins(eb.lo, eb.hi, eb.n)
            self.register_buffer("taylor", _f32(tables.taylor, device))
            self.register_buffer("xs_coeffs", _f32(tables.xs_coeffs, device))
            if spec.transport == "rk4":
                self.rk4 = rk4_constants(
                    spec.stopping, spec.x_binning.centers, spec.rk4_substeps,
                    bethe=tables.bethe)
        if spec.transport == "table":
            # the lookup of 'taylor' and 'exact', and of ``transport`` on
            # every xs_mode (the PPC's transit times)
            self.register_buffer(
                "table_coeffs", spec.stopping_table.coeffs_tensor(device))
        if spec.cell_attenuation:
            self.register_buffer("atten", _f32(
                cell_attenuation_coeffs(spec.x_binning.centers), device))
        x = spec.x_binning.centers.astype(np.float32)
        self.register_buffer("x", _f32(x, device))                    # (M,)
        self.register_buffer("ed", _f32(eb.centers, device))
        # neutron leg of the lattice: static per run, (R, M, Be), in the
        # JAX package's float32 operation order (it sets TOF bin edges)
        en = spec.en_centers().astype(np.float32)
        n_dist = (np.float32(spec.geometry.cell_length) - x[None, :, None]
                  + np.asarray(standoffs, np.float32)[:, None, None])
        if spec.add_half_zero_deg:
            n_dist = n_dist + np.float32(spec.geometry.zero_deg_length / 2.0)
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
        if spec.zero_degree == "expo":
            self.register_buffer("expo", _f32(
                causal_conv_matrix(tables.expo_kernel, n_pad), device))
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

    def attenuate(self, grids: torch.Tensor) -> torch.Tensor:
        """The beam attenuation along the cell, per x slice of (..., M, Be)
        grids (``spec.cell_attenuation``; else the grids as they are)."""
        if self.spec.cell_attenuation:
            return grids * self.atten[:, None]
        return grids

    # --- the counts and expected estimators -----------------------------

    def counts_rates(self, params: torch.Tensor):
        """Poisson rates and conditional moments per walker: params
        (W, 4) = (beamE, eLoss, scale, s) -> ops.e0grid.CountsRates, from
        one kernel on the card (``ops/cuda_rates.py``)."""
        spec = self.spec
        return counts_rates(self.e0grid, params, spec.n_samples,
                            spec.truncated, spec.moment_closure)

    def _counts_grid_and_mean(self, params, generator, walker_offset=0,
                              walker_blocks=None):
        with span("mcmctof.rates"):
            rates = self.counts_rates(params)
        with span("mcmctof.k1_cells"):
            # every run of a walker draws from the walker's rates: the
            # kernel reads them once per run, no copy along the run axis
            per_walker = self.n_runs * rates.lam.shape[-1]
            counts = poisson(rates.lam, launch_seed(generator),
                             n_runs=self.n_runs,
                             **k1_counters(walker_offset, walker_blocks,
                                           per_walker))       # (W, R, F+2)
        with span("mcmctof.moments"):
            per_run = CountsRates(*(t[:, None] for t in rates))  # run axis
            moments, e0_means = moments_from_counts(self.e0grid, counts,
                                                    per_run)
        with span("mcmctof.contract"):
            grids = self.attenuate(contract(self.e0grid, moments))
        return grids, e0_means

    def _expected_grid_and_mean(self, params):
        """One closed-form grid and mean per walker, shared by its runs:
        ((W, 1, M, Be), (W, R))."""
        spec = self.spec
        with span("mcmctof.expected"):
            grid, e0_mean = expected_grid(
                self.e0grid, params[:, 0], params[:, 1], params[:, 2],
                params[:, 3], spec.n_samples, spec.truncated,
                spec.moment_closure)
            grid = self.attenuate(grid)
        return grid[:, None], e0_mean[:, None].expand(-1, self.n_runs)

    # --- the mc estimator -----------------------------------------------

    def sample_beam_energies(self, params: torch.Tensor,
                             generator: torch.Generator, *,
                             n_runs: Optional[int] = None,
                             n: Optional[int] = None) -> torch.Tensor:
        """N initial deuteron energies per walker and run, drawn on the
        params' device (seeded from the host ``generator``):
        (W, 4) -> (W, R, N).  ``n_runs`` and ``n`` override the forward's
        run count and ``spec.n_samples``."""
        shape = (params.shape[0], n_runs or self.n_runs,
                 n or self.spec.n_samples)
        return beam_energies_from_draws(
            self.spec, draw_beam(self.spec, shape, generator, params.device),
            params)

    def transport(self, e0: torch.Tensor) -> torch.Tensor:
        """Energies at the M depths, (..., N) -> (..., M, N): the RK4
        transport or the stopping-table lookup (``spec.transport``)."""
        if self.spec.transport == "rk4":
            return rk4_transport(self.rk4, e0)
        return eval_stopped(self.spec.stopping_table, e0, self.table_coeffs)

    def energy_weight_grid(self, e0: torch.Tensor) -> torch.Tensor:
        """Cross-section-weighted (x, eD) grids of initial energies,
        attenuation included: (..., N) -> (..., M, Be).

        'e0grid': the per-sample fine-cell moments (..., 4, F) (span
        ``mcmctof.fine_moments``), contracted with the A operator (span
        ``mcmctof.contract``, with the attenuation).  'taylor': the
        moment histograms (..., M, 4, Be) of the transported energies,
        from kernel K4 on the ODE path
        (span ``mcmctof.k4``) and from the table lookup and the plain
        moment channels on ``transport='table'`` (K4 fuses the RK4 and
        cannot take table energies), contracted with the Taylor
        coefficients over the channel axis (span ``mcmctof.taylor``, with
        the attenuation).  'exact': the transport, the cross section of every
        transported energy, and kernel K3 over the (..., M) rows; rows go
        in chunks of at most ``_EXACT_CHUNK`` (row, x, sample) elements,
        which bounds the peak memory of the transported energies (4.1 GB
        per half-step of the production fit unchunked).
        """
        spec = self.spec
        if spec.xs_mode == "e0grid":
            with span("mcmctof.fine_moments"):
                moments = fine_cell_moments(self.e0grid, e0)
            with span("mcmctof.contract"):
                return self.attenuate(contract(self.e0grid, moments))
        lead, n = e0.shape[:-1], e0.shape[-1]
        rows = e0.reshape(-1, n).contiguous()
        n_x, eb = spec.x_binning.n, spec.ed_binning
        if spec.xs_mode == "taylor":
            if spec.transport == "rk4":
                with span("mcmctof.k4"):
                    moments = transport_moments(rows, self.rk4,
                                                self.moment_bins)
            else:
                moments = energy_moments(self.transport, rows, n_x,
                                         self.moment_bins)
            with span("mcmctof.taylor"):
                grid = torch.sum(moments * self.taylor, dim=-2)
                return self.attenuate(grid.reshape(lead + (n_x, eb.n)))
        grid = torch.empty((rows.shape[0], n_x, eb.n), dtype=torch.float32,
                           device=rows.device)
        step = exact_rows_per_chunk(n_x, n)
        for start in range(0, rows.shape[0], step):
            e_at_x = self.transport(rows[start:start + step])
            w = eval_uniform_spline(spec.xs, e_at_x, self.xs_coeffs)
            grid[start:start + step] = weighted_histogram(
                e_at_x, eb.lo, eb.hi, eb.n, w)
        return self.attenuate(grid.reshape(lead + (n_x, eb.n)))

    def _mc_grid_and_mean(self, params, generator):
        with span("mcmctof.beam_draw"):
            e0 = self.sample_beam_energies(params, generator)  # (W, R, N)
        with span("mcmctof.energy_grid"):
            grids = self.energy_weight_grid(e0)
        return grids, torch.mean(e0, dim=-1)

    def lattice_e0_means(self, params: torch.Tensor,
                         sample_means: torch.Tensor) -> torch.Tensor:
        """The e0 means that feed the lattice, (W, R): the draws' sample
        means, or with ``e0_mean_mode='expected'`` the closed-form mean of
        each walker's law."""
        if self.spec.e0_mean_mode == "expected":
            return expected_e0_mean(
                params[:, 0], params[:, 1], params[:, 2], params[:, 3],
                self.spec.truncated)[:, None].expand_as(sample_means)
        return sample_means

    # --- shared stages --------------------------------------------------

    def grid_and_mean(self, params: torch.Tensor,
                      generator: torch.Generator, *, walker_offset: int = 0,
                      walker_blocks=None):
        """XS-weighted (x, eD) grids and e0 means of every walker and run:
        params (W, 4) -> ((W, R, M, Be), (W, R)).  Each run draws its own
        Poisson cell counts (counts) or initial energies (mc), seeded by
        the host ``generator``; 'expected' draws nothing, leaves
        ``generator`` alone and returns one grid per walker,
        (W, 1, M, Be), for all its runs.  ``walker_offset`` and
        ``walker_blocks`` place the walkers in a larger batch
        (:func:`k1_counters`): the counts then equal that batch's draws of
        the same rows.  The mc draw does not depend on them."""
        if self.spec.sampling == "expected":
            return self._expected_grid_and_mean(params)
        if self.spec.sampling == "counts":
            grids, e0_means = self._counts_grid_and_mean(
                params, generator, walker_offset, walker_blocks)
        else:
            grids, e0_means = self._mc_grid_and_mean(params, generator)
        return grids, self.lattice_e0_means(params, e0_means)

    def pdf_grid(self, grids: torch.Tensor) -> torch.Tensor:
        """Grids (..., M, Be) normalised to a density over the (x, eD)
        area."""
        return grids / (torch.sum(grids, dim=(-2, -1), keepdim=True)
                        * self.area)

    def lattice(self, grids: torch.Tensor, e0_means: torch.Tensor):
        """Draw counts and TOF of every (x, eD) lattice cell:
        ((W, R or 1, M, Be), (W, R)) -> (base_tof, draws), both
        (W, R, M, Be)."""
        draws = self.pdf_grid(grids) * self.spec.n_samples
        if self.spec.rint_draws:
            draws = torch.round(draws)
        base_tof = self.cell_tof_lattice(e0_means)
        return base_tof, draws.expand_as(base_tof).contiguous()

    def cell_tof_lattice(self, e0_means: torch.Tensor) -> torch.Tensor:
        """tof_d((e0_mean + eD)/2, x) + tof_n(eN, L - x + standoff):
        (W, R) -> (W, R, M, Be)."""
        eff_ed = (e0_means[..., None] + self.ed) / 2.0         # (W, R, Be)
        tof_d = tof(masses.deuteron, eff_ed[..., None, :], self.x[:, None])
        return tof_d + self.tof_n

    def background(self, bg_levels: torch.Tensor,
                   generator: torch.Generator, *, walker_offset: int = 0,
                   walker_blocks=None) -> torch.Tensor:
        """The per-run background of every bin, zero on the padding bins:
        levels (W, R) -> (W, R, n_pad).  'expected': the level itself.
        'poisson': one draw per bin (kernel K1, one launch), seeded by two
        words of the host ``generator``; a level <= 0 draws 0;
        ``walker_offset`` and ``walker_blocks`` as for
        :meth:`grid_and_mean`."""
        rates = bg_levels[..., None].expand(
            bg_levels.shape + (self.pad_mask.shape[-1],))
        if self.spec.bg_mode == "poisson":
            rates = poisson(rates.contiguous(), launch_seed(generator),
                            **k1_counters(walker_offset, walker_blocks,
                                          rates[0].numel()))
        return torch.where(self.pad_mask, rates, 0.0)

    def tof_histogram(self, base_tof: torch.Tensor,
                      draws: torch.Tensor) -> torch.Tensor:
        """The lattice histogrammed into each run's window (kernel K2):
        spread over the zero-degree segments, or as it is ('expo': one
        segment of time 0 and weight 1): -> (W, R, n_pad) sums."""
        return tof_hist_segments(base_tof, draws, self.zt, self.zw, self.win)

    def shape_spectra(self, hist: torch.Tensor, scales: torch.Tensor,
                      background: Optional[torch.Tensor] = None, *,
                      get_pdf: bool = True):
        """TOF sums (W, R, n_pad) -> model spectra: density normalisation
        (``get_pdf``; else the raw sums), for 'expo' the causal kernel and
        the padding bins re-zeroed, the beam-timing convolution, the run
        scales (W, R) and the ``background`` (W, R, n_pad) where there is
        one."""
        if get_pdf:
            hist = hist / (torch.sum(hist, dim=-1, keepdim=True)
                           * self.bin_widths)
        if self.spec.zero_degree == "expo":
            # the causal tail bleeds into the padding bins: re-zero them so
            # that the 'same' beam-timing convolution sees each run's own
            # boundary
            hist = torch.where(self.pad_mask,
                               apply_same_matrix(hist, self.expo), 0.0)
        hist = apply_same_matrix(hist, self.timing)
        out = torch.where(self.pad_mask, scales[..., None] * hist, 0.0)
        return out if background is None else out + background

    def spectra(self, base_tof: torch.Tensor, draws: torch.Tensor,
                scales: torch.Tensor,
                background: Optional[torch.Tensor] = None, *,
                get_pdf: bool = True):
        """TOF stage: lattice -> (W, R, n_pad) density spectra (``get_pdf``;
        else the raw TOF sums) times the run scales (W, R), plus the
        ``background`` (W, R, n_pad) where there is one; zero past each
        run's n_bins."""
        with span("mcmctof.k2"):
            hist = self.tof_histogram(base_tof, draws)
        with span("mcmctof.shape"):
            return self.shape_spectra(hist, scales, background,
                                      get_pdf=get_pdf)

    def tof_spectra_multi(self, params: torch.Tensor, scales: torch.Tensor,
                          generator: torch.Generator,
                          bg_levels: Optional[torch.Tensor] = None, *,
                          get_pdf: bool = True, return_spectra: bool = False,
                          walker_offset: int = 0, walker_blocks=None):
        """All runs of all walkers: beam parameters (W, 4), run scales
        (W, R) and background levels (W, R) or None -> (W, R, n_pad).  The
        host ``generator`` seeds first the grid's draw, then (only with a
        Poisson background) the background's; on counts it may be an
        ``ops.poisson.DeviceSeeds``, whose rows K1 reads in the same order
        (a captured log-prob, ``models/logp_graph.py``).
        ``get_pdf=False`` keeps the raw TOF sums (no density
        normalisation).  ``return_spectra`` returns the tuple (spectra,
        normalised (x, eD) grids (W, R or 1, M, Be), draw counts (W, R, M,
        Be)).  ``walker_offset`` (the index of the
        first walker in a larger batch) and ``walker_blocks``: see
        :func:`k1_counters`; the K1 draws are then those rows of the
        larger batch's."""
        grids, e0_means = self.grid_and_mean(params, generator,
                                             walker_offset=walker_offset,
                                             walker_blocks=walker_blocks)
        with span("mcmctof.lattice"):
            base_tof, draws = self.lattice(grids, e0_means)
        background = None
        if bg_levels is not None:
            with span("mcmctof.background"):
                background = self.background(
                    bg_levels, generator, walker_offset=walker_offset,
                    walker_blocks=walker_blocks)
        out = self.spectra(base_tof, draws, scales, background,
                           get_pdf=get_pdf)
        if return_spectra:
            return out, self.pdf_grid(grids), draws
        return out

    forward = tof_spectra_multi


def single_run_spectrum(forward: TofForward, generator: torch.Generator,
                        params, scale=1.0, bg_level=None, *,
                        get_pdf: bool = False, return_spectra: bool = False):
    """The spectrum of a one-run ``forward`` for every walker: ``params``
    (W, 4); ``scale`` and ``bg_level`` numbers or (W,) tensors.  Returns
    (W, n_bins), or with ``return_spectra`` the tuple (spectrum, normalised
    (x, eD) grid (W, M, Be), draw counts (W, M, Be))."""
    dev = forward.x.device
    params = torch.as_tensor(params, dtype=torch.float32, device=dev)

    def per_walker(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        return v.expand(params.shape[:1])[:, None]

    out = forward(params, per_walker(scale), generator,
                  None if bg_level is None else per_walker(bg_level),
                  get_pdf=get_pdf, return_spectra=return_spectra)
    n_bins = forward.windows[0].n_bins
    if return_spectra:
        spectra, grids, draws = out
        return spectra[:, 0, :n_bins], grids[:, 0], draws[:, 0]
    return out[:, 0, :n_bins]


def tof_spectrum(generator: torch.Generator, params, spec: ForwardSpec,
                 standoff: float, window, *, get_pdf: bool = False,
                 scale=1.0, bg_level=None, return_spectra: bool = False,
                 device="cuda", tables: Optional[ForwardTables] = None):
    """One run's model spectrum for every walker (the reference's
    ``generateModelData``; the JAX package's ``tof_spectrum`` with a
    leading walker axis).

    ``params`` (W, 4) = (beamE, eLoss, scale, s); ``scale`` and
    ``bg_level`` (the oneBD background: its expectation or one Poisson draw
    per bin, ``spec.bg_mode``) are numbers or (W,) tensors; ``get_pdf``
    density-normalises the TOF histogram before the timing convolution and
    the scale.  Returns (W, n_bins), or with ``return_spectra`` the tuple
    (spectrum, normalised (x, eD) grid (W, M, Be), draw counts (W, M,
    Be)).  Builds a one-run :class:`TofForward` on ``device`` (the GPU
    unless the caller asks for the CPU) and runs
    :func:`single_run_spectrum`; a caller that evaluates one run many
    times keeps its forward (``JointFitProblem.run_spectrum``).
    """
    fwd = TofForward(spec, (standoff,), (window,), device=device,
                     tables=tables)
    return single_run_spectrum(fwd, generator, params, scale, bg_level,
                               get_pdf=get_pdf,
                               return_spectra=return_spectra)
