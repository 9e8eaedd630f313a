"""Non-parametric template-fitting model (spectrum unfolding), batched.

Port of ``mcmctoffitting_tpu/models/templates.py`` (the reference's
``tests/devShapeTemplates.py``): 32 monoenergetic-slice TOF templates per
standoff (initial energies uniform over each 25 keV slice of [400, 1200]
keV), the model spectrum = scale x the coefficient-weighted sum of the
templates, a 35-dim theta (3 run scales, 32 template coefficients), the
wide-Gaussian likelihood, compound over 4 standoffs with the first run's
scale pinned to 1, and a box prior.

Template generation is ONE batched forward of all 4 x 32 (run, slice)
rows: the slices are the walker axis and the runs the run axis of one
:class:`models.forward.TofForward`, so the 128 rows of N uniform energies
go through kernel K4 once (RK4 through 100 x depths, moment histograms
over 150 eD bins: the depth-tiled kernel), then kernel K2 once, with one
segment (``zero_degree='none'``), on the 128 lattices, each with the
slice's lower bound as the e0 of the deuteron leg (as the reference
does).  The model build is a ``torch.matmul`` of the coefficients and the
templates (a plain product, outside any kernel in the JAX package too).
Templates cache to the JAX package's CSV, one ``repr(float)`` row per
(run, slice).
"""
from __future__ import annotations

import csv

import numpy as np
import torch

from ..config import Binning
from ..constants import TUNL_SSA_CSI, tof_windows
from ..ops.likelihoods import template_gaussian_loglike
from ..ops.pdfs import device_generator
from ..ops.stopping import d2_gas_stopping
from ..ops.timing import ExGaussianTiming
from .forward import ForwardSpec, TofForward, resolve_device

N_TEMPLATES = 32
TEMPLATE_E_RANGE = (400.0, 1200.0)
TEMPLATE_BOUNDS = np.linspace(*TEMPLATE_E_RANGE, N_TEMPLATES + 1)

RUN_LAYOUT = ("mid", "close", "close", "far")
SCALE_LIMS = ((0.8, 2.0), (0.25, 1.0), (1.3, 1.9))  # runs 2-4 (:350)
COEFF_LIM = (0.0, 25_000.0)


def default_spec(n_samples: int = 200_000) -> ForwardSpec:
    """devShapeTemplates binning: 150 eD bins over [200, 1700], 100 x
    bins, RK4 transport (4 substeps), no zero-degree spread, the detector's
    half-length kept."""
    return ForwardSpec(
        geometry=TUNL_SSA_CSI,
        ed_binning=Binning(200.0, 1700.0, 150),
        x_binning=Binning(0.0, TUNL_SSA_CSI.cell_length, 100),
        stopping=d2_gas_stopping(rho=8.565e-5),
        transport="rk4",
        beam_timing=ExGaussianTiming(),
        zero_degree="none",
        add_half_zero_deg=True,   # devShapeTemplates keeps the half-length
        n_samples=n_samples,
    )


def template_forward(spec: ForwardSpec, *, n_runs: int = 4,
                     device="cuda") -> TofForward:
    """The forward of the template runs: the standoffs and windows of
    ``RUN_LAYOUT[:n_runs]``."""
    names = RUN_LAYOUT[:n_runs]
    return TofForward(spec, tuple(spec.geometry.standoff(n) for n in names),
                      tuple(tof_windows[n] for n in names), device=device)


def templates_from_energies(forward: TofForward, e0: torch.Tensor,
                            e_lo: torch.Tensor) -> torch.Tensor:
    """Deterministic core of template generation: initial energies e0
    (S, R, N) of S slices in every run and the slices' lower bounds e_lo
    (S,) -> templates (S, R, n_pad), zero past each run's n_bins.

    Per (slice, run) row, as ``template_spectrum`` of the JAX package:
    the cross-section-weighted (x, eD) grid of the energies (kernel K4 on
    all S x R rows at once), normalised and rounded to N draws, the TOF
    lattice with e0 = the slice's lower bound, histogrammed into the run's
    window (kernel K2, one segment), density-normalised and convolved with
    the beam-timing response."""
    grids = forward.energy_weight_grid(e0)                  # (S, R, M, Be)
    base_tof, draws = forward.lattice(
        grids, e_lo[:, None].expand(e0.shape[:2]))
    ones = torch.ones(e0.shape[:2], dtype=torch.float32, device=e0.device)
    return forward.spectra(base_tof, draws, ones)


def template_spectrum(generator: torch.Generator, e_lo: float, e_hi: float,
                      spec: ForwardSpec, standoff: float, window, *,
                      device="cuda") -> torch.Tensor:
    """One monoenergetic-slice template (the reference's
    ``generateModelData`` of devShapeTemplates): N initial energies
    uniform over [e_lo, e_hi], the slice's lower bound as the e0 of the
    deuteron leg, density-normalised and beam-timing convolved: (n_bins,)
    on ``device`` (the GPU unless the caller asks for the CPU)."""
    device = resolve_device(device)
    forward = TofForward(spec, (standoff,), (window,), device=device)
    gen = device_generator(generator, device)
    u = torch.rand((1, 1, spec.n_samples), generator=gen, device=device)
    e0 = e_lo + u * (e_hi - e_lo)
    lo = torch.tensor([e_lo], dtype=torch.float32, device=device)
    return templates_from_energies(forward, e0, lo)[0, 0, :window.n_bins]


def draw_template_energies(spec: ForwardSpec, generator: torch.Generator,
                           n_runs: int, device):
    """(S = 32, R, N) initial energies uniform over each slice, and the
    slices' lower bounds (S,), on ``device`` from a generator there seeded
    by two words of the host ``generator``."""
    gen = device_generator(generator, torch.device(device))
    u = torch.rand((N_TEMPLATES, n_runs, spec.n_samples), generator=gen,
                   device=device)
    bounds = torch.as_tensor(TEMPLATE_BOUNDS, dtype=torch.float32,
                             device=device)
    e_lo, e_hi = bounds[:-1], bounds[1:]
    return (e_lo[:, None, None] + u * (e_hi - e_lo)[:, None, None],
            e_lo)


def generate_templates(generator: torch.Generator, spec: ForwardSpec, *,
                       n_runs: int = 4, device="cuda") -> list:
    """All (run, slice) templates in one batched forward: a list over
    runs of (32, n_bins) float32 numpy arrays.  ``device``: the GPU unless
    the caller asks for the CPU."""
    device = resolve_device(device)
    forward = template_forward(spec, n_runs=n_runs, device=device)
    e0, e_lo = draw_template_energies(spec, generator, n_runs, device)
    out = templates_from_energies(forward, e0, e_lo).cpu().numpy()
    return [out[:, r, :w.n_bins] for r, w in enumerate(forward.windows)]


def save_templates_csv(path: str, templates) -> None:
    """Reference-compatible CSV cache: one row per (run, slice) template
    (``tests/devShapeTemplates.py:410-424``), each value ``repr(float)``."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for run_templates in templates:
            for row in np.asarray(run_templates):
                w.writerow([repr(float(v)) for v in row])


def load_templates_csv(path: str, n_runs: int = 4) -> list:
    """Load the CSV cache (``tests/devShapeTemplates.py:426-450``): a list
    over runs of (32, n_bins) float64 arrays."""
    rows = []
    with open(path, newline="") as f:
        for line in csv.reader(f):
            rows.append(np.array([float(v) for v in line]))
    return [np.stack(rows[i * N_TEMPLATES: (i + 1) * N_TEMPLATES])
            for i in range(n_runs)]


def build_model_tof(scale, coeffs: torch.Tensor,
                    templates_run: torch.Tensor) -> torch.Tensor:
    """scale x (coeffs @ templates), ``buildModelTOF``: coefficients
    (..., 32) and one run's templates (32, n_bins) -> (..., n_bins)."""
    return scale * torch.matmul(coeffs, templates_run)


class TemplateFitProblem:
    """The 35-dim template unfolding fit over 4 standoffs, batched over
    walkers: thetas (W, 35) = (scales of runs 2-4, 32 coefficients).
    ``device``: the GPU unless the caller asks for the CPU."""

    def __init__(self, n_runs: int = 4, *, device="cuda"):
        self.n_runs = n_runs
        self.device = resolve_device(device)

    @property
    def n_dim(self) -> int:
        return 3 + N_TEMPLATES

    @property
    def windows(self):
        return tuple(tof_windows[n] for n in RUN_LAYOUT[: self.n_runs])

    def log_prob(self, thetas: torch.Tensor, observed, templates
                 ) -> torch.Tensor:
        """lnprob (``tests/devShapeTemplates.py:368-380``), (W, 35) ->
        (W,): run 1 has its scale pinned to 1, runs 2..4 use theta[0:3],
        the coefficients are theta[3:]; -inf outside the box prior
        (``:350-366``) and where the likelihood is NaN."""
        coeffs = thetas[:, 3:]
        ok = torch.all((coeffs >= COEFF_LIM[0]) & (coeffs <= COEFF_LIM[1]),
                       dim=-1)
        for i in range(min(3, self.n_runs - 1)):
            lo, hi = SCALE_LIMS[i]
            ok = ok & (thetas[:, i] >= lo) & (thetas[:, i] <= hi)
        total = torch.zeros(thetas.shape[0], dtype=thetas.dtype,
                            device=thetas.device)
        for run in range(self.n_runs):
            scale = 1.0 if run == 0 else thetas[:, run - 1:run]
            model = build_model_tof(scale, coeffs, templates[run])
            total = total + template_gaussian_loglike(model, observed[run])
        total = torch.where(torch.isnan(total), -torch.inf, total)
        return torch.where(ok, total, -torch.inf)

    def make_log_prob_fn(self, observed, templates):
        """Closure (thetas (W, 35), generator) -> (W,) for the sampler (the
        likelihood is deterministic: the generator is not used)."""
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        obs = tuple(f32(o) for o in observed)
        tmpl = tuple(f32(t) for t in templates)

        def logp(thetas, generator):
            del generator  # deterministic likelihood (templates are fixed)
            return self.log_prob(thetas, obs, tmpl)

        return logp

    def initial_guess_model(self) -> np.ndarray:
        """Gaussian-mixture kernel guess for the coefficients
        (``getGuessParams_model``, ``tests/devShapeTemplates.py:173-180``)."""
        centers = (TEMPLATE_BOUNDS[:-1] + TEMPLATE_BOUNDS[1:]) / 2
        width = (centers[1] - centers[0]) / 2.0

        def norm_pdf(x, loc, scale):
            return (np.exp(-((x - loc) / scale) ** 2 / 2)
                    / (scale * np.sqrt(2 * np.pi)))

        return 8 * (37_500 * norm_pdf(centers, 820.0, 75.0) * width
                    + 20_000 * norm_pdf(centers, 730.0, 125.0) * width)
