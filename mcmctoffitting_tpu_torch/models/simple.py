"""The "simple" model family (the historical models v0-v2.5), batched.

Port of ``mcmctoffitting_tpu/models/simple.py``:

* v0 (``tests/simpleTOFmodel.py``): E(x) = E0 + E1 x, fixed sigma, 3
  params;
* v1 (``tests/simpleTOFfit.py``): cubic E(x), fixed sigma, 5 params;
* v2 (``tests/intermediateTOFfit.py``): cubic E(x), a fractional sigma
  growing linearly with x, DDN cross-section weights and the beam-timing
  convolution, 6 params;
* v2.5 (``tests/intermediateTOFmodel.py``): E0 ~ N(e0, e0 sigma0)
  transported through the gas by RK4, 2 params.

Every walker draws N (x, E_d) samples, their TOF in closed form, and one
weighted histogram of its samples is its model pdf: the sample axis is
the histogram axis (no (x, eD) lattice).  Batch-native: thetas (W, D),
samples (W, N), and the histogram of all W rows is ONE launch of kernel
K3 (``ops/cuda_hist.py``) per log-prob evaluation; v0 and v1 have no
cross-section weights and pass a weights tensor of ones.  v2.5's
transport is ``ops/stopping.py::rk4_transport`` (the closed-form dE/dx,
a difference from the JAX package's full Bethe formula by design, ROADMAP
Queue 3) through 10 x centres, then a gather per sample.

The draw is split from its deterministic core: :func:`draw_simple` draws
uniforms u (x = L u) and normals z on the device, :func:`sample_tof_from_draws`
maps them to TOF values and weights, so the tests hold the core exactly
against the JAX package's pieces on the same (x, z).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..constants import TUNL_SSA_CSI, CellGeometry, TofWindow, masses
from ..ops.cuda_hist import weighted_histogram
from ..ops.histogram import histogram_density
from ..ops.interp import eval_uniform_spline
from ..ops.kinematics import dd_neutron_energy, tof
from ..ops.likelihoods import box_lnprior, multinomial_loglike
from ..ops.pdfs import device_generator
from ..ops.stopping import BetheStopping, rk4_constants, rk4_transport
from ..ops.timing import ExGaussianTiming, apply_same_matrix, same_conv_matrix
from ..ops.xs import ddn_xs_uniform
from .forward import resolve_device

# v0 truth parameters and binning (tests/simpleTOFmodel.py:24-28,124-126)
V0_WINDOW = TofWindow(175.0, 200.0, 25)
V0_TRUTH = (1100.0, -100.0, 50.0)
V0_LO = (800.0, -200.0, 10.0)
V0_HI = (1200.0, 0.0, 100.0)


@dataclasses.dataclass(frozen=True)
class SimpleSpec:
    """Static configuration of the simple family (the JAX package's
    ``SimpleSpec``)."""

    geometry: CellGeometry = TUNL_SSA_CSI
    window: TofWindow = V0_WINDOW
    poly_order: int = 1           # 1 (v0), 3 (v1/v2)
    sigma_growth: bool = False    # v2: sigma(x) = E(x) (sigma0 + sigma1 x)
    xs_weighting: bool = False    # v2+: weight samples by the DDN XS
    convolve_beam: bool = False   # v2+: exGaussian spreading
    # v2.5: E0 gaussian at the cell entrance + RK4 transport, no polynomial
    bethe_transport: bool = False
    stopping: Optional[BetheStopping] = None
    # v0 uses cellToZero as the standoff and no detector half-length;
    # v1+ pass the standoff and add zeroDegLength / 2
    add_half_zero_deg: bool = False
    n_samples: int = 100_000
    rk4_substeps: int = 4
    n_transport_bins: int = 10   # x resolution of the v2.5 transport


def transport_centres(spec: SimpleSpec) -> np.ndarray:
    """The v2.5 transport's x centres: n_transport_bins bin centres of
    [0, L] (the JAX package's linspace)."""
    length, nb = spec.geometry.cell_length, spec.n_transport_bins
    return np.linspace(length / (2 * nb), length * (1 - 1 / (2 * nb)), nb)


@functools.lru_cache(maxsize=8)
def _rk4(spec: SimpleSpec):
    return rk4_constants(spec.stopping, transport_centres(spec),
                         spec.rk4_substeps)


def draw_simple(spec: SimpleSpec, n_walkers: int,
                generator: torch.Generator, device):
    """The random input of :func:`sample_tof_from_draws`: uniforms u and
    standard normals z, each (W, spec.n_samples) float32 on ``device``,
    from a generator there seeded by two words of the host
    ``generator``."""
    gen = device_generator(generator, torch.device(device))
    shape = (n_walkers, spec.n_samples)
    u = torch.rand(shape, generator=gen, device=device)
    z = torch.randn(shape, generator=gen, device=device)
    return u, z


def sample_tof_from_draws(x: torch.Tensor, z: torch.Tensor,
                          thetas: torch.Tensor, spec: SimpleSpec,
                          standoff: float):
    """Deterministic core of the JAX package's ``sample_tof``: depths x
    (W, N) in [0, L), standard normals z (W, N) and thetas (W, D) ->
    (TOF values (W, N), XS weights (W, N) or None, E_d (W, N)).

    v2.5: E0 = e0 + e0 sigma0 z transported to the x centres, each sample
    takes the energy of its x bin.  Else E(x) = p0 + p1 x + ... (order
    ``poly_order``), sigma = E(x) (sigma0 + sigma1 x) (``sigma_growth``) or
    the fixed p[order + 1], E_d = E(x) + sigma z.  Then the neutron leg
    from the d(d,n) energy over standoff + (L - x) (+ the detector's
    half-length), and the deuteron leg at (E_source + E_d)/2 over x."""
    length = spec.geometry.cell_length
    p = [thetas[:, k:k + 1] for k in range(thetas.shape[1])]
    if spec.bethe_transport:
        e0, sigma0 = p[0], p[1]
        e_init = e0 + e0 * sigma0 * z
        e_at_x = rk4_transport(_rk4(spec), e_init)        # (W, M, N)
        nb = spec.n_transport_bins
        bin_idx = torch.clamp((x / length * nb).to(torch.int32), 0,
                              nb - 1).long()
        e_d = torch.take_along_dim(e_at_x, bin_idx[:, None, :], dim=1)[:, 0]
        e_source = e0
    else:
        mean_e = p[0]
        x_k = x
        for k in range(1, spec.poly_order + 1):
            mean_e = mean_e + p[k] * x_k
            x_k = x_k * x
        if spec.sigma_growth:
            sigma0, sigma1 = p[spec.poly_order + 1], p[spec.poly_order + 2]
            sigma = mean_e * (sigma0 + sigma1 * x)
        else:
            sigma = p[spec.poly_order + 1]
        e_d = mean_e + sigma * z
        e_source = p[0]
    e_n = dd_neutron_energy(e_d)
    n_dist = standoff + (length - x)
    if spec.add_half_zero_deg:
        n_dist = n_dist + spec.geometry.zero_deg_length / 2.0
    tofs = (tof(masses.neutron, e_n, n_dist)
            + tof(masses.deuteron, (e_source + e_d) / 2.0, x))
    weights = ddn_xs_uniform(e_d) if spec.xs_weighting else None
    return tofs, weights, e_d


def model_pdf_from_draws(x: torch.Tensor, z: torch.Tensor,
                         thetas: torch.Tensor, spec: SimpleSpec,
                         standoff: float) -> torch.Tensor:
    """Binned TOF pdf of every walker, (W, n_bins): the density-normalised
    weighted histogram of its samples (kernel K3 on a CUDA tensor, one
    launch for all W rows), beam-timing convolved (``convolve_beam``)."""
    tofs, weights, _ = sample_tof_from_draws(x, z, thetas, spec, standoff)
    if weights is None:
        weights = torch.ones_like(tofs)
    w = spec.window
    hist = weighted_histogram(tofs.contiguous(), w.lo, w.hi, w.n_bins,
                              weights.contiguous())
    pdf = histogram_density(hist, w.lo, w.hi)
    if spec.convolve_beam:
        mat = same_conv_matrix(ExGaussianTiming().kernel, w.n_bins)
        pdf = apply_same_matrix(pdf, torch.as_tensor(
            mat, dtype=pdf.dtype, device=pdf.device))
    return pdf


def sample_tof(generator: torch.Generator, thetas: torch.Tensor,
               spec: SimpleSpec, standoff: float):
    """Draw (TOF values, weights or None, E_d, x), each (W, N), on the
    thetas' device (the JAX package's ``sample_tof`` with a walker axis)."""
    u, z = draw_simple(spec, thetas.shape[0], generator, thetas.device)
    x = u * spec.geometry.cell_length
    tofs, weights, e_d = sample_tof_from_draws(x, z, thetas, spec, standoff)
    return tofs, weights, e_d, x


def model_pdf(generator: torch.Generator, thetas: torch.Tensor,
              spec: SimpleSpec, standoff: float) -> torch.Tensor:
    """(W, D) -> (W, n_bins) model pdfs, fresh draws from ``generator``."""
    u, z = draw_simple(spec, thetas.shape[0], generator, thetas.device)
    return model_pdf_from_draws(u * spec.geometry.cell_length, z, thetas,
                                spec, standoff)


class SimpleProblem:
    """The closure-test problem of the simple family: the multinomial
    likelihood of the observed histogram under each walker's model pdf,
    and a strict box prior.  Defaults reproduce simpleTOFmodel
    (``tests/simpleTOFmodel.py:106-120``): standoff = cellToZero, 3
    params.  ``device``: the GPU unless the caller asks for the CPU."""

    def __init__(self, spec: SimpleSpec = SimpleSpec(),
                 standoff: float = TUNL_SSA_CSI.cell_to_zero,
                 param_lo=V0_LO, param_hi=V0_HI, *, device="cuda"):
        self.spec = spec
        self.standoff = standoff
        self.param_lo = tuple(param_lo)
        self.param_hi = tuple(param_hi)
        self.device = resolve_device(device)
        self._lo = torch.as_tensor(np.asarray(param_lo, np.float32),
                                   device=self.device)
        self._hi = torch.as_tensor(np.asarray(param_hi, np.float32),
                                   device=self.device)

    @property
    def n_dim(self) -> int:
        return len(self.param_lo)

    def log_prob_from_draws(self, thetas, x, z, observed) -> torch.Tensor:
        """Deterministic core of :meth:`log_prob` on given (x, z)."""
        prior = box_lnprior(thetas, self._lo, self._hi, inclusive=False)
        pdf = model_pdf_from_draws(x, z, thetas, self.spec, self.standoff)
        ll = multinomial_loglike(pdf, observed)
        return torch.where(torch.isneginf(prior), -torch.inf, prior + ll)

    def log_prob(self, thetas: torch.Tensor, generator: torch.Generator,
                 observed: torch.Tensor) -> torch.Tensor:
        """Box prior + multinomial log-likelihood, (W, D) -> (W,); every
        walker draws its own samples from ``generator``."""
        u, z = draw_simple(self.spec, thetas.shape[0], generator,
                           thetas.device)
        return self.log_prob_from_draws(
            thetas, u * self.spec.geometry.cell_length, z, observed)

    def make_log_prob_fn(self, observed):
        """Closure (thetas (W, D), host generator) -> (W,) for the
        sampler."""
        obs = torch.as_tensor(np.asarray(observed, np.float32),
                              device=self.device)

        def logp(thetas, generator):
            return self.log_prob(thetas, generator, obs)

        return logp
