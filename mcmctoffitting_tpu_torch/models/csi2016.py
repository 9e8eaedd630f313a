"""The ppcTools-era CsI-2016 campaign model (skew-normal beam source).

Port of ``mcmctoffitting_tpu/models/csi2016.py``.  Old-campaign chains are
parameterized theta = (e0, sigma0, skew0, scaleFactor): the initial
energies are drawn from a skew normal, ``skewnorm.rvs(a=skew0, loc=e0,
scale=e0*sigma0)``, with a plain-normal fallback where the scale is not
positive (``utilities/ppcTools.py:197-217``).  This preset makes those
chains representable through the port's forward, so that the
posterior-predictive checks run on skewnorm-era chain files
(``cli/ppc.py -model csi2016``).  One scale factor is shared by every run.

Geometry, windows and standoffs are the 2016 CsI campaign's (those of
simultFit); the binning is the ppcTools default, 100 eD x 20 x bins.  On
the card a forward of a chunk of draws is one launch of kernel K4 (RK4
with one substep per x interval, moment histograms) and one of kernel K2
(the ten zero-degree segments).
"""
from __future__ import annotations

import functools

import torch

from ..config import Binning
from ..constants import TUNL_SSA_CSI, TofWindow, tof_windows
from ..ops.stopping import d2_gas_stopping
from ..ops.timing import ExGaussianTiming
from .forward import (ForwardSpec, TofForward, resolve_device,
                      single_run_spectrum)
from .simult import RUN_LAYOUT


def default_spec(n_samples: int = 50_000) -> ForwardSpec:
    """Forward spec for ppcTools-era chains (skewnorm source, ODE path)."""
    return ForwardSpec(
        geometry=TUNL_SSA_CSI,
        ed_binning=Binning(200.0, 1200.0, 100),
        x_binning=Binning(0.0, TUNL_SSA_CSI.cell_length, 20),
        stopping=d2_gas_stopping(rho=8.565e-5),
        transport="rk4",
        rk4_substeps=1,
        beam_timing=ExGaussianTiming(),
        zero_degree="segments",
        cell_attenuation=False,
        beam_source="skewnorm",
        n_samples=n_samples,
    )


class Csi2016Problem:
    """Problem wrapper for the PPC of old-campaign chains, on one device
    (the GPU unless the caller asks for the CPU): theta = (e0, sigma0,
    skew0, scaleFactor), ONE scale factor across runs
    (``utilities/ppcTools.py:207``), unlike simultFit's per-run ones."""

    def __init__(self, spec: ForwardSpec, n_runs: int = 4, *,
                 device="cuda"):
        self.spec = spec
        self.n_runs = n_runs
        self.device = resolve_device(device)

    @property
    def standoffs(self) -> tuple[float, ...]:
        g = self.spec.geometry
        return tuple(g.standoff(name) for name in RUN_LAYOUT[: self.n_runs])

    @property
    def windows(self) -> tuple[TofWindow, ...]:
        return tuple(tof_windows[name] for name in RUN_LAYOUT[: self.n_runs])

    @property
    def n_dim(self) -> int:
        return 4

    @functools.cached_property
    def forward(self) -> TofForward:
        return TofForward(self.spec, self.standoffs, self.windows,
                          device=self.device)

    def shared_params(self, thetas: torch.Tensor) -> torch.Tensor:
        """(e0, sigma0, skew0, scaleFactor): (..., D) -> (..., 4)."""
        return thetas[..., :4]

    def split_theta(self, thetas: torch.Tensor):
        """(W, D) -> (beam parameters (W, 4), the shared scale factor per
        run (W, R), no background)."""
        return (self.shared_params(thetas),
                thetas[:, 3:4].expand(-1, self.n_runs), None)

    def run_spectrum(self, generator: torch.Generator, thetas: torch.Tensor,
                     run: int, *, get_pdf: bool = True) -> torch.Tensor:
        """Model spectrum of one run for every walker
        (``generateModelData_original``, ``utilities/ppcTools.py:197-281``):
        (W, D) -> (W, n_bins), its own draws from the host ``generator``."""
        forwards = self.__dict__.setdefault("_run_forwards", {})
        if run not in forwards:
            forwards[run] = TofForward(
                self.spec, self.standoffs[run:run + 1],
                self.windows[run:run + 1], device=self.device)
        return single_run_spectrum(forwards[run], generator,
                                   self.shared_params(thetas),
                                   thetas[:, 3], get_pdf=get_pdf)
