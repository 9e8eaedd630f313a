"""The simultFit joint multi-standoff fit: theta = (beamE, eLoss, scale, s,
N_1..N_nruns), one spectrum and one binned Poisson likelihood per run.

Port of ``mcmctoffitting_tpu/models/simult.py`` for ``sampling='counts'``:
the same preset (:func:`default_spec`), bounds, guesses and walker
initialisation, and a batched log-probability over (W, D) walkers.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from mcmctoffitting_tpu.config import SIMULTFIT_ED_BINNING, SIMULTFIT_X_BINNING
from mcmctoffitting_tpu.constants import TUNL_SSA_CSI, TofWindow, tof_windows

from ..ops.e0grid import cached_e0_grid_table
from ..ops.likelihoods import (box_lnprior, poisson_binned_loglike,
                               poisson_logpmf_loglike)
from ..ops.stopping import StoppingTable, d2_gas_stopping
from ..ops.timing import ExGaussianTiming
from ..ops.xs import ddn_xs_uniform
from .forward import ForwardSpec, ForwardTables, TofForward, not_ported

# run index -> standoff name (and window name)
RUN_LAYOUT = ("mid", "close", "close", "far", "production")

PARAM_LO_SHARED = np.array([1825.0, 600.0, 40.0, 0.1])
PARAM_HI_SHARED = np.array([1925.0, 1000.0, 300.0, 1.2])
SCALE_LO, SCALE_HI = 0.0, 1.0e6

GUESS_SHARED = np.array([1878.4, 850.0, 170.0, 0.5])
AGITATORS_SHARED = np.array([10.0, 50.0, 20.0, 0.1])

# (E0 min, max, step) keV of the stopping table
SIMULT_TABLE_BINNING = (20.0, 2420.0, 25.0)


@functools.lru_cache(maxsize=4)
def _build_table(rho: float) -> StoppingTable:
    return StoppingTable.build(d2_gas_stopping(rho=rho),
                               SIMULT_TABLE_BINNING,
                               SIMULTFIT_X_BINNING.centers,
                               energy_floor=20.0)


def default_spec(n_samples: int = 200_000, *,
                 fine_grid: int | None = None,
                 transport: str = "table",
                 xs_mode: str = "e0grid",
                 sampling: str = "mc") -> ForwardSpec:
    """Forward spec for the simultFit campaign (the JAX preset's values).

    The port runs ``sampling='counts'``; the JAX default 'mc' and the
    'expected' estimator raise until ROADMAP slice 2 adds them.  F = 512
    fine cells at >= 100k draws, 1024 below, unless ``fine_grid`` is set.
    """
    if transport != "table":
        raise not_ported(f"transport={transport!r}", "slice 5")
    rho = 8.565e-5
    if sampling in ("expected", "counts"):
        xs_mode = "e0grid"
    if sampling == "counts":
        e0_grid_fine = 512 if n_samples >= 100_000 else 1024
    else:
        e0_grid_fine = 256
    if fine_grid is not None:
        e0_grid_fine = int(fine_grid)
    table = _build_table(rho)
    spec = ForwardSpec(
        geometry=TUNL_SSA_CSI,
        ed_binning=SIMULTFIT_ED_BINNING,
        x_binning=SIMULTFIT_X_BINNING,
        stopping_table=table,
        beam_timing=ExGaussianTiming(),
        zero_degree="segments",
        cell_attenuation=False,
        n_samples=n_samples,
        xs_mode=xs_mode,
        e0_grid_fine=e0_grid_fine,
        sampling=sampling,
    )                     # raises here for what the port does not run yet
    return dataclasses.replace(spec, e0_grid_table=cached_e0_grid_table(
        table, SIMULTFIT_ED_BINNING, ddn_xs_uniform, e0_grid_fine))


class ObservedRuns(NamedTuple):
    """Per-run observed histograms padded to the widest window."""

    counts: torch.Tensor    # (R, n_pad) float32, zero past each n_bins
    mask: torch.Tensor      # (R, n_pad) bool, True on real bins


class SimultFitProblem:
    """Static joint-fit problem on one device: spec + per-run standoffs,
    windows and bounds, and the batched log-probability.

    ``likelihood``: 'reference' (the faithful floor-gammaln sawtooth, the
    JAX default) or 'poisson' (the corrected Poisson logpmf).
    ``tables``: forward tables to use instead of the ones the port builds
    (``models.forward.forward_tables_from_numpy``).
    """

    def __init__(self, spec: ForwardSpec, n_runs: int = 4,
                 likelihood: str = "reference", *, device,
                 tables: ForwardTables | None = None):
        if likelihood not in ("reference", "poisson"):
            raise ValueError(f"unknown likelihood {likelihood!r} "
                             "(expected 'reference' or 'poisson')")
        self.spec = spec
        self.n_runs = n_runs
        self.likelihood = likelihood
        self.device = torch.device(device)
        self._tables = tables

    @property
    def standoffs(self) -> tuple[float, ...]:
        g = self.spec.geometry
        return tuple(g.standoff(name) for name in RUN_LAYOUT[: self.n_runs])

    @property
    def windows(self) -> tuple[TofWindow, ...]:
        return tuple(tof_windows[name] for name in RUN_LAYOUT[: self.n_runs])

    @property
    def n_dim(self) -> int:
        return 4 + self.n_runs

    @property
    def param_lo(self) -> np.ndarray:
        return np.concatenate([PARAM_LO_SHARED,
                               np.full(self.n_runs, SCALE_LO)])

    @property
    def param_hi(self) -> np.ndarray:
        return np.concatenate([PARAM_HI_SHARED,
                               np.full(self.n_runs, SCALE_HI)])

    @functools.cached_property
    def forward(self) -> TofForward:
        return TofForward(self.spec, self.standoffs, self.windows,
                          device=self.device, tables=self._tables)

    @functools.cached_property
    def _bounds(self):
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)
        return f32(self.param_lo), f32(self.param_hi)

    def guess_theta(self, observed) -> np.ndarray:
        """Shared guesses + per-run scale = observed totals."""
        scale_guesses = np.array([float(np.sum(o)) for o in observed])
        return np.concatenate([GUESS_SHARED, scale_guesses])

    def initial_walkers_from_observed(self, generator: torch.Generator,
                                      n_walkers: int, observed):
        """guesses + agitators * randn, clipped 1e-3 inside the prior box:
        (n_walkers, n_dim) float32 on the problem's device; ``generator``
        must live on that device."""
        guesses = self.guess_theta(observed)
        agitators = np.concatenate([AGITATORS_SHARED,
                                    0.15 * guesses[4: 4 + self.n_runs]])
        noise = torch.randn((n_walkers, self.n_dim), generator=generator,
                            device=self.device)
        p0 = (torch.as_tensor(guesses, dtype=torch.float32,
                              device=self.device)
              + torch.as_tensor(agitators, dtype=torch.float32,
                                device=self.device) * noise)
        lo, hi = self._bounds
        return torch.clamp(p0, lo + 1e-3, hi - 1e-3)

    def observed_runs(self, observed) -> ObservedRuns:
        """Per-run observed count arrays -> padded device tensors."""
        n_pad = max(w.n_bins for w in self.windows)
        counts = np.zeros((self.n_runs, n_pad), np.float32)
        mask = np.zeros((self.n_runs, n_pad), bool)
        for r, (obs, win) in enumerate(zip(observed, self.windows)):
            obs = np.asarray(obs, np.float32)
            if obs.shape != (win.n_bins,):
                raise ValueError(f"run {r}: observed shape {obs.shape}, "
                                 f"window has {win.n_bins} bins")
            counts[r, :win.n_bins] = obs
            mask[r, :win.n_bins] = True
        return ObservedRuns(torch.as_tensor(counts, device=self.device),
                            torch.as_tensor(mask, device=self.device))

    def run_spectra(self, thetas: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
        """Model spectra as the likelihood sees them: (W, R, n_pad)."""
        return self.forward(thetas, generator)

    def log_like(self, thetas, generator, observed: ObservedRuns):
        """Joint log-likelihood alone, (W, D) -> (W,): per-run binned
        Poisson log-likelihoods summed over runs, a NaN total -> -inf."""
        spectra = self.run_spectra(thetas, generator)
        if self.likelihood == "reference":
            per_run = poisson_binned_loglike(spectra, observed.counts,
                                             mask=observed.mask)
        else:
            per_run = poisson_logpmf_loglike(spectra, observed.counts,
                                             mask=observed.mask)
        total = torch.sum(per_run, dim=-1)
        return torch.where(torch.isnan(total), -torch.inf, total)

    def log_prob(self, thetas, generator, observed: ObservedRuns):
        """Box prior + joint log-likelihood, (W, D) -> (W,).  Walkers
        outside the box are -inf whatever the likelihood says (the forward
        still runs for them: the batch has one shape), and NaN -> -inf."""
        lo, hi = self._bounds
        prior = box_lnprior(thetas, lo, hi, inclusive=True)
        total = prior + self.log_like(thetas, generator, observed)
        return torch.where(torch.isneginf(prior), -torch.inf,
                           torch.where(torch.isnan(total), -torch.inf,
                                       total))

    def make_log_prob_fn(self, observed):
        """Closure (thetas (W, D), host generator) -> (W,) for the
        sampler."""
        obs = self.observed_runs(observed)

        def logp(thetas, generator):
            return self.log_prob(thetas, generator, obs)

        return logp
