"""Posterior-predictive checks, spectrum extraction, and MCNP SDEF export.

Port of ``mcmctoffitting_tpu/utils/ppc.py`` (the reference's
``utilities/ppcTools.py`` / ``ppcTools_oneBD.py``), with the JAX package's
statistics: posterior draws with replacement from the chain tail, the
``lnprob_cut`` filter, independent beam draws per draw and run, and the
neutron-yield weight grids from a beam draw of their own.  Only the
schedule differs: the draws are the walker axis of one batched forward
(``TofForward.tof_spectra_multi``, every run at once), in chunks of at
most :data:`PPC_CHUNK` draws, so that the peak memory is the fit's
half-step.  Randomness comes from one host ``torch.Generator``, which
seeds the device draws as in the fits.

Provides:
* :class:`PPCSampler` -- posterior draws -> model spectra + neutron/deuteron
  spectra (reference ``generatePPC``), with the oneBD ``lnprobcut`` filter
  (``utilities/ppcTools_oneBD.py:279-289``).
* :func:`get_dtof_distribution` -- deuteron transit times through the cell,
  its deterministic core :func:`dtof_from_energies`.
* :func:`percentile_bands` -- 16/50/84% credible bands
  (``tests/testPPC.py:110-139``).
* :func:`sample_initial_energy_dist` -- beam-energy posterior samples
  (``utilities/ppcTools.py:334-354``).
* :func:`make_sdef_sia_cumulative` -- MCNP 'si a'/'sp' source card strings
  (``utilities/ppcTools.py:397-422``).
* :func:`collapse_neutron_spectrum`, :func:`rebin`,
  :func:`export_spectrum_csv`.
"""
from __future__ import annotations

import csv
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..constants import TofWindow, masses, physics
from ..ops.histogram import weighted_histogram_multi_window, window_constants

# posterior draws per batched forward: the fit's half-step (256 walkers)
PPC_CHUNK = 128


@dataclasses.dataclass
class PPCResult:
    """Stacked PPC draws."""

    tof_spectra: list          # per run: (n_draws, n_bins)
    neutron_spectra: np.ndarray  # (n_draws, x_bins, eD_bins) weight grids
    thetas: np.ndarray         # (n_draws, D) parameter draws used


def _in_chunks(fn: Callable, thetas: torch.Tensor) -> list:
    """``fn`` over rows of ``thetas`` in chunks of :data:`PPC_CHUNK`; the
    chunks' results in order."""
    return [fn(thetas[i:i + PPC_CHUNK])
            for i in range(0, thetas.shape[0], PPC_CHUNK)]


class PPCSampler:
    """Sample the posterior chain and push draws through the forward model.

    ``problem``: a SimultFitProblem / OneBDProblem (its ``forward``,
    ``split_theta``, ``shared_params``, ``windows`` and ``spec``; the
    problem's device is where the draws run).  ``chain``: (S, W, D)
    array; ``log_probs``: (S, W) (for lnprob_cut).
    """

    def __init__(self, problem, chain, log_probs=None, *,
                 n_steps_to_include: int = 50):
        self.problem = problem
        self.chain = np.asarray(chain)
        self.log_probs = None if log_probs is None else np.asarray(log_probs)
        tail = self.chain[-n_steps_to_include:]
        self.flat = tail.reshape(-1, tail.shape[-1])
        if self.log_probs is not None:
            self.flat_lp = self.log_probs[-n_steps_to_include:].reshape(-1)
        else:
            self.flat_lp = None

    def draw_thetas(self, generator: torch.Generator, n_draws: int,
                    lnprob_cut: Optional[float] = None) -> np.ndarray:
        """Random posterior draws from the chain tail (with replacement,
        like ``np.random.randint`` in ``utilities/ppcTools.py:295``);
        optional lnprob floor (``utilities/ppcTools_oneBD.py:279-289``).
        ``generator`` is a host generator."""
        flat = self.flat
        if lnprob_cut is not None and self.flat_lp is not None:
            mask = self.flat_lp > lnprob_cut
            if mask.sum() == 0:
                raise ValueError("lnprob_cut removed every sample")
            flat = flat[mask]
        idx = torch.randint(0, len(flat), (n_draws,), generator=generator)
        return flat[idx.numpy()]

    def _thetas_tensor(self, thetas: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(thetas, np.float32),
                               device=self.problem.device)

    def generate(self, generator: torch.Generator, n_draws: int = 500,
                 lnprob_cut: Optional[float] = None) -> PPCResult:
        """The reference ``generatePPC``: per draw, every run's model
        spectrum (density-normalised, its own beam draw per run, and for
        oneBD its own background draw) and the neutron-yield weight grid
        (a beam draw of its own).

        Each chunk of draws is one batched forward of all runs.  With the
        mc estimator the grid stage takes the runs' initial energies and
        the weight grids' (drawn apart, in the order the forward and the
        weight grids draw them) in one call, so that its kernel (K4 on the
        ODE path) launches once per chunk."""
        thetas = self.draw_thetas(generator, n_draws, lnprob_cut)
        forward = self.problem.forward

        def spectra_and_grids(chunk):
            params, scales, bg_levels = self.problem.split_theta(chunk)
            if forward.spec.sampling != "mc":
                spectra = forward(params, scales, generator, bg_levels,
                                  get_pdf=True)
                return spectra, self._weight_grids(generator, chunk)
            e_runs = forward.sample_beam_energies(params, generator)
            background = (None if bg_levels is None
                          else forward.background(bg_levels, generator))
            e_grid = forward.sample_beam_energies(
                self.problem.shared_params(chunk), generator, n_runs=1)
            n_runs = e_runs.shape[1]
            grids = forward.energy_weight_grid(
                torch.cat([e_runs, e_grid], dim=1))
            base_tof, draws = forward.lattice(
                grids[:, :n_runs],
                forward.lattice_e0_means(params, e_runs.mean(dim=-1)))
            spectra = forward.spectra(base_tof, draws, scales, background,
                                      get_pdf=True)
            return spectra, grids[:, n_runs]

        parts = _in_chunks(spectra_and_grids, self._thetas_tensor(thetas))
        spectra = torch.cat([s for s, _ in parts]).cpu().numpy()
        grids = torch.cat([g for _, g in parts]).cpu().numpy()
        per_run = [spectra[:, r, :w.n_bins]
                   for r, w in enumerate(self.problem.windows)]
        return PPCResult(per_run, grids, thetas)

    def _weight_grids(self, generator: torch.Generator,
                      thetas: torch.Tensor) -> torch.Tensor:
        """Neutron-yield (x, eD) grids, one per draw (the eN/eD spectra the
        reference accumulates alongside, ``utilities/ppcTools.py:164-187``):
        (n, D) -> (n, M, Be)."""
        forward = self.problem.forward
        e0 = forward.sample_beam_energies(
            self.problem.shared_params(thetas), generator, n_runs=1)
        return forward.energy_weight_grid(e0)[:, 0]


def dtof_from_energies(forward, e0: torch.Tensor):
    """Deterministic core of :func:`get_dtof_distribution`: initial
    energies (..., N) -> (energies at each x-bin centre (..., M, N),
    cumulative deuteron transit times (..., M, N) in ns), with
    ``dtof[m] = sum_{k <= m} dx_k / v(E(e0, x_k))``, dx_k the distance
    from the previous x centre (from 0 for the first) and v the
    non-relativistic speed of the TOF lattice, in float32."""
    x = np.asarray(forward.spec.x_binning.centers, np.float64)
    dx = torch.as_tensor(np.diff(np.concatenate([[0.0], x])),
                         dtype=torch.float32, device=e0.device)
    e_at_x = forward.transport(e0)
    v = physics.speed_of_light * torch.sqrt(2.0 * e_at_x / masses.deuteron)
    return e_at_x, torch.cumsum(dx[:, None] / v, dim=-2)


def get_dtof_distribution(generator: torch.Generator, sampler: PPCSampler,
                          *, n_draws: int = 1, n_samples_per: int = 1000,
                          n_tof_bins: int = 100):
    """Deuteron time-of-flight-through-cell distribution from the PPC.

    Equivalent of ``utilities/ppcTools.py:358-394`` (getDTOFdistribution),
    finished as the JAX package finishes it (the reference allocates its
    ``dtofHist`` and never fills it): per posterior draw,
    ``n_samples_per`` beam energies transported through the cell and
    their cumulative transit times (:func:`dtof_from_energies`).  Returns
    a dict with ``x_centers`` (M,), ``e_at_x`` (n_draws, M, N), ``dtof``
    (n_draws, M, N) cumulative deuteron transit times (ns), ``dtof_hist``
    (M, n_tof_bins), the per-x-slice histogram over all draws pooled, and
    ``thetas``.
    """
    problem = sampler.problem
    forward = problem.forward
    thetas = sampler.draw_thetas(generator, n_draws)

    def one_chunk(chunk):
        e0 = forward.sample_beam_energies(problem.shared_params(chunk),
                                          generator, n_runs=1,
                                          n=n_samples_per)[:, 0]
        return dtof_from_energies(forward, e0)

    parts = _in_chunks(one_chunk, sampler._thetas_tensor(thetas))
    e_all = torch.cat([e for e, _ in parts]).cpu().numpy()     # (D, M, N)
    t_all = torch.cat([t for _, t in parts]).cpu().numpy()
    x = np.asarray(problem.spec.x_binning.centers, np.float64)
    t_max = float(t_all.max()) or 1.0
    hist = np.stack([
        np.histogram(t_all[:, m, :].reshape(-1), n_tof_bins,
                     (0.0, t_max))[0]
        for m in range(x.shape[0])])                           # (M, bins)
    return {"x_centers": x, "e_at_x": e_all, "dtof": t_all,
            "dtof_hist": hist, "thetas": thetas}


def percentile_bands(stacked: np.ndarray,
                     q: Sequence[float] = (16, 50, 84)) -> np.ndarray:
    """(n_draws, n_bins) -> (len(q), n_bins) credible bands
    (``tests/testPPC.py:47-54``)."""
    return np.percentile(np.asarray(stacked), list(q), axis=0)


def sample_initial_energy_dist(generator: torch.Generator,
                               sampler: PPCSampler, *,
                               n_samples: int = 100,
                               n_draws_per: int = 10_000,
                               normed: bool = False) -> np.ndarray:
    """Posterior samples of the initial deuteron-energy distribution
    (``utilities/ppcTools.py:334-354``): per posterior draw, a histogram
    of ``n_draws_per`` beam energies over the eD binning (np.histogram's
    rules; ``normed``: each row divided by its in-range total, the JAX
    package's density times the bin width).  Returns (n_samples,
    eD_bins)."""
    problem = sampler.problem
    forward = problem.forward
    eb = problem.spec.ed_binning
    win = window_constants((TofWindow(eb.lo, eb.hi, eb.n),),
                           device=problem.device)
    thetas = sampler.draw_thetas(generator, n_samples)

    def one_chunk(chunk):
        e = forward.sample_beam_energies(problem.shared_params(chunk),
                                         generator, n_runs=1,
                                         n=n_draws_per)
        return weighted_histogram_multi_window(e, win, torch.ones_like(e))

    hist = torch.cat(_in_chunks(one_chunk, sampler._thetas_tensor(thetas)))
    hist = hist[:, 0].double().cpu().numpy()
    if normed:
        hist = hist / hist.sum(axis=-1, keepdims=True)
    return hist


def make_sdef_sia_cumulative(en_centers_keV: np.ndarray,
                             neutron_spectrum: np.ndarray,
                             dist_number: int = 100) -> dict:
    """MCNP SDEF 'si a' / 'sp' card strings, energies in MeV
    (``utilities/ppcTools.py:397-422``)."""
    si = [f"si{dist_number} a"]
    sp = [f"sp{dist_number}"]
    for en, counts in zip(np.asarray(en_centers_keV),
                          np.asarray(neutron_spectrum)):
        si.append(" {:.3f}".format(en / 1000.0))
        sp.append(" {:.0f}".format(counts))
    return {"si": "".join(si), "sp": "".join(sp)}


def collapse_neutron_spectrum(grids: np.ndarray) -> np.ndarray:
    """Sum PPC weight grids over draws and cell length -> eD/eN spectrum
    (``utilities/ppcTools.py:405-411``)."""
    return np.asarray(grids).sum(axis=(0, 1))


def rebin(spectrum: np.ndarray, factor: int) -> np.ndarray:
    """Sum-preserving rebin by an integer factor
    (``tests/ppcPlotting_oneBD.py:195-230`` rebins spectra before SDEF/CSV
    export); trailing remainder bins are dropped like the reference's
    integer reshape."""
    spectrum = np.asarray(spectrum)
    n = (spectrum.shape[-1] // factor) * factor
    return spectrum[..., :n].reshape(
        spectrum.shape[:-1] + (n // factor, factor)).sum(axis=-1)


def export_spectrum_csv(path: str, centers: np.ndarray,
                        spectrum: np.ndarray) -> None:
    """CSV export of (energy, counts) rows (``tests/ppcPlotting_oneBD.py``)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for c, v in zip(np.asarray(centers), np.asarray(spectrum)):
            w.writerow([float(c), float(v)])
