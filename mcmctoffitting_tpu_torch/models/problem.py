"""What the joint-fit problems share: a spec, per-run standoffs, windows
and bounds on one device, the observed runs padded to one width, and the
batched log-probability (box prior + per-run binned Poisson likelihoods).

A problem class (``models/simult.py``, ``models/onebd.py``) adds its run
layout, its parameter vector (``n_dim``, ``param_lo``/``param_hi``,
``shared_params``, ``split_theta``) and its guesses (``guess_theta``,
``agitators``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constants import TofWindow
from ..ops.likelihoods import (box_lnprior, poisson_binned_loglike,
                               poisson_logpmf_loglike)
from ..utils.profiling import span
from .forward import (ForwardSpec, ForwardTables, TofForward, resolve_device,
                      single_run_spectrum)
from .logp_graph import GraphCache, graphable, log_prob_graph


class ObservedRuns(NamedTuple):
    """Per-run observed histograms padded to the widest window."""

    counts: torch.Tensor    # (R, n_pad) float32, zero past each n_bins
    mask: torch.Tensor      # (R, n_pad) bool, True on real bins


class JointFitProblem:
    """Static joint-fit problem on one device.

    ``likelihood``: 'reference' (the faithful floor-gammaln sawtooth, the
    JAX default) or 'poisson' (the corrected Poisson logpmf).
    ``tables``: forward tables to use instead of the ones the port builds
    (``models.forward.forward_tables_from_numpy``).
    ``device``: the GPU unless the caller asks for the CPU (without a GPU
    the default raises; it never falls back to the CPU).

    A subclass sets ``RUN_LAYOUT`` (run index -> standoff and window
    name) and ``WINDOWS`` (name -> ``TofWindow``), and defines ``n_dim``,
    ``param_lo``, ``param_hi``, ``shared_params``, ``split_theta``,
    ``guess_theta`` and ``agitators``.
    """

    RUN_LAYOUT: tuple = ()
    WINDOWS = None

    def __init__(self, spec: ForwardSpec, n_runs: int,
                 likelihood: str = "reference", *, device="cuda",
                 tables: Optional[ForwardTables] = None):
        if likelihood not in ("reference", "poisson"):
            raise ValueError(f"unknown likelihood {likelihood!r} "
                             "(expected 'reference' or 'poisson')")
        self.spec = spec
        self.n_runs = n_runs
        self.likelihood = likelihood
        self.device = resolve_device(device)
        self._tables = tables

    @property
    def standoffs(self) -> tuple[float, ...]:
        g = self.spec.geometry
        return tuple(g.standoff(name)
                     for name in self.RUN_LAYOUT[: self.n_runs])

    @property
    def windows(self) -> tuple[TofWindow, ...]:
        return tuple(self.WINDOWS[name]
                     for name in self.RUN_LAYOUT[: self.n_runs])

    @functools.cached_property
    def forward(self) -> TofForward:
        return TofForward(self.spec, self.standoffs, self.windows,
                          device=self.device, tables=self._tables)

    @functools.cached_property
    def logp_graphs(self) -> GraphCache:
        """The captured log-probs of :meth:`log_prob` by key
        (``models/logp_graph.py``)."""
        return GraphCache()

    def _f32(self, values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=torch.float32,
                               device=self.device)

    @functools.cached_property
    def _bounds(self):
        return self._f32(self.param_lo), self._f32(self.param_hi)

    def initial_walkers_from_observed(self, generator: torch.Generator,
                                      n_walkers: int, observed, *guess_args):
        """guesses + agitators * randn, clipped 1e-3 inside the prior box:
        (n_walkers, n_dim) float32 on the problem's device; ``generator``
        must live on that device.  ``guess_args`` go to ``guess_theta``."""
        guesses = self.guess_theta(observed, *guess_args)
        noise = torch.randn((n_walkers, self.n_dim), generator=generator,
                            device=self.device)
        p0 = self._f32(guesses) + self._f32(self.agitators(guesses)) * noise
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

    @property
    def draws_by_row(self) -> bool:
        """Whether every random draw of the log-prob is K1's, whose
        numbers follow each walker's row (``walker_offset``): counts, and
        'expected' with or without a Poisson background.  mc draws its
        energies from a device generator, whose numbers no offset
        places."""
        return self.spec.sampling in ("counts", "expected")

    def run_spectra(self, thetas: torch.Tensor, generator: torch.Generator,
                    *, walker_offset: int = 0,
                    walker_blocks=None) -> torch.Tensor:
        """Model spectra as the likelihood sees them: (W, D) ->
        (W, R, n_pad); ``walker_offset`` and ``walker_blocks`` place the
        walkers in a larger batch (``forward.k1_counters``)."""
        params, scales, bg_levels = self.split_theta(thetas)
        return self.forward(params, scales, generator, bg_levels,
                            walker_offset=walker_offset,
                            walker_blocks=walker_blocks)

    def _run_forward(self, run: int) -> TofForward:
        """The forward of run ``run`` alone (built once per run)."""
        forwards = self.__dict__.setdefault("_run_forwards", {})
        if run not in forwards:
            forwards[run] = TofForward(
                self.spec, self.standoffs[run:run + 1],
                self.windows[run:run + 1], device=self.device,
                tables=self._tables)
        return forwards[run]

    def run_spectrum(self, generator: torch.Generator, thetas: torch.Tensor,
                     run: int, *, get_pdf: bool = True) -> torch.Tensor:
        """One run's model spectrum (the reference's ``generateModelData``
        for that run; ``models.forward.single_run_spectrum`` on this
        problem's parameters): (W, D) -> (W, n_bins), its own draws from
        the host ``generator``."""
        params, scales, bg_levels = self.split_theta(thetas)
        return single_run_spectrum(
            self._run_forward(run), generator, params, scales[:, run],
            None if bg_levels is None else bg_levels[:, run],
            get_pdf=get_pdf)

    def log_like(self, thetas, generator, observed: ObservedRuns, **rows):
        """Joint log-likelihood alone, (W, D) -> (W,): per-run binned
        Poisson log-likelihoods summed over runs, a NaN total -> -inf.
        ``rows``: ``walker_offset``, ``walker_blocks`` of
        :meth:`run_spectra`."""
        spectra = self.run_spectra(thetas, generator, **rows)
        with span("mcmctof.likelihood"):
            loglike = (poisson_binned_loglike
                       if self.likelihood == "reference"
                       else poisson_logpmf_loglike)
            total = torch.sum(loglike(spectra, observed.counts,
                                      mask=observed.mask), dim=-1)
            return torch.where(torch.isnan(total), -torch.inf, total)

    def log_prob(self, thetas, generator, observed: ObservedRuns, *,
                 walker_offset: int = 0, walker_blocks=None):
        """Box prior + joint log-likelihood, (W, D) -> (W,).  Walkers
        outside the box are -inf whatever the likelihood says (the forward
        still runs for them: the batch has one shape), and NaN -> -inf.
        ``walker_offset``, the global index of the batch's first walker,
        and ``walker_blocks`` place the batch in a larger one (a shard):
        K1 then draws that batch's numbers for these rows.  On the card a
        counts evaluation that needs no gradient is a replay of a CUDA
        graph of :meth:`log_prob_eager` (``models/logp_graph.py``): the
        same bits, the host generator left where the eager path leaves
        it."""
        with span("mcmctof.logp"):
            if graphable(self.spec, thetas):
                return log_prob_graph(self, thetas, generator, observed,
                                      walker_offset=walker_offset,
                                      walker_blocks=walker_blocks)
            return self.log_prob_eager(thetas, generator, observed,
                                       walker_offset=walker_offset,
                                       walker_blocks=walker_blocks)

    def log_prob_eager(self, thetas, generator, observed: ObservedRuns, *,
                       walker_offset: int = 0, walker_blocks=None):
        """:meth:`log_prob`, its operations enqueued one by one."""
        with span("mcmctof.prior"):
            lo, hi = self._bounds
            prior = box_lnprior(thetas, lo, hi, inclusive=True)
        total = prior + self.log_like(thetas, generator, observed,
                                      walker_offset=walker_offset,
                                      walker_blocks=walker_blocks)
        return torch.where(torch.isneginf(prior), -torch.inf,
                           torch.where(torch.isnan(total), -torch.inf,
                                       total))

    def make_log_prob_fn(self, observed):
        """Closure (thetas (W, D), host generator) -> (W,) for the
        sampler; it takes :meth:`log_prob`'s ``walker_offset`` and
        ``walker_blocks`` (``parallel.make_sharded_logp_batch`` passes
        them)."""
        obs = self.observed_runs(observed)

        def logp(thetas, generator, walker_offset=0, walker_blocks=None):
            return self.log_prob(thetas, generator, obs,
                                 walker_offset=walker_offset,
                                 walker_blocks=walker_blocks)

        return logp
