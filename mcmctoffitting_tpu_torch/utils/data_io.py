"""Synthetic observed data.

Port of ``mcmctoffitting_tpu/utils/data_io.py::synthesize_observed``.  The
JAX package adds the observation noise with ``jax.random.poisson``; here the
model spectra come from the port's own forward and the noise from numpy's
``Generator.poisson``, both seeded by ``seed``.  The two packages therefore
synthesise different (equally distributed) data from one seed; tests that
compare them feed the JAX package's observed arrays to the port.
"""
from __future__ import annotations

import numpy as np
import torch


def synthesize_observed(seed: int, problem,
                        theta_truth) -> tuple[np.ndarray, ...]:
    """Per-run Poisson-fluctuated count histograms at ``theta_truth``
    (float64 arrays, one per run window)."""
    theta = torch.as_tensor(np.asarray(theta_truth, np.float32),
                            device=problem.device)[None]
    generator = torch.Generator().manual_seed(seed)    # the forward's draws
    spectra = problem.forward(theta, generator)[0]
    spectra = spectra.double().cpu().numpy()
    rng = np.random.default_rng(seed)
    return tuple(
        rng.poisson(np.maximum(spectra[r, :win.n_bins], 0.0)).astype(
            np.float64)
        for r, win in enumerate(problem.windows))
