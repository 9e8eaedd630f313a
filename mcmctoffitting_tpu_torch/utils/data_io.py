"""Experimental data files and synthetic observed data.

Port of ``mcmctoffitting_tpu/utils/data_io.py``:

* :func:`read_multi_standoff_tof_data` — the TAC multi-standoff TSV reader
  (rows of ``lowBinEdge \t run0 \t run1 ...``; an (n_rows, 1 + n_runs)
  array with the bin lower edges in column 0);
* :func:`select_window` — one run's counts inside a TOF window;
* :func:`write_multi_standoff_tof_data` — the same TSV format, written;
* :func:`synthesize_observed`.  The JAX package adds the observation noise
  with ``jax.random.poisson``; here the model spectra come from the port's
  own forward and the noise from numpy's ``Generator.poisson``, both
  seeded by ``seed``.  The two packages therefore synthesise different
  (equally distributed) data from one seed; tests that compare them feed
  the JAX package's observed arrays to the port.
"""
from __future__ import annotations

import numpy as np
import torch


# the truth the oneBD command-line fit synthesises its data at:
# (eLoss, scale, s, N_1..N_3, BG_1..BG_3)
ONEBD_TRUTH = np.array([1300.0, 80.0, 0.6, 5e4, 5e4, 5e4, 20.0, 20.0, 20.0])


def read_multi_standoff_tof_data(filename: str,
                                 n_runs: int = 4) -> np.ndarray:
    """Read tab-separated multi-standoff TOF data.

    Column 0: lower bin edge (ns); columns 1..n_runs: per-run counts.
    """
    rows = []
    with open(filename) as f:
        for line in f:
            if not line.strip():
                continue
            parts = line.split("\t")
            rows.append([float(parts[0])]
                        + [float(p) for p in parts[1: 1 + n_runs]])
    return np.asarray(rows)


def select_window(tof_data: np.ndarray, run: int, lo: float, hi: float):
    """Counts and bin edges of one run inside [lo, hi)."""
    edges = tof_data[:, 0]
    mask = (edges >= lo) & (edges < hi)
    return tof_data[mask, run + 1], edges[mask]


def write_multi_standoff_tof_data(filename: str, lower_edges, counts):
    """Write the TSV format (counts: (n_rows, n_runs))."""
    counts = np.asarray(counts)
    with open(filename, "w") as f:
        for i, edge in enumerate(np.asarray(lower_edges)):
            cols = "\t".join(str(float(c)) for c in counts[i])
            f.write(f"{float(edge)}\t{cols}\n")


def synthesize_observed(seed: int, problem,
                        theta_truth) -> tuple[np.ndarray, ...]:
    """Per-run Poisson-fluctuated count histograms at ``theta_truth``
    (float64 arrays, one per run window), for any joint-fit problem
    (``run_spectra``, ``windows``, ``device``): the model spectra as the
    likelihood sees them, the background included where the problem has
    one."""
    theta = torch.as_tensor(np.asarray(theta_truth, np.float32),
                            device=problem.device)[None]
    generator = torch.Generator().manual_seed(seed)    # the forward's draws
    spectra = problem.run_spectra(theta, generator)[0]
    spectra = spectra.double().cpu().numpy()
    rng = np.random.default_rng(seed)
    return tuple(
        rng.poisson(np.maximum(spectra[r, :win.n_bins], 0.0)).astype(
            np.float64)
        for r, win in enumerate(problem.windows))
