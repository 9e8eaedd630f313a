"""The simultFit joint multi-standoff fit: theta = (beamE, eLoss, scale, s,
N_1..N_nruns), one spectrum and one binned Poisson likelihood per run.

Port of ``mcmctoffitting_tpu/models/simult.py``: the same preset
(:func:`default_spec`, every argument), bounds, guesses and walker
initialisation; the batched log-probability over (W, D) walkers is
``models/problem.py``'s.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..config import SIMULTFIT_ED_BINNING, SIMULTFIT_X_BINNING
from ..constants import TUNL_SSA_CSI, tof_windows
from ..ops.e0grid import cached_e0_grid_table
from ..ops.stopping import StoppingTable, d2_gas_stopping
from ..ops.timing import ExGaussianTiming
from ..ops.xs import ddn_xs_uniform
from .forward import ForwardSpec, ForwardTables
from .problem import JointFitProblem, ObservedRuns  # noqa: F401

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

    The default is the mc estimator on the stopping table through the
    e0grid operator (F = 256 fine cells); ``xs_mode`` 'taylor' and 'exact'
    look the table up per sample.  ``sampling`` 'counts' (F = 512 at >=
    100k draws, 1024 below) and 'expected' (F = 256) ride the e0grid
    operator whatever ``xs_mode`` says and need ``transport='table'``;
    ``fine_grid`` overrides F.  ``transport='rk4'`` is the literal ODE path
    (one RK4 substep per x interval), where an 'e0grid' ``xs_mode`` falls
    back to 'taylor' as in the JAX package.
    """
    rho = 8.565e-5
    if sampling in ("expected", "counts"):
        if transport != "table":
            raise ValueError(f"sampling='{sampling}' requires "
                             "transport='table' (the closed-form moments "
                             "ride the e0grid preimage operator)")
        xs_mode = "e0grid"
    if sampling == "counts":
        e0_grid_fine = 512 if n_samples >= 100_000 else 1024
    else:
        e0_grid_fine = 256
    if fine_grid is not None:
        e0_grid_fine = int(fine_grid)
    if xs_mode == "e0grid" and transport != "table":
        xs_mode = "taylor"  # the e0grid preimages invert the stopping table
    table = _build_table(rho) if transport == "table" else None
    spec = ForwardSpec(
        geometry=TUNL_SSA_CSI,
        ed_binning=SIMULTFIT_ED_BINNING,
        x_binning=SIMULTFIT_X_BINNING,
        stopping=d2_gas_stopping(rho=rho),
        transport=transport,
        stopping_table=table,
        rk4_substeps=1,
        beam_timing=ExGaussianTiming(),
        zero_degree="segments",
        cell_attenuation=False,
        n_samples=n_samples,
        xs_mode=xs_mode,
        e0_grid_fine=e0_grid_fine,
        sampling=sampling,
    )
    if xs_mode != "e0grid":
        return spec
    return dataclasses.replace(spec, e0_grid_table=cached_e0_grid_table(
        table, SIMULTFIT_ED_BINNING, ddn_xs_uniform, e0_grid_fine))


class SimultFitProblem(JointFitProblem):
    """The simultFit joint-fit problem on one device (see
    :class:`models.problem.JointFitProblem` for ``likelihood``, ``tables``
    and ``device``): theta = (beamE, eLoss, scale, s, N_1..N_R)."""

    RUN_LAYOUT = RUN_LAYOUT
    WINDOWS = tof_windows

    def __init__(self, spec: ForwardSpec, n_runs: int = 4,
                 likelihood: str = "reference", *, device="cuda",
                 tables: ForwardTables | None = None):
        super().__init__(spec, n_runs, likelihood, device=device,
                         tables=tables)

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

    def shared_params(self, thetas: torch.Tensor) -> torch.Tensor:
        """(beamE, eLoss, scale, s): (..., D) -> (..., 4)."""
        return thetas[..., :4]

    def split_theta(self, thetas: torch.Tensor):
        """(W, D) -> (beam parameters (W, 4), run scales (W, R), no
        background)."""
        return (self.shared_params(thetas), thetas[:, 4:4 + self.n_runs],
                None)

    def guess_theta(self, observed) -> np.ndarray:
        """Shared guesses + per-run scale = observed totals."""
        scale_guesses = np.array([float(np.sum(o)) for o in observed])
        return np.concatenate([GUESS_SHARED, scale_guesses])

    def agitators(self, guesses: np.ndarray) -> np.ndarray:
        """Widths of the initial walker ball around ``guesses``."""
        return np.concatenate([AGITATORS_SHARED,
                               0.15 * guesses[4: 4 + self.n_runs]])
