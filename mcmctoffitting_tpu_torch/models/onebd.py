"""The csi_oneBD joint fit: theta = (eLoss, scale, s, N_1..N_R,
BG_1..BG_R), 3 + 2 R parameters, with the beam reference energy fixed at
2490 keV.

Port of ``mcmctoffitting_tpu/models/onebd.py``: the same preset
(:func:`default_spec`: stopping table on the (100, 2400, 100) keV grid
built unguarded, cell attenuation, Gaussian beam timing (sigma 2.7 ns,
4 ns bins), the exponential zero-degree kernel, no redraw loop, a per-run
Poisson background; binnings 100 eD x 10 x, or 400 x 20 with
``hardcore``), bounds, guesses and walker initialisation; the batched
log-probability over (W, D) walkers is ``models/problem.py``'s.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import deuteron_binning_onebd, x_binning_onebd
from ..constants import TUNL_SSA_CSI_ONEBD, onebd_consts, tof_windows_onebd
from ..ops.e0grid import cached_e0_grid_table
from ..ops.stopping import StoppingTable, d2_gas_stopping
from ..ops.timing import GaussianTiming
from ..ops.xs import ddn_xs_uniform
from .forward import ForwardSpec, ForwardTables
from .problem import JointFitProblem

RUN_LAYOUT = ("close", "mid", "far")

# parameter bounds
ELOSS_LO, ELOSS_HI = 200.0, 2000.0
SCALE_LO, SCALE_HI = 10.0, 700.0
S_LO, S_HI = 0.05, 3.0
NORM_LO, NORM_HI = 1e3, 1.0e8
BG_LO, BG_HI = 0.0, 1e3

# the reference's guess point and the widths of the initial walker ball
GUESS_SHARED = (700.0, 100.0, 0.5)
BG_GUESS = 10.0
AGITATORS_SHARED = (50.0, 10.0, 0.05)
BG_AGITATOR = 2.0

# (E0 min, max, step) keV of the stopping table
STOPPING_TABLE_BINNING = (100.0, 2400.0, 100.0)

# gas density: 4x the simultFit cell's (the 2 atm run)
RHO = 4 * 8.565e-5


@functools.lru_cache(maxsize=8)
def _build_table(rho: float, x_binning_n: int) -> StoppingTable:
    """The table as the reference builds it, unguarded: rows that stop
    inside the cell settle where the Bethe formula changes sign (~17.6
    keV), far below the eD histogram."""
    return StoppingTable.build(d2_gas_stopping(rho=rho),
                               STOPPING_TABLE_BINNING,
                               x_binning_onebd(x_binning_n).centers)


def default_spec(n_samples: int = 200_000, *,
                 fine_grid: int | None = None,
                 hardcore: bool = False,
                 xs_mode: str = "e0grid",
                 sampling: str = "mc") -> ForwardSpec:
    """Forward spec for the oneBD campaign (the JAX preset's values).

    Fine cells F: mc and expected 512 (1024 with ``hardcore``); counts
    1024 at >= 100k draws and 2048 below; ``fine_grid`` overrides.  The
    A operator is rounded to bfloat16 for the hardcore counts fit only
    (there it is (4096, 8000), 131 MB).  'expected' and 'counts' ride the
    e0grid operator whatever ``xs_mode`` says.
    """
    if sampling in ("expected", "counts"):
        xs_mode = "e0grid"
    ed_bins, x_bins = (400, 20) if hardcore else (100, 10)
    if sampling == "counts":
        e0_grid_fine = 1024 if n_samples >= 100_000 else 2048
    else:
        e0_grid_fine = 1024 if hardcore else 512
    if fine_grid is not None:
        e0_grid_fine = int(fine_grid)
    table = _build_table(RHO, x_bins)
    ed_binning = deuteron_binning_onebd(ed_bins)
    e0_grid_table = None
    if xs_mode == "e0grid":
        e0_grid_table = cached_e0_grid_table(table, ed_binning,
                                             ddn_xs_uniform, e0_grid_fine)
    return ForwardSpec(
        geometry=TUNL_SSA_CSI_ONEBD,
        ed_binning=ed_binning,
        x_binning=x_binning_onebd(x_bins),
        stopping=d2_gas_stopping(rho=RHO),
        transport="table",
        stopping_table=table,
        beam_timing=GaussianTiming(2.7, 4),
        zero_degree="expo",
        cell_attenuation=True,
        n_samples=n_samples,
        n_redraw_rounds=0,
        a_dtype=("bfloat16" if hardcore and sampling == "counts"
                 else "float32"),
        xs_mode=xs_mode,
        e0_grid_table=e0_grid_table,
        e0_grid_fine=e0_grid_fine,
        sampling=sampling,
    )


class OneBDProblem(JointFitProblem):
    """The oneBD joint-fit problem on one device (see
    :class:`models.problem.JointFitProblem` for ``likelihood``, ``tables``
    and ``device``)."""

    RUN_LAYOUT = RUN_LAYOUT
    WINDOWS = tof_windows_onebd

    def __init__(self, spec: ForwardSpec, n_runs: int = 3,
                 likelihood: str = "reference", *, device="cuda",
                 tables: ForwardTables | None = None):
        super().__init__(spec, n_runs, likelihood, device=device,
                         tables=tables)

    @property
    def n_dim(self) -> int:
        return 3 + 2 * self.n_runs

    @property
    def param_lo(self) -> np.ndarray:
        return np.concatenate([[ELOSS_LO, SCALE_LO, S_LO],
                               np.full(self.n_runs, NORM_LO),
                               np.full(self.n_runs, BG_LO)])

    @property
    def param_hi(self) -> np.ndarray:
        return np.concatenate([[ELOSS_HI, SCALE_HI, S_HI],
                               np.full(self.n_runs, NORM_HI),
                               np.full(self.n_runs, BG_HI)])

    def shared_params(self, thetas: torch.Tensor) -> torch.Tensor:
        """(beamE, eLoss, scale, s) with the fixed reference beam energy
        prepended: (..., D) -> (..., 4)."""
        beam = torch.full_like(thetas[..., :1],
                               onebd_consts.beam_reference_energy)
        return torch.cat([beam, thetas[..., :3]], dim=-1)

    def split_theta(self, thetas: torch.Tensor):
        """(W, D) -> (beam parameters (W, 4), run scales (W, R),
        background levels (W, R))."""
        r = self.n_runs
        return (self.shared_params(thetas), thetas[:, 3:3 + r],
                thetas[:, 3 + r:3 + 2 * r])

    def guess_theta(self, observed, guesses=GUESS_SHARED,
                    bg_guess: float = BG_GUESS) -> np.ndarray:
        """The reference's guess point: eLoss 700, scale 100, s 0.5,
        background 10, and per-run norms 5 x the observed totals (the model
        spectrum is scale x a density that sums to 1 / 4 ns)."""
        norm_guesses = np.array([5.0 * float(np.sum(o)) for o in observed])
        return np.concatenate([np.asarray(guesses), norm_guesses,
                               np.full(self.n_runs, bg_guess)])

    def agitators(self, guesses: np.ndarray) -> np.ndarray:
        """Widths of the initial walker ball around ``guesses``."""
        return np.concatenate([AGITATORS_SHARED,
                               0.15 * guesses[3: 3 + self.n_runs],
                               np.full(self.n_runs, BG_AGITATOR)])
