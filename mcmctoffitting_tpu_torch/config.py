"""Binning configuration.

The port's own copy of what it uses from ``mcmctoffitting_tpu/config.py``:
the immutable, hashable ``Binning``, the simultFit and oneBD binnings and
the oneBD cell-attenuation weights.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .constants import TUNL_SSA_CSI, TUNL_SSA_CSI_ONEBD, onebd_consts


@dataclasses.dataclass(frozen=True)
class Binning:
    """Uniform binning over a closed range, [lo, hi] with n bins."""

    lo: float
    hi: float
    n: int

    @property
    def width(self) -> float:
        return (self.hi - self.lo) / self.n

    @functools.cached_property
    def centers(self) -> np.ndarray:
        """Bin centers, float64 numpy."""
        w = self.width
        return np.linspace(self.lo + w / 2, self.hi - w / 2, self.n)

    @functools.cached_property
    def edges(self) -> np.ndarray:
        return np.linspace(self.lo, self.hi, self.n + 1)

    @property
    def range(self) -> tuple[float, float]:
        return (self.lo, self.hi)

    def __hash__(self):
        return hash((self.lo, self.hi, self.n))


def deuteron_binning_onebd(n_bins: int = 400, lo: float = 200.0,
                           hi: float = 2200.0) -> Binning:
    """Canonical oneBD deuteron-energy binning."""
    return Binning(lo, hi, n_bins)


def x_binning_onebd(n_bins: int = 20, lo: float = 0.0,
                    hi: float = TUNL_SSA_CSI_ONEBD.cell_length) -> Binning:
    """Canonical oneBD cell-depth binning."""
    return Binning(lo, hi, n_bins)


def cell_attenuation_coeffs(x_points: np.ndarray) -> np.ndarray:
    """Beam-flux attenuation weights along the gas cell, exp(-x / 20 cm)."""
    return np.exp(-np.asarray(x_points)
                  / onebd_consts.gas_cell_attenuation_length)


# simultFit-era binning
SIMULTFIT_ED_BINNING = Binning(200.0, 1200.0, 50)
SIMULTFIT_X_BINNING = Binning(0.0, TUNL_SSA_CSI.cell_length, 10)

# csi_oneBD presets: default (100 eD x 10 x) and -hardcore (400 x 20)
ONEBD_ED_BINNING_DEFAULT = deuteron_binning_onebd(100)
ONEBD_ED_BINNING_HARDCORE = deuteron_binning_onebd(400)
ONEBD_X_BINNING_DEFAULT = x_binning_onebd(10)
ONEBD_X_BINNING_HARDCORE = x_binning_onebd(20)
