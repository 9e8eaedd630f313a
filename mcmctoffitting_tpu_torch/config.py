"""Binning configuration.

The port's own copy of what it uses from ``mcmctoffitting_tpu/config.py``:
the immutable, hashable ``Binning`` and the simultFit binnings.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .constants import TUNL_SSA_CSI


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


# simultFit-era binning
SIMULTFIT_ED_BINNING = Binning(200.0, 1200.0, 50)
SIMULTFIT_X_BINNING = Binning(0.0, TUNL_SSA_CSI.cell_length, 10)
