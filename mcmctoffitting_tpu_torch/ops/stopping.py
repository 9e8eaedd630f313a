"""Bethe stopping in the deuterium gas and the E(E0, x) transport table.

Port of the host half of ``mcmctoffitting_tpu/ops/stopping.py``: the
material constants, the f64 RK4 used to build the table and the table's
spline coefficients, with the same arithmetic so the tables are bitwise
equal to the JAX package's.  The counts path reads the table only through
the e0-grid operator (``ops/e0grid.py``), so per-sample transport
(``eval_stopped``, ``rk4_transport``) is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from mcmctoffitting_tpu.constants import masses, physics

from .interp import cubic_spline_coeffs

AVOGADRO = 6.02214076e23

# (e^2 / 4 pi eps0)^2 in the keV-cm-ns unit system
FIXED_FACTOR = 1.67489e-14


@dataclasses.dataclass(frozen=True)
class BetheStopping:
    """Multi-material simple Bethe stopping model.

    ``materials``: tuple of (Z, A, rho_g_cm3, mean_excitation_keV).
    """

    materials: tuple[tuple[float, float, float, float], ...]
    ion_charge: float = 1.0
    ion_mass: float = masses.deuteron

    def _electron_densities(self) -> np.ndarray:
        return np.array([
            AVOGADRO * Z * rho / (A * physics.molar_mass_constant)
            for (Z, A, rho, _) in self.materials
        ])


def d2_gas_stopping(rho: float = 8.565e-5) -> BetheStopping:
    """Deuterium gas cell medium (rho g/cm^3, mean excitation 19.2 eV)."""
    return BetheStopping(materials=((1.0, 2.0, rho, 19.2e-3),))


@dataclasses.dataclass(frozen=True)
class StoppingTable:
    """Precomputed E(E0, x) transport table with cubic-spline coefficients
    along E0 for every x column."""

    e0_grid: np.ndarray       # (G,)
    x_centers: np.ndarray     # (M,)
    table: np.ndarray         # (G, M)
    coeffs: np.ndarray        # (4, G-1, M)

    @classmethod
    def build(cls, stopping: BetheStopping, e0_bin_info, x_centers,
              n_substeps: int = 64,
              energy_floor: float | None = None) -> "StoppingTable":
        """e0_bin_info = (minE, maxE, step); ``energy_floor`` freezes rows
        at that energy during the build (None integrates unguarded)."""
        lo, hi, step = e0_bin_info
        e0_grid = np.arange(lo, hi, step, dtype=np.float64)
        x_centers = np.asarray(x_centers, dtype=np.float64)
        table = _rk4_transport_np(stopping, e0_grid, x_centers, n_substeps,
                                  energy_floor=energy_floor)
        coeffs = cubic_spline_coeffs(e0_grid, table)
        return cls(e0_grid, x_centers, table.T.copy().T, coeffs)

    def __hash__(self):
        return hash((self.e0_grid.tobytes(), self.x_centers.tobytes(),
                     self.table.tobytes()))

    def __eq__(self, other):
        return (isinstance(other, StoppingTable)
                and np.array_equal(self.e0_grid, other.e0_grid)
                and np.array_equal(self.x_centers, other.x_centers)
                and np.array_equal(self.table, other.table))


def _rk4_transport_np(stopping: BetheStopping, e0, x_eval, n_substeps,
                      energy_floor: float | None = None):
    """Host f64 RK4 of dE/dx through the x evaluation points."""
    n_e = stopping._electron_densities()
    excitations = np.array([m[3] for m in stopping.materials])

    def dedx(e):
        v2 = 2.0 * e / stopping.ion_mass * physics.speed_of_light ** 2
        leading = (4.0 * np.pi * stopping.ion_charge ** 2
                   / (masses.electron * physics.speed_of_light ** 2 * v2))
        log_arg = (2.0 * masses.electron / physics.speed_of_light ** 2
                   * v2[..., None] / excitations)
        return -leading * FIXED_FACTOR * np.sum(n_e * np.log(log_arg), axis=-1)

    e = np.array(e0, dtype=np.float64)
    out = np.empty((len(e), len(x_eval)))
    x_prev = 0.0
    for j, x in enumerate(x_eval):
        h = (x - x_prev) / n_substeps
        for _ in range(n_substeps):
            if energy_floor is None:
                k1 = dedx(e)
                k2 = dedx(e + 0.5 * h * k1)
                k3 = dedx(e + 0.5 * h * k2)
                k4 = dedx(e + h * k3)
                e = e + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
            else:
                f = energy_floor
                stopped = e <= f
                e_safe = np.maximum(e, f)
                k1 = dedx(e_safe)
                k2 = dedx(np.maximum(e_safe + 0.5 * h * k1, f))
                k3 = dedx(np.maximum(e_safe + 0.5 * h * k2, f))
                k4 = dedx(np.maximum(e_safe + h * k3, f))
                e_new = np.maximum(
                    e_safe + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4), f)
                e = np.where(stopped, e, e_new)
        out[:, j] = e
        x_prev = x
    return out
