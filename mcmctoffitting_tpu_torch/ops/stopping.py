"""Bethe stopping in the deuterium gas, per-sample RK4 transport and the
E(E0, x) transport table.

Port of ``mcmctoffitting_tpu/ops/stopping.py``: the material constants,
``BetheStopping.dedx`` and ``with_material``, the Havar foil
(``havar_stopping``), ``rk4_transport``, the f64 RK4 used to build the
table and the table's spline coefficients (host arithmetic equal to the
JAX package's, so the tables are bitwise equal), plus the closed form
dE/dx = -(A/E)(P + Q ln E) of ``ops/pallas_forward.py``.

The mc path transports every sample with the closed form, in float32, in
the operation order of kernel K4 (``csrc/transport_moments.cu``), so the
plain version and the kernel round alike.  The table lookup
(``StoppingTable.eval_stopped``, :func:`eval_stopped`) serves the mc
estimator on ``transport='table'`` with ``xs_mode`` 'taylor' or 'exact';
the e0grid paths read the table only through the e0-grid operator
(``ops/e0grid.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..constants import masses, physics
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

    def with_material(self, Z, A, rho, excitation_keV) -> "BetheStopping":
        """A copy with one more material (the reference's ``addMaterial``,
        ``utilities/ionStopping.py:71-76``)."""
        return dataclasses.replace(
            self, materials=self.materials + ((Z, A, rho, excitation_keV),))

    def _electron_densities(self) -> np.ndarray:
        return np.array([
            AVOGADRO * Z * rho / (A * physics.molar_mass_constant)
            for (Z, A, rho, _) in self.materials
        ])

    def dedx(self, energy: torch.Tensor) -> torch.Tensor:
        """Stopping power dE/dx in keV/cm (negative) at deuteron energies
        in keV: the full Bethe formula, as the JAX package writes it."""
        c2 = physics.speed_of_light ** 2
        v2 = 2.0 * energy / self.ion_mass * c2
        leading = (4.0 * math.pi * self.ion_charge ** 2
                   / (masses.electron * c2 * v2))
        n_e = torch.as_tensor(self._electron_densities(), dtype=energy.dtype,
                              device=energy.device)
        exc = torch.as_tensor([m[3] for m in self.materials],
                              dtype=energy.dtype, device=energy.device)
        log_arg = 2.0 * masses.electron / c2 * v2[..., None] / exc
        contributions = torch.sum(n_e * torch.log(log_arg), dim=-1)
        return -leading * FIXED_FACTOR * contributions


def bethe_closed_form_constants(stopping: BetheStopping):
    """(A, P, Q), host floats, with dE/dx = -(A/E) (P + Q ln E): the
    algebraic reduction of :meth:`BetheStopping.dedx` with v^2 = 2 E c^2 /
    m_ion (the arithmetic of the JAX package's
    ``ops/pallas_forward.py::bethe_closed_form_constants``)."""
    c2 = physics.speed_of_light ** 2
    a = (FIXED_FACTOR * 4.0 * np.pi * stopping.ion_charge ** 2
         * stopping.ion_mass / (2.0 * masses.electron * c2 * c2))
    n_e = stopping._electron_densities()
    excitations = np.array([m[3] for m in stopping.materials])
    q = float(n_e.sum())
    p = float(np.sum(n_e * np.log(4.0 * masses.electron
                                  / (stopping.ion_mass * excitations))))
    return float(a), p, q


def _f32(x: float) -> float:
    """A host float rounded to float32, as the kernels receive it."""
    return float(np.float32(x))


class RK4Constants(NamedTuple):
    """Everything the transport needs, as float32 values (Python floats
    that are exact in float32): the closed-form (A, P, Q), the energy
    floor, and per x interval the step h, h/2 and h/6 (host f64, rounded
    once)."""

    a: float
    p: float
    q: float
    energy_floor: float
    n_substeps: int
    h: tuple[float, ...]
    half_h: tuple[float, ...]
    sixth_h: tuple[float, ...]


def rk4_constants(stopping: BetheStopping, x_eval, n_substeps: int,
                  energy_floor: float = 20.0,
                  bethe=None) -> RK4Constants:
    """Float32 constants of :func:`rk4_transport` and kernel K4 through
    the depths ``x_eval`` (from x = 0); ``bethe`` overrides the (A, P, Q)
    computed from ``stopping``."""
    a, p, q = (bethe_closed_form_constants(stopping) if bethe is None
               else bethe)
    x_eval = np.asarray(x_eval, np.float64)
    spans = np.diff(np.concatenate([[0.0], x_eval]))
    h = [s / n_substeps for s in spans.tolist()]
    return RK4Constants(_f32(a), _f32(p), _f32(q), _f32(energy_floor),
                        int(n_substeps), tuple(_f32(v) for v in h),
                        tuple(_f32(0.5 * v) for v in h),
                        tuple(_f32(v / 6.0) for v in h))


def closed_form_dedx(c: RK4Constants, e: torch.Tensor) -> torch.Tensor:
    """-(A/E) (P + Q ln E) at E = max(e, floor), float32, in K4's order:
    A/E is a true division (a scalar numerator divides exactly on every
    device), then the product with (P + Q ln E)."""
    e = torch.clamp_min(e, c.energy_floor)
    a = torch.tensor(c.a, dtype=e.dtype)
    return -(a / e) * (c.q * torch.log(e) + c.p)


def rk4_transport(c: RK4Constants, e0: torch.Tensor) -> torch.Tensor:
    """Fixed-step RK4 of the closed-form dE/dx through the x depths:
    (..., N) initial energies -> (..., M, N) energies at each depth.

    Operation order of the JAX package's ``rk4_transport`` and of K4:
    a sample at or below the floor is frozen; k1..k4 clamp their argument
    to the floor inside dE/dx; e_new = max(e + h/6 (k1 + 2 k2 + 2 k3 + k4),
    floor).
    """
    floor = c.energy_floor
    e = e0
    out = []
    for h, half_h, sixth_h in zip(c.h, c.half_h, c.sixth_h):
        for _ in range(c.n_substeps):
            stopped = e <= floor
            k1 = closed_form_dedx(c, e)
            k2 = closed_form_dedx(c, e + half_h * k1)
            k3 = closed_form_dedx(c, e + half_h * k2)
            k4 = closed_form_dedx(c, e + h * k3)
            step = ((k1 + 2.0 * k2) + 2.0 * k3) + k4
            e_new = torch.clamp_min(e + sixth_h * step, floor)
            e = torch.where(stopped, e, e_new)
        out.append(e)
    return torch.stack(out, dim=-2)


def d2_gas_stopping(rho: float = 8.565e-5) -> BetheStopping:
    """Deuterium gas cell medium (rho g/cm^3, mean excitation 19.2 eV)."""
    return BetheStopping(materials=((1.0, 2.0, rho, 19.2e-3),))


# Havar alloy: (Z, atomic mass, SRIM atomic fraction, excitation keV)
# (the reference's ``utilities/ionStopping.py:140-176``), bulk density 8.3
# g/cm^3
_HAVAR_COMPONENTS = (
    (27.0, 58.933195, 0.417829, 0.2970),
    (24.0, 51.9961, 0.222858, 0.2570),
    (28.0, 58.6934, 0.128336, 0.3110),
    (74.0, 183.84, 0.008824, 0.7270),
    (42.0, 95.94, 0.014494, 0.4240),
    (25.0, 54.938045, 0.016874, 0.2720),
    (26.0, 55.845, 0.181139, 0.2860),
    (6.0, 12.011, 0.009648, 0.078),
)


def havar_stopping() -> BetheStopping:
    """Havar foil stopping model (``utilities/ionStopping.py:138-184``)."""
    return BetheStopping(materials=tuple(
        (Z, A, 8.3 * frac, exc) for (Z, A, frac, exc) in _HAVAR_COMPONENTS))


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

    def coeffs_tensor(self, device) -> torch.Tensor:
        """The spline coefficients as :func:`eval_stopped` reads them:
        (4, M, G-1) float32 on ``device`` (segments along the last axis)."""
        return torch.as_tensor(
            np.ascontiguousarray(
                np.transpose(self.coeffs, (0, 2, 1)).astype(np.float32)),
            device=device)

    def eval_stopped(self, e_zero: torch.Tensor,
                     coeffs: torch.Tensor | None = None) -> torch.Tensor:
        """E at every x column for each sample, in the JAX package's
        layout: (..., N) -> (..., N, M)."""
        if coeffs is None:
            coeffs = self.coeffs_tensor(e_zero.device)
        return eval_stopped(self, e_zero, coeffs).movedim(-2, -1)

    def __hash__(self):
        return hash((self.e0_grid.tobytes(), self.x_centers.tobytes(),
                     self.table.tobytes()))

    def __eq__(self, other):
        return (isinstance(other, StoppingTable)
                and np.array_equal(self.e0_grid, other.e0_grid)
                and np.array_equal(self.x_centers, other.x_centers)
                and np.array_equal(self.table, other.table))


def eval_stopped(table: StoppingTable, e0: torch.Tensor,
                 coeffs: torch.Tensor) -> torch.Tensor:
    """Table lookup of the energies at every depth, in the layout of
    :func:`rk4_transport`: (..., N) initial energies -> (..., M, N).

    The E0 grid is uniform, so the segment index is arithmetic:
    ``int((e - lo) / step)`` (truncation toward zero, then clipped to the
    table: energies outside it extrapolate the end segments), ``dt = e -
    (lo + step idx)``, then Horner in float32 on the segment's cubic.  The
    coefficients (``table.coeffs_tensor``) are gathered per (depth, sample);
    a NaN energy reads segment 0 and stays NaN.
    """
    lo = float(table.e0_grid[0])
    step = float(table.e0_grid[1] - table.e0_grid[0])
    n_seg = table.e0_grid.shape[0] - 1
    n_x = coeffs.shape[1]
    u = torch.nan_to_num((e0 - lo) / step, nan=0.0)
    # truncation then a clip to [0, n_seg - 1] is a clip then truncation
    idx = torch.clamp(u, 0.0, n_seg - 1.0).to(torch.int64)
    dt = (e0 - (lo + step * idx.to(e0.dtype)))[..., None, :]
    lead = e0.shape[:-1]
    at = idx[..., None, :].expand(lead + (n_x, e0.shape[-1]))
    c3, c2, c1, c0 = (
        torch.gather(coeffs[k].expand(lead + coeffs.shape[1:]), -1, at)
        for k in range(4))
    return ((c3 * dt + c2) * dt + c1) * dt + c0


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
