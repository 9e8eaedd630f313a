"""The mc estimator's own stages on the simultFit ODE path, in plain
PyTorch and NumPy: the truncated lognormal beam draw, the RK4 transport
of every sample through the gas cell, the moment histograms of the
transported energies, the cross section's Taylor coefficients, and the
stopping-table lookup that stands in for the ODE in the benchmark's
control.

The arithmetic is the program's as of this benchmark's first mc cell
(float32, the closed-form dE/dx, one RK4 substep per x interval, the 20
keV floor), so that on the same seed words the draws and the transported
energies are the program's bit for bit; the moment histograms are summed
in float64 and rounded to float32 once.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .forward import ndtr
from .tables import (AVOGADRO, FIXED_FACTOR, M_DEUTERON, M_ELECTRON,
                     SPEED_OF_LIGHT, Binning, StoppingTable, UniformXS)

TINY = 1.1754943508222875e-38          # float32 tiny: the uniforms' floor
ENERGY_FLOOR = 20.0                    # keV: a sample at it is frozen
EXCITATION = 19.2e-3                   # keV, deuterium
TABLE_BINNING = (20.0, 2420.0, 25.0)   # e0 grid of the stopping table


def f32(value: float) -> float:
    """A host float rounded to float32."""
    return float(np.float32(value))


# --- the beam draw -------------------------------------------------------------

def beam_uniforms(shape, words, device) -> torch.Tensor:
    """Uniforms in [tiny, 1) of ``shape`` on ``device``, from a generator
    there seeded by the two 32-bit seed words (lo, hi) as one 64-bit
    seed, hi << 32 | lo."""
    lo, hi = words
    gen = torch.Generator(device=device)
    gen.manual_seed((hi << 32) | lo)
    u = torch.rand(shape, generator=gen, device=device)
    return torch.clamp_min(u, TINY)


def beam_energies(u: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """e0 = beamE - (eLoss + scale exp(s z)), z = ndtri(u Phi(z_max)) with
    z_max = ln((beamE - eLoss) / scale) / s: the lognormal truncated to
    e0 > 0 by its inverse CDF.  ``u`` (W, ..., N), ``params`` (W, 4);
    parameters with no room (beamE <= eLoss, scale <= 0 or s <= 0) take
    the untruncated inverse."""
    lead = (slice(None),) + (None,) * (u.dim() - 1)
    beam_e, e_loss, scale, s = (params[:, k][lead] for k in range(4))
    headroom = beam_e - e_loss
    valid = (headroom > 0.0) & (scale > 0.0) & (s > 0.0)
    safe_head = torch.where(valid, headroom, 1.0)
    safe_scale = torch.where(scale > 0.0, scale, 1.0)
    safe_s = torch.where(s > 0.0, s, 1.0)
    z_max = torch.log(safe_head / safe_scale) / safe_s
    cdf_max = torch.where(valid, ndtr(z_max), 1.0)
    z = torch.special.ndtri(u * cdf_max)
    return beam_e - (e_loss + scale * torch.exp(s * z))


# --- the transport -------------------------------------------------------------

class Rk4(NamedTuple):
    """The transport's float32 constants: dE/dx = -(a/E)(p + q ln E) at
    E = max(e, floor), and per x interval the step h, h/2 and h/6."""
    a: float
    p: float
    q: float
    floor: float
    substeps: int
    h: tuple
    half_h: tuple
    sixth_h: tuple


def rk4_constants(rho: float, x_centers, substeps: int = 1) -> Rk4:
    """The Bethe stopping of a deuteron (Z 1, A 2) in D2 gas of density
    ``rho`` g/cm^3, with v^2 = 2 E c^2 / m_d, reduced to the closed form:
    a = k 4 pi m_d / (2 m_e c^4), q = n_e, p = n_e ln(4 m_e / (m_d I));
    RK4 through the x centres from x = 0, ``substeps`` steps an
    interval.  Host float64, each constant rounded to float32 once."""
    c2 = SPEED_OF_LIGHT ** 2
    a = FIXED_FACTOR * 4.0 * np.pi * 1.0 ** 2 * M_DEUTERON / (
        2.0 * M_ELECTRON * c2 * c2)
    n_e = np.array([AVOGADRO * 1.0 * rho / (2.0 * 1.0)])
    p = float(np.sum(n_e * np.log(4.0 * M_ELECTRON / (
        M_DEUTERON * np.array([EXCITATION])))))
    n_e = float(n_e.sum())
    spans = np.diff(np.concatenate([[0.0], np.asarray(x_centers,
                                                      np.float64)]))
    h = [v / substeps for v in spans.tolist()]
    return Rk4(f32(a), f32(p), f32(n_e), f32(ENERGY_FLOOR), int(substeps),
               tuple(f32(v) for v in h), tuple(f32(0.5 * v) for v in h),
               tuple(f32(v / 6.0) for v in h))


def dedx(c: Rk4, e: torch.Tensor) -> torch.Tensor:
    """-(a/E)(p + q ln E), E = max(e, floor), float32; a/E a true
    division."""
    e = torch.clamp_min(e, c.floor)
    a = torch.tensor(c.a, dtype=e.dtype, device=e.device)
    return -(a / e) * (c.q * torch.log(e) + c.p)


def rk4_interval(c: Rk4, e: torch.Tensor, m: int) -> torch.Tensor:
    """Energies ``e`` carried through x interval ``m``: a sample at or
    below the floor stays; k1..k4 at the clamped energies; the step
    (h/6)((k1 + 2 k2) + 2 k3 + k4), clamped to the floor."""
    h, half_h, sixth_h = c.h[m], c.half_h[m], c.sixth_h[m]
    for _ in range(c.substeps):
        stopped = e <= c.floor
        k1 = dedx(c, e)
        k2 = dedx(c, e + half_h * k1)
        k3 = dedx(c, e + half_h * k2)
        k4 = dedx(c, e + h * k3)
        step = ((k1 + 2.0 * k2) + 2.0 * k3) + k4
        e = torch.where(stopped, e, torch.clamp_min(e + sixth_h * step,
                                                    c.floor))
    return e


def transport(c: Rk4, e0: torch.Tensor) -> torch.Tensor:
    """(..., N) initial energies -> (..., M, N) energies at the depths."""
    out, e = [], e0
    for m in range(len(c.h)):
        e = rk4_interval(c, e, m)
        out.append(e)
    return torch.stack(out, dim=-2)


class TableLookup:
    """The stopping table E(e0, x) (``tables.StoppingTable``: float64 RK4
    of the full Bethe formula, 64 substeps, a cubic spline along e0) read
    in float32 at each depth: the control's stand-in for the ODE."""

    def __init__(self, table: StoppingTable, device):
        self.lo = float(table.e0_grid[0])
        self.step = float(table.e0_grid[1] - table.e0_grid[0])
        self.n_seg = table.e0_grid.shape[0] - 1
        # (4, M, G - 1): each depth's segments along the last axis
        self.coeffs = torch.as_tensor(np.ascontiguousarray(np.transpose(
            table.coeffs, (0, 2, 1)).astype(np.float32)), device=device)

    def at(self, e0: torch.Tensor, m: int) -> torch.Tensor:
        """Energies at depth ``m`` of initial energies ``e0``."""
        u = torch.nan_to_num((e0 - self.lo) / self.step, nan=0.0)
        idx = torch.clamp(u, 0.0, self.n_seg - 1.0).to(torch.int64)
        dt = e0 - (self.lo + self.step * idx.to(e0.dtype))
        c3, c2, c1, c0 = (self.coeffs[k, m][idx] for k in range(4))
        return ((c3 * dt + c2) * dt + c1) * dt + c0


# --- the moment histograms -----------------------------------------------------

def moment_sums(e: torch.Tensor, bins: Binning) -> torch.Tensor:
    """(rows, N) energies -> (rows, 4, n) float64 sums over each eD bin
    of (1, d, d^2, d^3), d = u - bin - 1/2 with u = (e - lo) n / (hi - lo)
    in float32; energies outside [lo, hi] (and NaN) add nothing."""
    rows, n = e.shape[0], bins.n
    inv_width = f32(n / (bins.hi - bins.lo))
    u = (e - bins.lo) * inv_width
    idx = torch.clamp(torch.floor(u), 0, n - 1)
    inside = (e >= bins.lo) & (e <= bins.hi)
    d = (u - idx) - 0.5
    d2 = d * d
    chans = torch.stack([torch.ones_like(d), d, d2, d2 * d], dim=1)
    chans = torch.where(inside[:, None], chans, 0.0).double()
    cells = (torch.where(inside, idx, 0.0).long()[:, None]
             + n * torch.arange(4, device=e.device)[:, None])
    out = torch.zeros((rows, 4 * n), dtype=torch.float64, device=e.device)
    out.scatter_add_(1, cells.reshape(rows, -1), chans.reshape(rows, -1))
    return out.reshape(rows, 4, n)


def transport_moments(e0: torch.Tensor, bins: Binning, n_x: int,
                      interval) -> torch.Tensor:
    """(rows, N) initial energies -> (rows, M, 4, Be) moment histograms of
    the energies at the M depths, each summed in float64 and rounded to
    float32 once.  ``interval(e, e0, m)`` gives the energies at depth m
    from those at depth m - 1 (``e``) or from the start (``e0``)."""
    out = torch.empty((e0.shape[0], n_x, 4, bins.n), dtype=torch.float32,
                      device=e0.device)
    e = e0
    for m in range(n_x):
        e = interval(e, e0, m)
        out[:, m] = moment_sums(e, bins).float()
    return out


# --- the cross section's Taylor coefficients --------------------------------

def taylor_coefficients(ed: Binning) -> np.ndarray:
    """(4, Be) float64: sigma_DDN and its first three derivatives at the
    eD bin centres (the uniform 10 keV re-segmentation of the not-a-knot
    spline, queries clamped to [20, 10000] keV, derivatives 0 outside),
    times 1, w, w^2/2 and w^3/6 with w the bin width: the grid of a bin
    is sum_k coefficient_k x (its sum of d^k)."""
    xs = UniformXS()
    t = np.asarray(ed.centers, np.float64)
    tc = np.clip(t, *xs.clamp)
    n_cells = xs.coeffs.shape[1]
    idx = np.clip(((tc - xs.lo) / xs.step).astype(np.int64), 0, n_cells - 1)
    dt = tc - (xs.lo + xs.step * idx)
    c3, c2, c1, c0 = (xs.coeffs[k][idx] for k in range(4))
    s0 = ((c3 * dt + c2) * dt + c1) * dt + c0
    outside = (t < xs.clamp[0]) | (t > xs.clamp[1])
    s1, s2, s3 = (np.where(outside, 0.0, v) for v in (
        (3 * c3 * dt + 2 * c2) * dt + c1, 6 * c3 * dt + 2 * c2, 6 * c3))
    w = ed.width
    return np.stack([s0, s1 * w, 0.5 * s2 * w * w, (1.0 / 6.0) * s3 * w ** 3])
