"""Instrument timing response: the exGaussian beam pulse and the
10-segment zero-degree transit spread.

Port of ``mcmctoffitting_tpu/ops/timing.py`` (``ExGaussianTiming``,
``ZeroDegreeTimingSpread.times_and_weights``).  The kernels are host numpy
(f64) tables; the 'same'-mode convolution is batched over any leading axes
and written as one float32 matmul against a banded matrix, so it runs in
full float32 on the card (no cuDNN convolution, whose float32 path uses
TF32 by default).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from mcmctoffitting_tpu.constants import TUNL_SSA_CSI, masses

from .kinematics import tof_np


def _exgaussian_np(t, sigma: float, tau: float) -> np.ndarray:
    """Host f64 exGaussian shape: exp(sigma^2/(2 tau^2) - t/tau)
    * erfc((sigma^2 - t tau) / (sqrt(2) sigma tau))."""
    t = np.asarray(t, dtype=np.float64)
    exp_arg = sigma ** 2 / (2.0 * tau ** 2) - t / tau
    erf_arg = (sigma ** 2 - t * tau) / (np.sqrt(2.0) * sigma * tau)
    return np.exp(exp_arg) * np.array([math.erfc(a) for a in erf_arg])


def same_conv_matrix(kernel: np.ndarray, n: int) -> np.ndarray:
    """(n, n) matrix T with ``x @ T == np.convolve(x, kernel, 'same')``
    for len(kernel) <= n: 'same' keeps full[(len(kernel)-1)//2 :][:n]."""
    kernel = np.asarray(kernel, dtype=np.float64)
    off = (len(kernel) - 1) // 2
    i = np.arange(n)[:, None]
    tap = np.arange(n)[None, :] + off - i      # y[j] = sum_i x[i] k[j+off-i]
    valid = (tap >= 0) & (tap < len(kernel))
    return np.where(valid, kernel[np.clip(tap, 0, len(kernel) - 1)], 0.0)


@dataclasses.dataclass(frozen=True)
class ExGaussianTiming:
    """Normalised binned exGaussian kernel: window [ceil(-5 sigma),
    ceil(10 tau)] with 1 ns bins, evaluated at bin centres, unit sum."""

    sigma: float = 1.1910
    tau: float = 1.0110
    bin_width: float = 1.0

    @property
    def kernel(self) -> np.ndarray:
        lo = np.ceil(-5.0 * self.sigma)
        hi = np.ceil(10.0 * self.tau)
        n = int(hi - lo)
        centers = np.linspace(lo + self.bin_width / 2,
                              hi - self.bin_width / 2, n)
        vals = _exgaussian_np(centers, self.sigma, self.tau)
        return vals / vals.sum()

    def apply_spreading(self, spectra: torch.Tensor) -> torch.Tensor:
        """'same'-mode convolution along the last axis of (..., n)."""
        mat = same_conv_matrix(self.kernel, spectra.shape[-1])
        return apply_same_matrix(spectra, torch.as_tensor(
            mat, dtype=spectra.dtype, device=spectra.device))


def apply_same_matrix(spectra: torch.Tensor,
                      mat: torch.Tensor) -> torch.Tensor:
    """(..., n) @ (n, n): the batched 'same' convolution, one matmul."""
    lead = spectra.shape[:-1]
    return (spectra.reshape(-1, spectra.shape[-1]) @ mat).reshape(
        lead + (mat.shape[-1],))


@dataclasses.dataclass(frozen=True)
class ZeroDegreeTimingSpread:
    """10-segment transit-time spread across the 0-degree detector, with
    the Marion+Young n-p elastic cross section
    sigma_np = (4.83 / sqrt(E / MeV) - 0.578) barn."""

    density_h: float = 4.82e22           # protons / cm^3
    length: float = TUNL_SSA_CSI.zero_deg_length
    n_segments: int = 10

    @property
    def x_locs(self) -> np.ndarray:
        seg = self.length / self.n_segments
        return np.linspace(seg / 2, self.length - seg / 2, self.n_segments)

    def times_and_weights(self, neutron_energy):
        """Per-segment (tofs, weights) added to each synthesised TOF:
        neutron_energy (...,) -> two (..., n_segments) float32 arrays.

        Evaluated in float32 with the JAX package's operation order: the
        times feed np.histogram bin edges, so equal rounding keeps every
        lattice sample in the same TOF bin in both packages."""
        e = np.asarray(neutron_energy, dtype=np.float32)[..., None]
        x = self.x_locs.astype(np.float32)
        tofs = tof_np(masses.neutron, e, x)
        xs = (np.float32(4.83) / np.sqrt(e / np.float32(1000.0))
              - np.float32(0.578)) * np.float32(1e-24)
        weights = np.exp(-xs * np.float32(self.density_h) * x)
        weights = weights / np.sum(weights, axis=-1, keepdims=True)
        return tofs, weights
