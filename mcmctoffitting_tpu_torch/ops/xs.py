"""d(d,n)3He zero-degree cross-section spline (host numpy).

Port of ``mcmctoffitting_tpu/ops/xs.py``: the same 61-point sigma(E_d)
table, not-a-knot spline and [20, 10000] keV query clamp, plus its exact
re-segmentation onto a uniform 10 keV grid.
"""
from __future__ import annotations

import numpy as np

from .interp import CubicSpline1D, UniformCubicSpline1D

# keV: 20..100 step 10, 150..1000 step 50, 1100..3000 step 100,
# 3500..10000 step 500
DDN_ENERGIES_KEV = np.concatenate([
    np.arange(20, 101, 10, dtype=np.float64),
    np.arange(150, 1001, 50, dtype=np.float64),
    np.arange(1100, 3001, 100, dtype=np.float64),
    np.arange(3500, 10001, 500, dtype=np.float64),
])

DDN_SIGMA_ZERO = np.array([
    0.025, 0.125, 0.31, 0.52, 0.78, 1.06, 1.35, 1.66, 2.00,
    3.33, 4.6, 5.9, 7.1, 8.3, 9.4, 10.4, 11.4, 12.4, 13.4, 14.3,
    15.1, 15.8, 16.5, 17.2, 17.8, 18.4, 19.0, 20.0, 21.0, 21.9,
    22.7, 23.4, 24.0, 24.6, 25.2, 25.8, 26.4, 26.9, 27.5, 28.0,
    28.4, 28.9, 29.3, 29.8, 30.3, 30.7, 31.2, 33.5, 35.7, 37.8,
    40.0, 41.5, 42.9, 43.8, 44.6, 45.2, 45.7, 46.1, 46.4, 46.5,
    46.5,
], dtype=np.float64)

if DDN_ENERGIES_KEV.shape != DDN_SIGMA_ZERO.shape:
    raise ValueError("DDN cross-section table shapes disagree")


def build_ddn_xs_spline() -> CubicSpline1D:
    """Cubic spline sigma_DDN(E_d) with [20, 10000] keV query clamping."""
    return CubicSpline1D.build(DDN_ENERGIES_KEV, DDN_SIGMA_ZERO,
                               lo_clamp=20.0, hi_clamp=10000.0)


ddn_xs = build_ddn_xs_spline()
# 10 keV divides every knot spacing of the table, so this is exact
ddn_xs_uniform = UniformCubicSpline1D.from_spline(ddn_xs, step=10.0)
