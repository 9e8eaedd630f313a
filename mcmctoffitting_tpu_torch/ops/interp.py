"""Cubic-spline construction and host evaluation (numpy, f64).

Port of the host half of ``mcmctoffitting_tpu/ops/interp.py``: the
not-a-knot coefficient solve and the f64 ``eval_np`` of both spline
classes, with the same arithmetic so the tables they feed are bitwise equal
to the JAX package's.  The counts path evaluates no spline on the device,
so the device-side ``__call__`` of the JAX classes is not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def cubic_spline_coeffs(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Not-a-knot interpolating cubic spline coefficients.

    Returns ``c`` of shape (4, n-1) such that on interval [x[i], x[i+1]]:
        f(t) = c[0,i]*(t-x[i])^3 + c[1,i]*(t-x[i])^2 + c[2,i]*(t-x[i]) + c[3,i]
    ``y`` may have trailing batch dims: shape (n, ...) -> c (4, n-1, ...).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = x.shape[0]
    if n < 4:
        raise ValueError("not-a-knot spline needs >= 4 points")
    h = np.diff(x)

    y2 = y.reshape(n, -1)
    m = y2.shape[1]
    slope = np.diff(y2, axis=0) / h[:, None]

    # first derivatives s_i from the not-a-knot banded system
    A = np.zeros((n, n))
    b = np.zeros((n, m))
    for i in range(1, n - 1):
        A[i, i - 1] = h[i]
        A[i, i] = 2.0 * (h[i] + h[i - 1])
        A[i, i + 1] = h[i - 1]
        b[i] = 3.0 * (h[i] * slope[i - 1] + h[i - 1] * slope[i])
    A[0, 0] = h[1]
    A[0, 1] = h[0] + h[1]
    b[0] = ((h[0] + 2.0 * (h[0] + h[1])) * h[1] * slope[0]
            + h[0] * h[0] * slope[1]) / (h[0] + h[1])
    A[-1, -2] = h[-1] + h[-2]
    A[-1, -1] = h[-2]
    b[-1] = ((h[-1] * h[-1] * slope[-2]
              + (2.0 * (h[-1] + h[-2]) + h[-1]) * h[-2] * slope[-1])
             / (h[-1] + h[-2]))

    s = np.linalg.solve(A, b)

    s0 = s[:-1]
    s1 = s[1:]
    hh = h[:, None]
    c3 = (s0 + s1 - 2.0 * slope) / (hh * hh)
    c2 = (3.0 * slope - 2.0 * s0 - s1) / hh
    c1 = s0
    c0 = y2[:-1]
    coeffs = np.stack([c3, c2, c1, c0])
    return coeffs.reshape((4, n - 1) + y.shape[1:])


@dataclasses.dataclass(frozen=True)
class CubicSpline1D:
    """Cubic spline (knots + per-interval coefficients) with optional
    evaluate-time clamping of queries into [lo_clamp, hi_clamp]."""

    knots: np.ndarray        # (n,)
    coeffs: np.ndarray       # (4, n-1)
    lo_clamp: float | None = None
    hi_clamp: float | None = None

    @classmethod
    def build(cls, x, y, lo_clamp=None, hi_clamp=None) -> "CubicSpline1D":
        x = np.asarray(x, dtype=np.float64)
        return cls(x, cubic_spline_coeffs(x, np.asarray(y, dtype=np.float64)),
                   lo_clamp, hi_clamp)

    def eval_np(self, t):
        """Host f64 evaluation."""
        t = np.asarray(t, dtype=np.float64)
        tc = np.clip(t, self.lo_clamp, self.hi_clamp) \
            if (self.lo_clamp is not None or self.hi_clamp is not None) else t
        idx = np.clip(np.searchsorted(self.knots, tc, side="right") - 1,
                      0, len(self.knots) - 2)
        dt = tc - self.knots[idx]
        c3, c2, c1, c0 = (self.coeffs[k][idx] for k in range(4))
        return ((c3 * dt + c2) * dt + c1) * dt + c0


@dataclasses.dataclass(frozen=True)
class UniformCubicSpline1D:
    """A cubic spline re-segmented onto a uniform knot grid: each uniform
    cell stores the coefficients of the source segment containing it,
    re-centred at the cell start (exact when the step divides every source
    knot spacing)."""

    lo: float
    step: float
    coeffs: np.ndarray       # (4, n_cells)
    lo_clamp: float | None = None
    hi_clamp: float | None = None

    @classmethod
    def from_spline(cls, spline: CubicSpline1D,
                    step: float) -> "UniformCubicSpline1D":
        knots = spline.knots
        lo, hi = float(knots[0]), float(knots[-1])
        n_cells = int(round((hi - lo) / step))
        if abs(lo + n_cells * step - hi) > 1e-9 * (hi - lo):
            raise ValueError("step must evenly divide the knot range")
        starts = lo + step * np.arange(n_cells)
        # guard against fp landing exactly on a knot from the left
        starts = starts + 1e-9 * step
        seg = np.clip(np.searchsorted(knots, starts, side="right") - 1,
                      0, len(knots) - 2)
        starts = lo + step * np.arange(n_cells)
        d = starts - knots[seg]
        c3, c2, c1, c0 = (spline.coeffs[k][seg] for k in range(4))
        n3 = c3
        n2 = 3 * c3 * d + c2
        n1 = 3 * c3 * d * d + 2 * c2 * d + c1
        n0 = ((c3 * d + c2) * d + c1) * d + c0
        return cls(lo, step, np.stack([n3, n2, n1, n0]),
                   spline.lo_clamp, spline.hi_clamp)

    def eval_np(self, t):
        """Host f64 evaluation."""
        t = np.asarray(t, dtype=np.float64)
        tc = np.clip(t, self.lo_clamp, self.hi_clamp) \
            if (self.lo_clamp is not None or self.hi_clamp is not None) else t
        n_cells = self.coeffs.shape[1]
        idx = np.clip(((tc - self.lo) / self.step).astype(np.int64),
                      0, n_cells - 1)
        dt = tc - (self.lo + self.step * idx)
        c3, c2, c1, c0 = (self.coeffs[k][idx] for k in range(4))
        return ((c3 * dt + c2) * dt + c1) * dt + c0

    def __hash__(self):   # a key of the e0-grid operator cache
        return hash((self.lo, self.step, self.coeffs.tobytes(),
                     self.lo_clamp, self.hi_clamp))

    def __eq__(self, other):
        return (isinstance(other, UniformCubicSpline1D)
                and self.lo == other.lo and self.step == other.step
                and np.array_equal(self.coeffs, other.coeffs))
