"""Deterministic sums of float32 values: int64 fixed point.

A float32 ``scatter_add_`` on the GPU adds with atomics in no fixed
order, so the same inputs can give sums that differ in their last bits
from call to call.  Here every value is first rounded to a multiple of a
power-of-two step 2^-s and summed as an int64: integer addition is
associative, so the sums are the same on every call, and the same bit for
bit on the CPU and the GPU for the same values.  The sums are converted to
float32 once, at the end.

The shift s is chosen from the number of terms n that can fall into one
sum and a bound B on their magnitudes: the largest s with n B 2^s <= 2^61,
one bit below the int64 range for the values that round a little past B.
A value v is stored as round(v 2^s): scaling a float32 by a power of two
is exact, so rounding in float32 gives the same integer as rounding in
float64, and every float32 with |v| >= 2^(23 - s) is a multiple of 2^-s
already (s = 43 for n = 200k and B = 1: only |v| < 2^-20 is rounded, by at
most 2^-44).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import torch

_HEADROOM_BITS = 61


def fixed_point_shift(n_terms: int, bound: float) -> int:
    """The largest s with ``n_terms`` * ``bound`` * 2^s <= 2^61."""
    if n_terms < 1 or not bound > 0.0:
        raise ValueError(f"fixed_point_shift: n_terms {n_terms}, bound "
                         f"{bound}")
    return int(math.floor(_HEADROOM_BITS - math.log2(n_terms * bound)))


def channel_shifts(n_terms: int, bounds: Sequence[float]) -> tuple[int, ...]:
    """One shift per channel of values bounded by ``bounds``."""
    return tuple(fixed_point_shift(n_terms, b) for b in bounds)


@functools.lru_cache(maxsize=32)
def _steps(shifts: tuple, sign: int, device: torch.device) -> torch.Tensor:
    """2^(sign s) per channel on ``device``, copied there once: a copy
    from host memory per call would wait for the stream."""
    return torch.tensor([2.0 ** (sign * s) for s in shifts],
                        dtype=torch.float32 if sign > 0 else torch.float64,
                        device=device)


def quantise(values: torch.Tensor, shifts: Sequence[int]) -> torch.Tensor:
    """float32 values (..., C) -> int64 multiples of 2^-s_c, one shift per
    channel of the last axis (one shift for all: a sequence of one).  NaN
    and infinite values must be zeroed by the caller."""
    step = _steps(tuple(shifts), 1, values.device)
    return torch.round(values * step).to(torch.int64)


def dequantise(sums: torch.Tensor, shifts: Sequence[int],
               channel_dim: int) -> torch.Tensor:
    """int64 sums with channels along ``channel_dim`` -> float32: each
    sum to float64, times 2^-s_c (exact), rounded once to float32."""
    shape = [1] * sums.dim()
    shape[channel_dim] = len(shifts)
    step = _steps(tuple(shifts), -1, sums.device).reshape(shape)
    return (sums.to(torch.float64) * step).to(torch.float32)
