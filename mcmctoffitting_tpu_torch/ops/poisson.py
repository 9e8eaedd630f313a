"""Exact Poisson sampling on a counter-based Philox stream — the plain
PyTorch version of kernel K1 (``csrc/poisson.cu``).

Port of ``mcmctoffitting_tpu/ops/poisson.py::poisson_ptrs`` with the
arithmetic of ``ops/pallas_poisson.py``: CDF inversion over 48 fixed
rounds for lam < 10, Hormann's PTRS transformed rejection (at most 64
rounds, then round(lam)) for lam >= 10, and the cancellation-free log-pmf
in the slow-accept test.  Both algorithms are exact; there is no normal
approximation anywhere.

Random stream: uniform j of round r for element i is word j of
Philox4x32-10(counter = (i mod 2^32, i div 2^32, r, 0), key = seed),
mapped to [0, 1) as (bits >> 8) * 2^-24.  A draw of a part of a larger
array (a shard of the walkers) gives each element its index in that
array instead (:func:`counter_indices`), and so draws exactly the larger
array's numbers.  Inversion lanes use word 0 of
round 0; PTRS round r uses words 0 (u) and 1 (v).  The CUDA kernel draws
from the same stream with the same formulas, so on the card kernel and
plain version agree element by element (up to rare last-ulp differences
of transcendentals that move an acceptance comparison).
"""
from __future__ import annotations

import math

import torch

_SMALL_CUTOFF = 10.0
_INV_ROUNDS = 48
_MAX_PTRS_ROUNDS = 64
_LN_SQRT_2PI = 0.9189385332046727
_TINY = 1.1754943508222875e-38          # float32 tiny

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def seed_words(generator: torch.Generator) -> tuple[int, int]:
    """Two 32-bit key words drawn from a host (CPU) generator — no device
    synchronisation per launch."""
    words = torch.randint(0, 1 << 32, (2,), generator=generator,
                          dtype=torch.int64)
    return int(words[0]), int(words[1])


class DeviceSeeds:
    """Seed words in device memory, taken where a host generator would be.

    A log-prob captured in a CUDA graph (``models/logp_graph.py``) hands
    this to the forward in place of its host generator: each launch that
    would draw two words (:func:`launch_seed`) takes the next row of
    ``words`` ((SLOTS, 2) int64, read by K1 when it runs) instead.
    :meth:`refill` writes fresh words into the rows before a replay."""

    SLOTS = 4          # K1 launches of one evaluation: 1 or 2 on counts

    def __init__(self, device):
        self.words = torch.zeros((self.SLOTS, 2), dtype=torch.int64,
                                 device=device)
        self.taken = 0
        self._cells = [(row[0], row[1]) for row in self.words]

    def take(self) -> torch.Tensor:
        """The next row: the seed tensor of one K1 launch."""
        if self.taken == len(self._cells):
            raise RuntimeError(f"DeviceSeeds: all {self.taken} slots taken")
        row = self.words[self.taken]
        self.taken += 1
        return row

    def refill(self, generator: torch.Generator, n: int) -> None:
        """Rows 0..n-1 from ``n`` calls of :func:`seed_words` on the host
        ``generator``, in order: each word by a ``fill_`` on the current
        stream, with no synchronize and no host-to-device copy."""
        for w0, w1 in self._cells[:n]:
            a, b = seed_words(generator)
            w0.fill_(a)
            w1.fill_(b)


def launch_seed(source) -> tuple[int, int] | torch.Tensor:
    """The seed of one K1 launch: two words drawn from a host generator
    (:func:`seed_words`), or the next row of a :class:`DeviceSeeds`."""
    if isinstance(source, DeviceSeeds):
        return source.take()
    return seed_words(source)


def counter_indices(n: int, offset: int = 0, blocks=None, *,
                    device=None) -> torch.Tensor:
    """The Philox counters of the ``n`` elements of a draw: ``offset + i``,
    the elements' indices in a larger array of which the draw is a part.
    ``blocks = (block, stride)``: the part is blocks of ``block``
    consecutive elements of that array, one every ``stride`` elements (the
    shard of every rung of a tempered ensemble), so element i has counter
    offset + (i // block) * stride + i % block."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    if blocks is not None:
        block, stride = blocks
        q = torch.div(idx, block, rounding_mode="floor")
        idx = q * stride + (idx - q * block)
    return idx + offset


def check_counter_layout(offset: int, blocks) -> None:
    """Raise unless ``offset`` >= 0 and ``blocks`` is None or (block,
    stride) with 1 <= block <= stride."""
    if offset < 0:
        raise ValueError(f"poisson: counter offset {offset} < 0")
    if blocks is not None and not 1 <= blocks[0] <= blocks[1]:
        raise ValueError(f"poisson: blocks (block, stride) = {blocks} need "
                         "1 <= block <= stride")


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit halves of a * b for a 32-bit constant ``a`` and
    32-bit values ``b`` held in int64 (16-bit split keeps every partial
    product below 2^49)."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's constants) on int64
    tensors or ints holding 32-bit words: counter (c0..c3), key (k0, k1)
    -> four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> [0, 1) float32."""
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def _gammaln_stirling(x: torch.Tensor) -> torch.Tensor:
    """gammaln(x) for x >= 1: Stirling at x >= 8, 8-shifted below
    (``ops/pallas_poisson.py::_gammaln_stirling``; |err| ~ 1e-7)."""
    xs = torch.clamp_max(x, 8.0)
    z = torch.where(x < 8.0, x + 8.0, x)
    zi = torch.reciprocal(z)
    s = ((z - 0.5) * torch.log(z) - z + _LN_SQRT_2PI
         + zi * (1.0 / 12.0 - zi * zi * (1.0 / 360.0)))
    prod = (xs * (xs + 1.0) * (xs + 2.0) * (xs + 3.0)
            * (xs + 4.0) * (xs + 5.0) * (xs + 6.0) * (xs + 7.0))
    return torch.where(x < 8.0, s - torch.log(prod), s)


def _ptrs_log_pmf(k, lam, loglam):
    """Poisson log-pmf for the PTRS slow-accept test, cancellation-free.

    Around d = k - lam (exact in f32): log pmf = -d^2/lam - k r - log(2 pi
    k)/2 - 1/(12k) + 1/(360k^3) with r the in-place log1p(t) series
    remainder for |t| = |d/lam| <= 1/16 (the library log1p's absolute
    error, times k, skews the acceptance at large lam); the library log1p
    beyond; the Stirling gammaln form for k < 8.
    """
    d = k - lam
    kk = torch.clamp_min(k, 1.0)
    t = torch.where(k >= 8.0, d / lam, 0.0)
    r = t * t * (-1.0 / 2.0 + t * (1.0 / 3.0 + t * (
        -1.0 / 4.0 + t * (1.0 / 5.0 + t * (-1.0 / 6.0 + t * (1.0 / 7.0))))))
    core = torch.where(torch.abs(t) <= 0.0625,
                       -(d * d) / lam - k * r,
                       d - k * torch.log1p(t))
    stable = (core
              - 0.5 * torch.log(2.0 * math.pi * kk)
              - (1.0 / 12.0 - (1.0 / 360.0) * torch.reciprocal(kk * kk))
              / kk)
    naive = k * loglam - lam - _gammaln_stirling(k + 1.0)
    return torch.where(k >= 8.0, stable, naive)


def _small_inversion(u, lam):
    """CDF inversion over 48 fixed rounds: X = #{k : S(k) >= v}, the
    survival S accumulated downward, v = max(1 - u, 1e-5)."""
    v = torch.clamp_min(1.0 - u, 1e-5)
    p = torch.exp(-lam)
    s = torch.ones_like(lam)
    cnt = torch.zeros_like(lam)
    for i in range(_INV_ROUNDS):
        s = s - p
        cnt = cnt + (s >= v).to(cnt.dtype)
        p = p * lam * (1.0 / (i + 1.0))
    return cnt


def poisson_ptrs(lam: torch.Tensor, seed, *, offset: int = 0,
                 blocks=None) -> torch.Tensor:
    """Exact Poisson draws of a float32 rate tensor (any shape, any
    device) on the Philox stream keyed by ``seed``: two 32-bit words, as
    a pair of ints or as an int64 tensor of two words (read without a
    synchronize).  NaN or negative rates draw 0.  ``offset`` and
    ``blocks`` place the draw in a larger array (:func:`counter_indices`).
    """
    check_counter_layout(offset, blocks)
    shape = lam.shape
    lam = lam.reshape(-1).to(torch.float32)
    lam = torch.where(lam > 0.0, lam, 0.0)
    idx = counter_indices(lam.numel(), offset, blocks, device=lam.device)
    ctr_lo, ctr_hi = idx & _MASK32, idx >> 32
    if isinstance(seed, torch.Tensor):
        words = seed.to(device=lam.device, dtype=torch.int64) & _MASK32
        key = (words[0], words[1])
    else:
        key = (int(seed[0]) & _MASK32, int(seed[1]) & _MASK32)

    def bits(round_):
        return philox4x32_10((ctr_lo, ctr_hi, round_, 0), key)

    small = lam < _SMALL_CUTOFF
    w0, w1, _, _ = bits(0)
    cnt_small = _small_inversion(_unit(w0), torch.where(small, lam, 1.0))

    big_lam = torch.where(small, 100.0, lam)
    slam = torch.sqrt(big_lam)
    loglam = torch.log(big_lam)
    b = 0.931 + 2.53 * slam
    a = -0.059 + 0.02483 * b
    log_invalpha = torch.log(1.1239 + 1.1328 * torch.reciprocal(b - 3.4))
    vr = 0.9277 - 3.6224 * torch.reciprocal(b - 2.0)

    done = small.clone()
    result = torch.zeros_like(lam)
    for r in range(_MAX_PTRS_ROUNDS):
        if r:
            if bool(done.all()):
                break
            w0, w1, _, _ = bits(r)
        u = _unit(w0) - 0.5
        v = torch.clamp_min(_unit(w1), _TINY)
        us = 0.5 - torch.abs(u)
        k = torch.floor((2.0 * a / torch.clamp_min(us, _TINY) + b) * u
                        + big_lam + 0.43)
        fast = (us >= 0.07) & (v <= vr)
        reject = (k < 0.0) | ((us < 0.013) & (v > us))
        log_acc = (torch.log(v) + log_invalpha
                   - torch.log(a / torch.clamp_min(us * us, _TINY) + b))
        slow = log_acc <= _ptrs_log_pmf(k, big_lam, loglam)
        accept = fast | (~reject & slow)
        result = torch.where(~done & accept, k, result)
        done = done | accept
    cnt_big = torch.where(done, result, torch.round(big_lam))
    return torch.where(small, cnt_small, cnt_big).reshape(shape)
