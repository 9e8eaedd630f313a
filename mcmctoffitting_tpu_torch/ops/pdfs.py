"""Random variates and pdfs of the forward models, and the initial
deuteron energies of the mc estimator.

Port of ``mcmctoffitting_tpu/ops/pdfs.py``: ``lognorm_rvs``,
``lognorm_pdf``, ``skewnorm_pdf`` and ``skewnorm_rvs`` (the reference's
Azzalini construction, ``utilities/pdfs.py:8-28``), and
``beam_energy_rvs``: e0 = beamE - lognorm(s, loc=eLoss, scale), either
truncated to e0 > 0 by inverse CDF (``n_redraw_rounds = -1``,
statistically identical to the reference's redraw-until-positive loop),
drawn once untruncated (``n_redraw_rounds = 0``) or redrawn a fixed
number of rounds (``n_redraw_rounds > 0``: each round replaces the draws
that are still <= 0 with fresh ones; stragglers keep their last draw).

The draw is split in two:

* :func:`draw_beam_uniforms` draws on the device: uniforms in
  [tiny, 1) for the truncated law, standard normals for the untruncated
  one, (W, R, N) at once.  At the production size that is 512 x 200k
  floats per half-step, which must not cross from the host.
* :func:`beam_energies_from_uniforms`, the deterministic core, maps them
  to energies with the (W,) parameters, exactly as the JAX package maps
  its own uniforms (or normals); :func:`beam_energies_redrawn` maps one
  set of normals per redraw round.

Every other draw is split the same way: a draw of standard normals on the
device (:func:`device_normals`) and a deterministic core
(:func:`lognorm_from_normals`, :func:`skewnorm_from_normals`), which the
tests hold exactly against the JAX package's arithmetic on the same
normals.

Seeding: ``log_prob`` receives a host ``torch.Generator`` (the sampler's
eval generator).  Each forward draws two 32-bit words from it
(``ops/poisson.seed_words``, as kernel K1 does), joins them into one
64-bit seed and seeds a generator on the device with it; the device draw
then needs no transfer and no synchronisation, and a fixed host seed
reproduces the whole chain.
"""
from __future__ import annotations

import math

import torch

from .poisson import seed_words

_TINY = 1.1754943508222875e-38          # float32 tiny, the JAX minval


_HALF_SQRT_2 = 0.5 * math.sqrt(2.0)


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF by ``jax.scipy.special.ndtr``'s formula:
    0.5 (1 + erf(x / sqrt 2)) near 0, 0.5 erfc(|x| / sqrt 2) (or 1 minus
    it) beyond |x| = 1, accurate in both tails.  ``torch.special.ndtr``
    loses the lower tail in float32 (0 below x ~ -5.4, 4% off at -5),
    where the third moment of a wide lognormal's cells lives (its ndtr
    argument is ln(w) / s - 3 s)."""
    w = x * _HALF_SQRT_2
    z = torch.abs(w)
    y = torch.where(z < _HALF_SQRT_2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z), torch.erfc(z)))
    return 0.5 * y

def device_generator(generator: torch.Generator,
                     device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from two words of the host
    ``generator``."""
    lo, hi = seed_words(generator)
    gen = torch.Generator(device=device)
    gen.manual_seed((hi << 32) | lo)
    return gen


def draw_beam_uniforms(shape, truncated: bool, generator: torch.Generator,
                       device) -> torch.Tensor:
    """The random input of :func:`beam_energies_from_uniforms`: uniforms
    in [tiny, 1) (``truncated``) or standard normals, float32 on
    ``device``, drawn there from a generator seeded by the host
    ``generator``."""
    gen = device_generator(generator, torch.device(device))
    if truncated:
        u = torch.rand(shape, generator=gen, device=device)
        return torch.clamp_min(u, _TINY)
    return torch.randn(shape, generator=gen, device=device)


def beam_energies_from_uniforms(u: torch.Tensor, beam_e: torch.Tensor,
                                e_loss: torch.Tensor, scale: torch.Tensor,
                                s: torch.Tensor,
                                truncated: bool) -> torch.Tensor:
    """Deterministic core of ``beam_energy_rvs``: draws (W, ..., N) and
    parameters (W,) -> energies (W, ..., N).

    ``truncated``: ``u`` are uniforms; z = ndtri(u Phi(z_max)) with
    z_max = ln((beamE - eLoss)/scale)/s, so every e0 is positive.  Invalid
    parameters (beamE <= eLoss, scale <= 0 or s <= 0) get a plain draw.
    Otherwise ``u`` are the standard normals z themselves.  Then e0 =
    beamE - (eLoss + scale exp(s z)).
    """
    lead = (slice(None),) + (None,) * (u.dim() - 1)
    beam_e, e_loss, scale, s = (p[lead] for p in (beam_e, e_loss, scale, s))
    if truncated:
        headroom = beam_e - e_loss
        valid = (headroom > 0.0) & (scale > 0.0) & (s > 0.0)
        safe_head = torch.where(valid, headroom, 1.0)
        safe_scale = torch.where(scale > 0.0, scale, 1.0)
        safe_s = torch.where(s > 0.0, s, 1.0)
        z_max = torch.log(safe_head / safe_scale) / safe_s
        cdf_max = torch.where(valid, ndtr(z_max), 1.0)
        z = torch.special.ndtri(u * cdf_max)
    else:
        z = u
    return beam_e - (e_loss + scale * torch.exp(s * z))


def beam_energies_redrawn(z: torch.Tensor, beam_e: torch.Tensor,
                          e_loss: torch.Tensor, scale: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """Deterministic core of the fixed-budget redraw
    (``n_redraw_rounds > 0``): standard normals z (1 + rounds, W, ..., N)
    -> energies (W, ..., N).  The first set is the draw; round k replaces
    every energy still <= 0 by the k-th fresh draw (the JAX package's
    ``fori_loop``).  Degenerate parameters keep their last draw."""
    e = beam_energies_from_uniforms(z[0], beam_e, e_loss, scale, s, False)
    for fresh_z in z[1:]:
        fresh = beam_energies_from_uniforms(fresh_z, beam_e, e_loss, scale,
                                            s, False)
        e = torch.where(e <= 0.0, fresh, e)
    return e


def device_normals(shape, generator: torch.Generator,
                   device) -> torch.Tensor:
    """Standard normals, float32 on ``device``, from a generator there
    seeded by two words of the host ``generator``."""
    gen = device_generator(generator, torch.device(device))
    return torch.randn(shape, generator=gen, device=device)


def lognorm_from_normals(z: torch.Tensor, s, loc=0.0,
                         scale=1.0) -> torch.Tensor:
    """Deterministic core of :func:`lognorm_rvs`: loc + scale exp(s z)."""
    return loc + scale * torch.exp(s * z)


def lognorm_rvs(generator: torch.Generator, s, loc=0.0, scale=1.0,
                shape=(), device="cuda") -> torch.Tensor:
    """scipy.stats.lognorm.rvs(s, loc, scale) on ``device``."""
    return lognorm_from_normals(device_normals(shape, generator, device), s,
                                loc, scale)


def lognorm_pdf(x: torch.Tensor, s, loc=0.0, scale=1.0) -> torch.Tensor:
    """scipy.stats.lognorm.pdf(x, s, loc, scale); 0 where x <= loc."""
    y = (x - loc) / scale
    y_safe = torch.where(y > 0, y, 1.0)
    pdf = (torch.exp(-torch.log(y_safe) ** 2 / (2.0 * s ** 2))
           / (y_safe * s * math.sqrt(2.0 * math.pi) * scale))
    return torch.where(y > 0, pdf, 0.0)


def skewnorm_pdf(x: torch.Tensor, a=0.0, loc=0.0,
                 scale=1.0) -> torch.Tensor:
    """The reference's skew-normal pdf (``utilities/pdfs.py:12-14``):
    2 phi((x - loc)/scale) Phi(a (x - loc)/scale) / scale."""
    t = (x - loc) / scale
    phi = torch.exp(-t * t / 2.0) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + torch.special.erf(a * t / math.sqrt(2.0)))
    return 2.0 * phi * cdf / scale


def skewnorm_from_normals(u0: torch.Tensor, v: torch.Tensor, a=0.0,
                          loc=0.0, scale=1.0) -> torch.Tensor:
    """Deterministic core of :func:`skewnorm_rvs` on two sets of standard
    normals: the Azzalini construction with, as in the reference, BOTH
    normals scaled by ``scale``: u0' = scale u0, v' = scale v,
    d = a / sqrt(1 + a^2), u1 = d u0' + v' sqrt(1 - d^2), then u1 where
    u0' >= 0, else -u1, plus ``loc``."""
    u0 = scale * u0
    v = scale * v
    a = torch.as_tensor(a, dtype=u0.dtype, device=u0.device)
    d = a / torch.sqrt(1.0 + a * a)
    u1 = d * u0 + v * torch.sqrt(1.0 - d * d)
    return torch.where(u0 >= 0, u1, -u1) + loc


def skewnorm_rvs(generator: torch.Generator, shape=(), a=0.0, loc=0.0,
                 scale=1.0, device="cuda") -> torch.Tensor:
    """Skew-normal draws on ``device`` (:func:`skewnorm_from_normals` of
    two sets of normals drawn there)."""
    z = device_normals((2,) + tuple(shape), generator, device)
    return skewnorm_from_normals(z[0], z[1], a, loc, scale)
