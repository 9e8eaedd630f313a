"""Initial deuteron energies of the mc estimator.

Port of ``mcmctoffitting_tpu/ops/pdfs.py::beam_energy_rvs``: e0 = beamE -
lognorm(s, loc=eLoss, scale), either truncated to e0 > 0 by inverse CDF
(``n_redraw_rounds = -1``, statistically identical to the reference's
redraw-until-positive loop) or drawn once untruncated
(``n_redraw_rounds = 0``).  Other redraw budgets are not ported.

The draw is split in two:

* :func:`draw_beam_uniforms` draws on the device: uniforms in
  [tiny, 1) for the truncated law, standard normals for the untruncated
  one, (W, R, N) at once.  At the production size that is 512 x 200k
  floats per half-step, which must not cross from the host.
* :func:`beam_energies_from_uniforms`, the deterministic core, maps them
  to energies with the (W,) parameters, exactly as the JAX package maps
  its own uniforms (or normals).

Seeding: ``log_prob`` receives a host ``torch.Generator`` (the sampler's
eval generator).  Each forward draws two 32-bit words from it
(``ops/poisson.seed_words``, as kernel K1 does), joins them into one
64-bit seed and seeds a generator on the device with it; the device draw
then needs no transfer and no synchronisation, and a fixed host seed
reproduces the whole chain.
"""
from __future__ import annotations

import torch

from .poisson import seed_words

_TINY = 1.1754943508222875e-38          # float32 tiny, the JAX minval


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
        cdf_max = torch.where(valid, torch.special.ndtr(z_max), 1.0)
        z = torch.special.ndtri(u * cdf_max)
    else:
        z = u
    return beam_e - (e_loss + scale * torch.exp(s * z))
