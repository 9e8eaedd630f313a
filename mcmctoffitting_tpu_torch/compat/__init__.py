"""Drop-in API compatibility layers for the libraries the reference drives.

Port of ``mcmctoffitting_tpu/compat``.  ``compat.emcee`` mirrors the emcee
2.x ``EnsembleSampler`` the reference scripts are written against, on top
of the port's ensemble sampler, so that a reference user's own driver code
runs unmodified:

    from mcmctoffitting_tpu_torch.compat import emcee
    sampler = emcee.EnsembleSampler(nWalkers, nDim, lnprob, kwargs={...})
    for pos, prob, rstate in sampler.sample(p0, iterations=n):
        ...
"""
from . import emcee

__all__ = ["emcee"]
