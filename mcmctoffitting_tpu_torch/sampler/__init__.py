"""Samplers of the port: the ensemble moves, and the gradient samplers
(NUTS, HMC, random-walk Metropolis) with the box-logit transform."""
from .stretch import (Chain, EnsembleState, init_state, make_step,  # noqa
                      run_mcmc, sample)
from .hmc import HMCChain, hmc_sample, metropolis_sample  # noqa: F401
from .nuts import NUTSChain, nuts_sample  # noqa: F401
from .transforms import BoxLogitTransform  # noqa: F401
