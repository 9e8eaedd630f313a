"""Ensemble samplers of the port."""
from .stretch import (Chain, EnsembleState, init_state, make_step,  # noqa
                      run_mcmc, sample)
