"""Samplers of the port: the ensemble moves, parallel tempering, and the
gradient samplers (NUTS, HMC, random-walk Metropolis) with the box-logit
transform."""
from .stretch import (Chain, EnsembleState, init_state, make_step,  # noqa
                      run_mcmc, sample)
from .hmc import HMCChain, hmc_sample, metropolis_sample  # noqa: F401
from .nuts import NUTSChain, nuts_sample  # noqa: F401
from .transforms import BoxLogitTransform  # noqa: F401
from .pt import (PTChain, PTState, default_beta_ladder,  # noqa: F401
                 init_pt_state, make_pt_step, replica_exchange_core,
                 run_pt, sample_pt, sample_pt_adaptive, tempered_de_core,
                 tempered_stretch_core,
                 thermodynamic_integration_log_evidence)
