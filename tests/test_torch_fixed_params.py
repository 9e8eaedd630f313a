"""The port's ``FixedParamProblem`` (frozen-parameter views of any
problem) against the base problem and against the JAX package's wrapper,
on the deterministic 'expected' simultFit forward (F = 64, 4 runs, the
CPU): the wrapped log-prob equals the base log-prob at the expanded
thetas bit for bit, and the JAX wrapper's within the tolerances of
``tests/test_torch_mc_table.py::test_expected_parity`` (1e-5 of the
likelihood's term scale).  Expand / collapse and the batched
``index_copy``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.models import fixed_params as jfixed
from mcmctoffitting_tpu.models import simult as jsimult
from mcmctoffitting_tpu_torch.models import fixed_params as tfixed
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.utils import data_io as tdata_io

torch.set_num_threads(1)

N_DRAWS, N_FINE, N_RUNS = 4096, 64, 4
TRUTH = np.concatenate([jsimult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])
FREE = (0, 2, 5)


def _spec(pkg):
    return dataclasses.replace(
        pkg.default_spec(N_DRAWS, fine_grid=N_FINE, sampling="expected"),
        rint_draws=False)


@pytest.fixture(scope="module")
def setup():
    tprob = tsimult.SimultFitProblem(_spec(tsimult), n_runs=N_RUNS,
                                     likelihood="poisson", device="cpu")
    observed = tdata_io.synthesize_observed(0, tprob, TRUTH)
    rng = np.random.default_rng(1)
    spread = np.concatenate([jsimult.AGITATORS_SHARED, 0.05 * TRUTH[4:]])
    thetas = (TRUTH + spread * rng.standard_normal((6, TRUTH.size))).astype(
        np.float32)
    return tprob, observed, thetas


def test_wrapper_equals_the_base_at_expanded_thetas(setup):
    tprob, observed, thetas = setup
    fixed = tfixed.FixedParamProblem.freeze(tprob, TRUTH, FREE)
    assert fixed.n_dim == 3
    free = torch.as_tensor(thetas[:, FREE])
    full = fixed.expand(free)
    want_full = np.tile(TRUTH.astype(np.float32), (6, 1))
    want_full[:, FREE] = thetas[:, FREE]
    np.testing.assert_array_equal(full.numpy(), want_full)
    np.testing.assert_array_equal(fixed.collapse(full.numpy()),
                                  thetas[:, FREE])
    gen = torch.Generator().manual_seed(0)
    got = fixed.make_log_prob_fn(observed)(free, gen)
    want = tprob.make_log_prob_fn(observed)(full, gen)
    assert torch.equal(got, want) and torch.isfinite(got).all()
    # one theta of the free subspace, no walker axis
    one = fixed.expand(free[0])
    np.testing.assert_array_equal(one.numpy(), want_full[0])


def test_wrapper_matches_the_jax_wrapper(setup):
    tprob, observed, thetas = setup
    jprob = jsimult.SimultFitProblem(_spec(jsimult), n_runs=N_RUNS,
                                     likelihood="poisson")
    jfix = jfixed.FixedParamProblem.freeze(jprob, TRUTH, FREE)
    tfix = tfixed.FixedParamProblem.freeze(tprob, TRUTH, FREE)
    assert jfix.template == tfix.template and \
        jfix.free_mask == tfix.free_mask and jfix.n_dim == tfix.n_dim
    free = thetas[:, FREE]
    jlogp = jax.jit(jax.vmap(jfix.make_log_prob_fn(observed)))
    keys = jax.random.split(jax.random.PRNGKey(0), free.shape[0])
    want = np.asarray(jlogp(jnp.asarray(free), keys))
    got = tfix.make_log_prob_fn(observed)(
        torch.as_tensor(free), torch.Generator()).numpy()
    np.testing.assert_array_equal(
        np.asarray(jfix.expand(jnp.asarray(free[0]))),
        tfix.expand(torch.as_tensor(free[0])).numpy())
    spectra = jprob.run_spectra(jnp.asarray(np.asarray(
        jfix.expand(jnp.asarray(free[0])))), keys[0])
    scale = sum(np.sum(np.abs(o * np.log(np.maximum(np.asarray(s), 1e-3)))
                       + np.asarray(s)) for o, s in zip(observed, spectra))
    assert np.isfinite(want).all() and np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= 1e-5 * scale), (got, want)
