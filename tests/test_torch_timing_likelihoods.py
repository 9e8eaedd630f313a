"""Port ops/timing.py and ops/likelihoods.py vs the JAX package.

The exGaussian kernel has 16 taps (an even count), so 'same' mode keeps
full[7 : 7 + n]; the port writes the convolution as a matmul against a
banded matrix, checked here against jnp.convolve and np.convolve.  The
likelihoods get identical model arrays (zeros, NaN and obs == 0
included) on both sides: rtol 1e-6 plus an absolute 1e-6 x the sum of
the terms' magnitudes (float32 summation).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.ops import likelihoods as jl
from mcmctoffitting_tpu.ops import timing as jt
from mcmctoffitting_tpu_torch.ops import likelihoods as tl
from mcmctoffitting_tpu_torch.ops import timing as tt

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [45, 50, 70])
def test_exgaussian_same_convolution(n):
    rng = np.random.default_rng(n)
    spectra = rng.uniform(0.0, 1.0, (6, n)).astype(np.float32)
    got = tt.ExGaussianTiming().apply_spreading(
        torch.as_tensor(spectra)).numpy()
    timing = jt.ExGaussianTiming()
    want = np.stack([np.asarray(timing.apply_spreading(jnp.asarray(s)))
                     for s in spectra])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("taps", [5, 16])
def test_same_conv_matrix_is_np_convolve_same(taps):
    rng = np.random.default_rng(taps)
    kernel = rng.uniform(0.0, 1.0, taps)
    x = rng.uniform(-1.0, 1.0, 40)
    np.testing.assert_allclose(x @ tt.same_conv_matrix(kernel, 40),
                               np.convolve(x, kernel, mode="same"),
                               rtol=1e-12, atol=1e-12)


def _models_and_obs():
    rng = np.random.default_rng(0)
    model = rng.uniform(0.0, 3000.0, (5, 50)).astype(np.float32)
    model[0, :5] = 0.0                     # zero model bins
    model[1, 3] = np.nan                   # NaN bin
    model[2, 7] = 0.4                      # sub-count bin
    obs = rng.poisson(model[3]).astype(np.float32)
    obs[:6] = 0.0                          # empty observed bins
    return model, obs


def _check(got, want, scale):
    got = np.asarray(got)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-6,
                               atol=1e-6 * scale)


def test_poisson_binned_loglike():
    model, obs = _models_and_obs()
    got = tl.poisson_binned_loglike(torch.as_tensor(model),
                                    torch.as_tensor(obs)).numpy()
    want = np.array([float(jl.poisson_binned_loglike(
        jnp.asarray(m), jnp.asarray(obs))) for m in model])
    terms = np.abs(np.nan_to_num(np.asarray(jl.poisson_binned_terms(
        jnp.asarray(model), jnp.asarray(obs))), posinf=0.0, neginf=0.0))
    _check(got, want, terms.sum(-1).max())
    assert np.isneginf(got[1])


def test_poisson_logpmf_loglike():
    model, obs = _models_and_obs()
    got = tl.poisson_logpmf_loglike(torch.as_tensor(model),
                                    torch.as_tensor(obs)).numpy()
    want = np.array([float(jl.poisson_logpmf_loglike(
        jnp.asarray(m), jnp.asarray(obs))) for m in model])
    terms = np.abs(np.nan_to_num(np.asarray(jl.poisson_logpmf_terms(
        jnp.asarray(model), jnp.asarray(obs))), neginf=0.0))
    _check(got, want, terms.sum(-1).max())
    assert np.isneginf(got[1]) and np.all(np.isfinite(got[[0, 2, 3, 4]]))


def test_mask_drops_padding_bins():
    model, obs = _models_and_obs()
    padded_m = np.concatenate([model, np.full((5, 20), 7.0, np.float32)], 1)
    padded_o = np.concatenate([obs, np.full(20, 3.0, np.float32)])
    mask = torch.as_tensor(np.arange(70) < 50)
    for fn in (tl.poisson_binned_loglike, tl.poisson_logpmf_loglike):
        # equal up to float32 summation order (50 vs 70 summed bins)
        np.testing.assert_allclose(
            fn(torch.as_tensor(padded_m), torch.as_tensor(padded_o),
               mask=mask).numpy(),
            fn(torch.as_tensor(model), torch.as_tensor(obs)).numpy(),
            rtol=1e-6)


@pytest.mark.parametrize("inclusive", [True, False])
def test_box_lnprior(inclusive):
    lo, hi = np.array([0.0, -1.0, 2.0]), np.array([1.0, 1.0, 5.0])
    thetas = np.array([[0.5, 0.0, 3.0], [0.0, 0.0, 3.0], [1.0, 1.0, 5.0],
                       [1.5, 0.0, 3.0], [0.5, -2.0, 3.0]], np.float32)
    got = tl.box_lnprior(torch.as_tensor(thetas), torch.as_tensor(lo),
                         torch.as_tensor(hi), inclusive=inclusive).numpy()
    want = np.array([float(jl.box_lnprior(jnp.asarray(t), lo, hi,
                                          inclusive=inclusive))
                     for t in thetas])
    np.testing.assert_array_equal(got, want)
