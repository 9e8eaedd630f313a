"""Port ops/poisson.py — the plain version of kernel K1 — vs the JAX
package and vs exact distributions.

* the shifted-Stirling gammaln against scipy and the JAX twin;
* the cancellation-free PTRS log-pmf against the JAX function;
* the sampler's mean and variance z-scores at the rates the kernel's
  validation artifact covers (artifacts/pallas_poisson_validation.json),
  and the inversion path against the exact pmf;
* the Philox4x32-10 mirror against Random123's known-answer vectors (the
  CUDA generator is held to the same vectors on the card);
* the stream contract: draws are a function of (seed, element index);
* the wrapper's forms: the seed as a pair of ints or as a two-word
  tensor, rates given once per walker with a run count, its refusals;
* the forward's counts path draws every run from the walker's rates,
  exactly as from the rates copied along the run axis.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats
from scipy.special import gammaln as sp_gammaln

from mcmctoffitting_tpu.ops.pallas_poisson import _gammaln_stirling as j_stir
from mcmctoffitting_tpu.ops.poisson import _ptrs_log_pmf as j_log_pmf
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import poisson as tp
from mcmctoffitting_tpu_torch.ops.cuda_poisson import poisson

torch.set_num_threads(1)


def test_gammaln_stirling_vs_scipy_and_jax():
    x = np.concatenate([np.arange(1.0, 20.0, 0.25),
                        np.geomspace(20.0, 1.0e6, 400)])
    got = tp._gammaln_stirling(torch.as_tensor(x, dtype=torch.float32))
    got = got.numpy().astype(np.float64)
    # f32 evaluation: a few ulps of the O(gammaln) operands (the JAX
    # package's own test of the twin uses the same bound)
    np.testing.assert_allclose(got, sp_gammaln(x), rtol=3e-6, atol=3e-6)
    want = np.asarray(j_stir(jnp.asarray(x, jnp.float32)), np.float64)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("lam", [10.0, 37.5, 100.0, 1.0e3, 1.0e4, 1.0e5,
                                 2.0e5])
def test_ptrs_log_pmf_vs_jax(lam):
    """Over the PTRS proposal's bulk (|k - lam| <= 6 sigma, where the
    slow-accept test decides) and the small-k tail."""
    sd = np.sqrt(lam)
    k = np.concatenate([np.arange(0.0, 12.0),
                        np.floor(np.linspace(max(0.0, lam - 6 * sd),
                                             lam + 6 * sd, 401))])
    k = k.astype(np.float32)
    lam_a = np.full_like(k, lam)
    got = tp._ptrs_log_pmf(torch.as_tensor(k), torch.as_tensor(lam_a),
                           torch.log(torch.as_tensor(lam_a))).numpy()
    want = np.asarray(j_log_pmf(jnp.asarray(k), jnp.asarray(lam_a),
                                jnp.log(jnp.asarray(lam_a))))
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-4)
    # and both against the exact log-pmf at the mode's neighbourhood
    bulk = np.abs(k - lam) <= 3 * sd
    np.testing.assert_allclose(
        got[bulk], stats.poisson.logpmf(k[bulk].astype(np.float64), lam),
        atol=2e-3)


@pytest.mark.parametrize("lam", [0.5, 5.0, 10.0, 100.0, 1.0e4, 2.0e5])
def test_sampler_moments(lam):
    n = 100_000
    x = tp.poisson_ptrs(torch.full((n,), lam), (12345, int(lam * 10)))
    x = x.numpy().astype(np.float64)
    assert np.all(x == np.floor(x)) and np.all(x >= 0)
    z_mean = (x.mean() - lam) / np.sqrt(lam / n)
    z_var = (x.var(ddof=1) - lam) / np.sqrt((lam + 2 * lam * lam) / n)
    assert abs(z_mean) < 4 and abs(z_var) < 4, (z_mean, z_var)


def test_inversion_path_matches_pmf():
    lam, n = 3.0, 200_000
    x = tp.poisson_ptrs(torch.full((n,), lam), (7, 8)).numpy()
    k = np.arange(12)
    observed = np.array([np.sum(x == v) for v in k[:-1]]
                        + [np.sum(x >= k[-1])])
    p = stats.poisson.pmf(k, lam)
    p[-1] = stats.poisson.sf(k[-1] - 1, lam)
    chi2 = np.sum((observed - n * p) ** 2 / (n * p))
    assert stats.chi2.sf(chi2, len(k) - 1) > 1e-4, chi2


def test_zero_nan_and_negative_rates_draw_zero():
    lam = torch.tensor([0.0, -3.0, float("nan"), 0.0])
    np.testing.assert_array_equal(tp.poisson_ptrs(lam, (1, 2)).numpy(), 0.0)


M32 = 0xFFFFFFFF
KAT = [  # Random123 Philox4x32-10: (counter, key) -> output
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    ctr = tuple(torch.tensor([c], dtype=torch.int64) for c in counter)
    got = tp.philox4x32_10(ctr, key)
    assert tuple(int(w) for w in got) == want


def test_stream_is_keyed_by_seed_and_element():
    lam = torch.as_tensor(np.geomspace(0.1, 3e5, 4096).astype(np.float32))
    full = tp.poisson_ptrs(lam, (3, 4))
    # element i's draw depends on (seed, i) only, not on the array's size
    np.testing.assert_array_equal(tp.poisson_ptrs(lam[:1000], (3, 4)),
                                  full[:1000])
    np.testing.assert_array_equal(
        tp.poisson_ptrs(lam.reshape(64, 64), (3, 4)).reshape(-1), full)
    assert not torch.equal(tp.poisson_ptrs(lam, (3, 5)), full)


def test_cpu_dispatch_takes_plain_version():
    lam = torch.linspace(0.0, 500.0, 257)
    before = poisson.launches
    np.testing.assert_array_equal(poisson(lam, (9, 10)).numpy(),
                                  tp.poisson_ptrs(lam, (9, 10)).numpy())
    assert poisson.launches == before


def test_seed_words_come_from_a_host_generator():
    gen = torch.Generator().manual_seed(0)
    words = [tp.seed_words(gen) for _ in range(4)]
    assert all(0 <= w < 2 ** 32 for pair in words for w in pair)
    assert len(set(words)) == 4
    again = torch.Generator().manual_seed(0)
    assert tp.seed_words(again) == words[0]


def _mixed_rates(shape, seed=0):
    """Rates from 0 through the branch boundary into the thousands."""
    rng = np.random.default_rng(seed)
    lam = np.exp(rng.uniform(np.log(1e-3), np.log(5e3), shape))
    lam[rng.uniform(size=shape) < 0.2] = 0.0
    return torch.as_tensor(lam.astype(np.float32))


@pytest.mark.parametrize("words", [(9, 10), (0xFFFFFFFF, 0),
                                   (0xDEADBEEF, 0x12345678)])
def test_seed_tensor_equals_tuple_form(words):
    lam = _mixed_rates((7, 129))
    seed = torch.tensor(words, dtype=torch.int64)
    want = tp.poisson_ptrs(lam, words)
    np.testing.assert_array_equal(tp.poisson_ptrs(lam, seed), want)
    np.testing.assert_array_equal(poisson(lam, seed), want)
    np.testing.assert_array_equal(poisson(lam, words), want)
    # only the low 32 bits of a word count, as for the ints
    np.testing.assert_array_equal(poisson(lam, seed + (1 << 32)), want)


@pytest.mark.parametrize("lead,n_runs,n_rates", [((16,), 4, 130),
                                                 ((3, 5), 2, 66),
                                                 ((1,), 1, 7),
                                                 ((), 3, 33)])
def test_rates_per_walker_equal_expanded_form(lead, n_runs, n_rates):
    """Rates (..., C) with a run count draw as the rates copied to
    (..., R, C): the counter of a draw is its output element's index."""
    lam = _mixed_rates(lead + (n_rates,), seed=1)
    expanded = lam[..., None, :].expand(lead + (n_runs, n_rates))
    got = poisson(lam, (5, 6), n_runs=n_runs)
    assert got.shape == lead + (n_runs, n_rates)
    np.testing.assert_array_equal(
        got, tp.poisson_ptrs(expanded.contiguous(), (5, 6)))
    if n_runs > 1 and lam.numel() > 30:   # runs draw independently
        assert not torch.equal(got[..., 0, :], got[..., 1, :])


def test_wrapper_refusals():
    lam = _mixed_rates((4, 10))
    with pytest.raises(TypeError, match="float32"):
        poisson(lam.double(), (1, 2))
    with pytest.raises(TypeError, match="two int64 words"):
        poisson(lam, torch.tensor([1, 2], dtype=torch.int32))
    with pytest.raises(TypeError, match="two int64 words"):
        poisson(lam, torch.tensor([1, 2, 3]))
    with pytest.raises(ValueError, match="two 32-bit words"):
        poisson(lam, (1, 2, 3))
    with pytest.raises(ValueError, match="n_runs"):
        poisson(lam, (1, 2), n_runs=0)
    with pytest.raises(ValueError, match="no kernel for device"):
        poisson(lam.to("meta"), (1, 2))
    with pytest.raises(ValueError, match="seed on"):
        poisson(lam, torch.tensor([1, 2], device="meta"))
    assert poisson(torch.empty((0, 5)), (1, 2), n_runs=3).shape == (0, 3, 5)


def test_counts_path_draws_each_run_from_the_walkers_rates():
    """grid_and_mean on a fixed generator: the grids of the path that
    hands K1 the rates once per walker equal, bit for bit, those of the
    rates copied along the run axis and drawn with the same seed words."""
    from mcmctoffitting_tpu_torch.models import forward as tforward
    from mcmctoffitting_tpu_torch.ops.e0grid import (CountsRates,
                                                     moments_from_counts)
    spec = tsimult.default_spec(8000, sampling="counts", fine_grid=128)
    fwd = tsimult.SimultFitProblem(spec, n_runs=4, device="cpu").forward
    rng = np.random.default_rng(2)
    truth = np.asarray(tsimult.GUESS_SHARED, np.float32)
    params = torch.as_tensor(
        truth * (1.0 + 0.01 * rng.standard_normal((6, 4))).astype(
            np.float32))
    grids, e0_means = fwd.grid_and_mean(params,
                                        torch.Generator().manual_seed(11))
    assert grids.shape[:2] == (6, 4) and e0_means.shape == (6, 4)

    rates = fwd.counts_rates(params)
    words = tp.seed_words(torch.Generator().manual_seed(11))
    lam = rates.lam[:, None, :].expand(6, 4, -1).contiguous()
    counts = tp.poisson_ptrs(lam, words)
    per_run = CountsRates(*(t[:, None] for t in rates))
    moments, want_means = moments_from_counts(fwd.e0grid, counts, per_run)
    want = tforward._e0grid_contract(fwd.e0grid, moments)
    np.testing.assert_array_equal(grids, want)
    np.testing.assert_array_equal(e0_means, want_means)
    assert not torch.equal(grids[:, 0], grids[:, 1])   # runs draw apart
