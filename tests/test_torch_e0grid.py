"""Port ops/e0grid.py vs the JAX package's: the closed-form moments, the
expected e0 mean, and the counts estimator's deterministic core with the
same Poisson counts injected into both.

Tolerance of the moment channels: rtol 1e-5 plus an absolute term of
2^-20 x n_samples.  Each moment is a draw count times a difference of two
ndtr values in [0, 1]; the port's ndtr (``ops/pdfs.py``) and
jax.scipy.special.ndtr are both float32 but differ by an ulp or two
(2^-24 near 1), and the t^k
channels combine the partial moments with binomial weights that cancel,
so the agreement is absolute at the ndtr's resolution, not relative to a
small channel value.  Measured worst error: 0.3 of that bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmctoffitting_tpu.ops.poisson as jpoisson
from mcmctoffitting_tpu.models import onebd as jonebd
from mcmctoffitting_tpu.models import simult as jsimult
from mcmctoffitting_tpu.ops import e0grid as je0
from mcmctoffitting_tpu_torch.ops import e0grid as te0
from mcmctoffitting_tpu_torch.ops import pdfs as tpdfs

torch.set_num_threads(1)

N_SAMPLES = 8000
ATOL = N_SAMPLES * 2.0 ** -20


@pytest.fixture(scope="module")
def tables():
    spec = jsimult.default_spec(N_SAMPLES, sampling="counts", fine_grid=128)
    tab = spec.e0_grid_table
    return tab, te0.E0Grid(tab, device="cpu")


def _thetas():
    rng = np.random.default_rng(0)
    return (jsimult.GUESS_SHARED + jsimult.AGITATORS_SHARED
            * rng.standard_normal((8, 4))).astype(np.float32)


def _split(th):
    t = torch.as_tensor(th)
    return t[:, 0], t[:, 1], t[:, 2], t[:, 3]


@pytest.mark.parametrize("closure", ["exact", "cell"])
@pytest.mark.parametrize("truncated", [True, False])
def test_expected_moments(tables, truncated, closure):
    tab, grid = tables
    th = _thetas()
    fn = jax.jit(jax.vmap(lambda p: je0.expected_moments(
        tab, p[0], p[1], p[2], p[3], N_SAMPLES, truncated, closure)))
    want_m, want_e0 = (np.asarray(a) for a in fn(jnp.asarray(th)))
    got_m, got_e0 = te0.expected_moments(grid, *_split(th), N_SAMPLES,
                                         truncated, closure)
    assert got_m.shape == (8, 4, tab.n_fine)
    np.testing.assert_allclose(got_m.numpy(), want_m, rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(got_e0.numpy(), want_e0, rtol=1e-5)


def test_ndtr_holds_both_tails():
    """The port's ndtr is jax.scipy.special.ndtr's formula: within 1e-5
    relative of it from -12 to 12 (erfc in the tails).  torch.special.ndtr
    is 0 below x ~ -5.4 in float32."""
    x = np.linspace(-12.0, 12.0, 4801).astype(np.float32)
    want = np.asarray(jax.scipy.special.ndtr(jnp.asarray(x)))
    got = tpdfs.ndtr(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    assert got[x < -6].min() > 0.0


def test_expected_moments_of_a_wide_lognormal():
    """oneBD posterior thetas with a wide energy-loss law (s 1.5-2.6, the
    ridge of the -hardcore counts fit): the ndtr argument of the t^3
    channel, ln(w) / s - 3 s, lies in the far lower tail.  With
    torch.special.ndtr those channels were off by ~3,000 x the tolerance
    (the grid went negative, the log-prob ~40 nats low at s = 2.23);
    the tolerance of test_expected_moments holds."""
    tab = jonebd.default_spec(N_SAMPLES, sampling="counts",
                              fine_grid=128).e0_grid_table
    grid = te0.E0Grid(tab, device="cpu")
    th = np.array([[2490.0, 1336.2, 27.9, 2.228],
                   [2490.0, 1338.2, 29.7, 1.959],
                   [2490.0, 1300.0, 40.0, 1.5],
                   [2490.0, 1250.0, 30.0, 2.6]], np.float32)
    fn = jax.jit(jax.vmap(lambda p: je0.expected_moments(
        tab, p[0], p[1], p[2], p[3], N_SAMPLES, False, "exact")))
    want = np.asarray(fn(jnp.asarray(th))[0])
    got = te0.expected_moments(grid, *_split(th), N_SAMPLES, False,
                               "exact")[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("truncated", [True, False])
def test_expected_e0_mean(truncated):
    th = _thetas()
    want = np.asarray(jax.vmap(lambda p: je0.expected_e0_mean(
        p[0], p[1], p[2], p[3], truncated))(jnp.asarray(th)))
    got = te0.expected_e0_mean(*_split(th), truncated)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_degenerate_parameters_give_no_moments(tables):
    """scale <= 0 or s <= 0: zero moments and a finite mean, as in JAX."""
    tab, grid = tables
    th = np.array([[1878.4, 850.0, -1.0, 0.5], [1878.4, 850.0, 170.0, 0.0]],
                  np.float32)
    got_m, got_e0 = te0.expected_moments(grid, *_split(th), N_SAMPLES,
                                         True, "exact")
    want_m, want_e0 = jax.vmap(lambda p: je0.expected_moments(
        tab, p[0], p[1], p[2], p[3], N_SAMPLES, True, "exact"))(
            jnp.asarray(th))
    assert not np.any(got_m.numpy())
    np.testing.assert_array_equal(np.asarray(want_m), 0.0)
    np.testing.assert_allclose(got_e0.numpy(), np.asarray(want_e0),
                               rtol=1e-5)


@pytest.mark.parametrize("closure", ["exact", "cell"])
@pytest.mark.parametrize("truncated", [True, False])
def test_counts_core_with_injected_counts(tables, monkeypatch, truncated,
                                          closure):
    """counts_lambdas + moments_from_counts vs poissonized_moments, the
    JAX sampler replaced by the same numpy counts."""
    tab, grid = tables
    th = _thetas()
    box = {}

    def fixed_counts(key, lam):
        box["lam"] = lam
        return box["counts"]

    monkeypatch.setattr(jpoisson, "poisson_auto", fixed_counts)

    def jax_core(p, counts):
        box["counts"] = counts
        m, e0 = je0.poissonized_moments(
            jax.random.PRNGKey(0), tab, p[0], p[1], p[2], p[3], N_SAMPLES,
            truncated, closure)
        return m, e0, box["lam"]

    jfn = jax.jit(jax.vmap(jax_core))
    # pass 1 reads the JAX package's rates; the counts are drawn from them
    zeros = jnp.zeros((8, tab.n_fine + 2), jnp.float32)
    lam_j = np.asarray(jfn(jnp.asarray(th), zeros)[2])
    counts = np.random.default_rng(1).poisson(lam_j).astype(np.float32)
    want_m, want_e0, _ = (np.asarray(a)
                          for a in jfn(jnp.asarray(th), jnp.asarray(counts)))

    rates = te0.counts_lambdas(grid, *_split(th), N_SAMPLES, truncated,
                               closure)
    assert rates.lam.shape == (8, tab.n_fine + 2)
    np.testing.assert_allclose(rates.lam.numpy(), lam_j, rtol=1e-5,
                               atol=ATOL)
    got_m, got_e0 = te0.moments_from_counts(grid, torch.as_tensor(counts),
                                            rates)
    # moments = counts x E[t^k | cell] with E[t^k | cell] = S_k / S_0: the
    # rates' absolute ATOL becomes 2 ATOL / lambda on the ratio (|t| <= 1)
    cells = counts[:, None, :tab.n_fine]
    lam_cells = np.maximum(lam_j[:, None, :tab.n_fine], 1e-30)
    bound = 1e-5 * np.abs(want_m) + 4.0 * ATOL * cells / lam_cells
    assert np.all(np.abs(got_m.numpy() - want_m) <= bound)
    np.testing.assert_allclose(got_e0.numpy(), want_e0, rtol=1e-6)


def test_moments_from_counts_broadcasts_over_runs(tables):
    """One rate set per walker, counts per walker and run: the batched
    call equals the per-run calls."""
    _, grid = tables
    th = _thetas()[:3]
    rates = te0.counts_lambdas(grid, *_split(th), N_SAMPLES, True, "exact")
    gen = np.random.default_rng(2)
    counts = torch.as_tensor(gen.poisson(
        np.broadcast_to(rates.lam.numpy()[:, None], (3, 4, 130))
    ).astype(np.float32))
    per_run = te0.CountsRates(*(t[:, None] for t in rates))
    batched_m, batched_e0 = te0.moments_from_counts(grid, counts, per_run)
    for r in range(4):
        m, e0 = te0.moments_from_counts(grid, counts[:, r], rates)
        np.testing.assert_array_equal(batched_m[:, r].numpy(), m.numpy())
        np.testing.assert_array_equal(batched_e0[:, r].numpy(), e0.numpy())
