"""The ops functions that the JAX package keeps without a caller of its
own, ported for completeness, against the JAX package's on the same
numpy-seeded inputs (the CPU): ``delta_moment_histogram`` (an XLA one-hot
there, plain torch here), ``linear_interp``, ``velocity_from_energy``,
``BetheStopping.with_material`` and ``havar_stopping``; the likelihood of
the templates, ``template_gaussian_loglike``, with its ``model < 1``
clamp; ``exgaussian_shape`` (the timing density on the device) and
``bin_index`` (np.histogram's bin of each value)."""
import jax.numpy as jnp
import numpy as np
import torch

from mcmctoffitting_tpu.constants import masses as jmasses
from mcmctoffitting_tpu.ops import histogram as jhist
from mcmctoffitting_tpu.ops import interp as jinterp
from mcmctoffitting_tpu.ops import kinematics as jkin
from mcmctoffitting_tpu.ops import likelihoods as jlike
from mcmctoffitting_tpu.ops import stopping as jstop
from mcmctoffitting_tpu.ops import timing as jtiming
from mcmctoffitting_tpu_torch.constants import masses
from mcmctoffitting_tpu_torch.ops import histogram as thist
from mcmctoffitting_tpu_torch.ops import interp as tinterp
from mcmctoffitting_tpu_torch.ops import kinematics as tkin
from mcmctoffitting_tpu_torch.ops import likelihoods as tlike
from mcmctoffitting_tpu_torch.ops import stopping as tstop
from mcmctoffitting_tpu_torch.ops import timing as ttiming

torch.set_num_threads(1)


def test_delta_moment_histogram():
    """Values over and beyond [lo, hi] (v == hi, v == lo), with and
    without a per-sample weight, batched; counts exact, the d-channels
    within float32 summation error of the JAX one-hot matmul.  A NaN value
    is dropped (the JAX package's one-hot product spreads it over every
    bin of channels 1-3, as for the fine-cell moments: a difference by
    design, ROADMAP Queue 3)."""
    rng = np.random.default_rng(0)
    v = rng.uniform(-10.0, 110.0, (3, 5000)).astype(np.float32)
    v[0, :4] = [100.0, 0.0, 50.0, 99.99]
    w = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    for extra in (None, w):
        got = thist.delta_moment_histogram(
            torch.as_tensor(v), 0.0, 100.0, 40,
            extra_weight=None if extra is None else torch.as_tensor(extra))
        want = np.asarray(jhist.delta_moment_histogram(
            jnp.asarray(v), 0.0, 100.0, 40, chunk=1024,
            extra_weight=None if extra is None else jnp.asarray(extra)))
        assert got.shape == (3, 4, 40)
        if extra is None:
            np.testing.assert_array_equal(got[:, 0].numpy(), want[:, 0])
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-3)
    with_nan = v.copy()
    with_nan[0, 2] = np.nan
    dropped = v.copy()
    dropped[0, 2] = -1.0          # outside the range
    np.testing.assert_array_equal(
        thist.delta_moment_histogram(torch.as_tensor(with_nan), 0.0, 100.0,
                                     40).numpy(),
        thist.delta_moment_histogram(torch.as_tensor(dropped), 0.0, 100.0,
                                     40).numpy())


def test_linear_interp():
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(0.0, 10.0, 30)).astype(np.float32)
    fp = rng.normal(0.0, 1.0, 30).astype(np.float32)
    xq = rng.uniform(-2.0, 12.0, (4, 500)).astype(np.float32)
    xq[0, :3] = [xp[0], xp[-1], xp[7]]
    got = tinterp.linear_interp(torch.as_tensor(xq), torch.as_tensor(xp),
                                torch.as_tensor(fp)).numpy()
    want = np.asarray(jinterp.linear_interp(xq, xp, fp))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.interp(xq, xp, fp), rtol=1e-5,
                               atol=1e-5)


def test_velocity_from_energy():
    e = np.random.default_rng(2).uniform(1.0, 3000.0, 1000).astype(
        np.float32)
    for m, jm in ((masses.deuteron, jmasses.deuteron),
                  (masses.neutron, jmasses.neutron)):
        assert m == jm
        np.testing.assert_allclose(
            tkin.velocity_from_energy(m, torch.as_tensor(e)).numpy(),
            np.asarray(jkin.velocity_from_energy(jm, e)), rtol=1e-6)


def test_with_material_and_havar():
    t = tstop.d2_gas_stopping().with_material(2.0, 4.0, 1e-4, 41.8e-3)
    j = jstop.d2_gas_stopping().with_material(2.0, 4.0, 1e-4, 41.8e-3)
    assert t.materials == j.materials and len(t.materials) == 2
    for tm, jm in ((t, j), (tstop.havar_stopping(), jstop.havar_stopping())):
        assert tm.materials == jm.materials
        np.testing.assert_array_equal(tm._electron_densities(),
                                      jm._electron_densities())
        e = np.linspace(200.0, 3000.0, 50)
        np.testing.assert_allclose(
            tm.dedx(torch.as_tensor(e)).numpy(),
            np.asarray(jm.dedx(jnp.asarray(e, jnp.float32))), rtol=2e-6)


def test_template_gaussian_loglike():
    """Batched over walkers: sub-count model bins and empty observations
    clamp to 1 as in the JAX package; a non-finite model is -inf."""
    rng = np.random.default_rng(3)
    model = rng.uniform(0.0, 300.0, (4, 45)).astype(np.float32)
    model[1, :5] = 0.3
    model[2, 3] = np.inf
    model[3, 7] = np.nan
    obs = rng.poisson(150.0, 45).astype(np.float32)
    obs[:4] = 0.0
    got = tlike.template_gaussian_loglike(torch.as_tensor(model),
                                          torch.as_tensor(obs)).numpy()
    want = np.array([float(jlike.template_gaussian_loglike(m, obs))
                     for m in model])
    assert np.array_equal(np.isfinite(got), np.isfinite(want))
    assert np.isneginf(got[2:]).all()
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-6)


def test_exgaussian_shape():
    """The JAX package's values on the grid of
    ``tests/test_timing.py::test_exgaussian_shape_values`` (bin centres
    over [ceil(-5 sigma), ceil(10 tau)], the early-time tail at ~1e-5 of
    the peak included) and further out on both sides, within 1e-5
    relative: the two erfc and exp implementations differ in the last
    bits.  Normalised, within that test's own tolerance of the float64
    oracle.  A float32 tensor in, a float32 tensor on its device out."""
    from scipy.special import erf

    sigma, tau = 1.1910, 1.0110
    lo, hi = np.ceil(-5 * sigma), np.ceil(10 * tau)
    centers = np.linspace(lo + 0.5, hi - 0.5, int(hi - lo))
    grid = np.concatenate([np.linspace(-9.0, lo, 7), centers,
                           np.linspace(hi, 25.0, 7)]).astype(np.float32)
    got = ttiming.exgaussian_shape(torch.as_tensor(grid), sigma, tau)
    assert got.dtype == torch.float32 and got.shape == grid.shape
    want = np.asarray(jtiming.exgaussian_shape(jnp.asarray(grid), sigma,
                                               tau))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0.0)
    exp_arg = sigma ** 2 / (2 * tau ** 2) - centers / tau
    erf_arg = (sigma ** 2 - centers * tau) / (np.sqrt(2) * sigma * tau)
    oracle = np.exp(exp_arg) * (1 - erf(erf_arg))
    vals = ttiming.exgaussian_shape(torch.as_tensor(centers), sigma,
                                    tau).numpy()
    np.testing.assert_allclose(vals / vals.sum(), oracle / oracle.sum(),
                               rtol=1e-3, atol=1e-8)


def test_bin_index():
    """The JAX function's (index, in-range) on values inside, beyond and
    at the edges of [lo, hi] (the interior float32 edges too), and
    np.histogram's edge rules on the rest: v == lo in bin 0, v == hi in
    the last bin, values outside, infinities and NaN not counted.  (At an
    interior edge both packages bin by floor of the float32 scaled value,
    which np.histogram's float64 edges may put one bin higher.)"""
    rng = np.random.default_rng(4)
    lo, hi, n_bins = -2.0, 3.0, 7
    edges = np.linspace(lo, hi, n_bins + 1).astype(np.float32)
    v = np.concatenate([rng.uniform(-4.0, 5.0, 500), edges,
                        [lo, hi, -2.0000002, 3.0000002, np.nan, np.inf,
                         -np.inf]]).astype(np.float32)
    idx, in_range = thist.bin_index(torch.as_tensor(v), lo, hi, n_bins)
    assert idx.dtype == torch.int32 and in_range.dtype == torch.bool
    jidx, jin = jhist.bin_index(jnp.asarray(v), lo, hi, n_bins)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(in_range.numpy(), np.asarray(jin))
    rest = ~np.isin(v, edges[1:-1])
    counts = np.bincount(idx.numpy()[in_range.numpy() & rest],
                         minlength=n_bins)
    finite = v[rest & np.isfinite(v)]
    np.testing.assert_array_equal(counts,
                                  np.histogram(finite, n_bins, (lo, hi))[0])
    assert idx[v == np.float32(lo)].eq(0).all()
    assert idx[v == np.float32(hi)].eq(n_bins - 1).all()
    assert not in_range[~np.isfinite(v)].any()
