"""The mc path's physics and kernels K3/K4 (plain versions) against the
JAX package, on the CPU at small sizes.

(a) Bethe closed form: the (A, P, Q) constants equal the JAX package's;
    the float32 closed-form dE/dx within rtol 1e-5 of the full formula.
(b) K4 (fused RK4 transport + moments): the plain version against
    ``fused_transport_moments(..., interpret=True)``, and the port's taylor
    grid against the JAX package's ``energy_weight_grid`` on the rk4 spec;
    relative error <= 1e-4 on grid bins above 1% of the maximum, the JAX
    package's own bar (tests/test_pallas_forward.py).
(c) K3 (weighted histogram): the plain version against
    ``pallas_weighted_histogram(..., interpret=True)`` and against
    ``weighted_histogram``, to 1e-5 of the row total; the edge cases of
    tests/test_pallas_hist.py exactly.
(d) ``beam_energies_from_uniforms`` against ``beam_energy_rvs`` fed the
    same uniforms (or normals), rtol 2e-6 plus two float32 ulps of beamE
    (the final subtraction cancels); the port's device draws against
    scipy's truncated lognormal (KS).
(e) The cross-section spline: ``eval_np(derivatives=True)`` bitwise, the
    per-sample float32 evaluation within 1 ulp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from mcmctoffitting_tpu.config import SIMULTFIT_X_BINNING
from mcmctoffitting_tpu.models import forward as jforward
from mcmctoffitting_tpu.models import simult as jsimult
from mcmctoffitting_tpu.ops import histogram as jhist
from mcmctoffitting_tpu.ops import pdfs as jpdfs
from mcmctoffitting_tpu.ops import stopping as jstopping
from mcmctoffitting_tpu.ops import xs as jxs
from mcmctoffitting_tpu.ops.pallas_forward import (
    bethe_closed_form_constants as jbethe, fused_transport_moments)
from mcmctoffitting_tpu.ops.pallas_hist import pallas_weighted_histogram
from mcmctoffitting_tpu_torch.models import forward as tforward
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import cuda_hist, cuda_transport, pdfs
from mcmctoffitting_tpu_torch.ops import stopping as tstopping
from mcmctoffitting_tpu_torch.ops import xs as txs

torch.set_num_threads(1)
TINY = float(np.finfo(np.float32).tiny)
ED_LO, ED_HI, ED_N = 200.0, 1200.0, 50


def _rk4(n_substeps=1):
    return tstopping.rk4_constants(tstopping.d2_gas_stopping(),
                                   SIMULTFIT_X_BINNING.centers, n_substeps)


def _e0(shape, seed):
    """Initial energies: mostly in the histogram's reach, plus a tail that
    stops at the floor inside the cell."""
    rng = np.random.default_rng(seed)
    e0 = rng.uniform(450.0, 1250.0, shape)
    e0.reshape(-1)[::97] = rng.uniform(15.0, 200.0, e0.size)[::97]
    return e0.astype(np.float32)


# --- (a) ---------------------------------------------------------------

def test_bethe_constants_equal():
    st_j, st_t = jstopping.d2_gas_stopping(), tstopping.d2_gas_stopping()
    assert tstopping.bethe_closed_form_constants(st_t) == jbethe(st_j)
    assert tstopping.FIXED_FACTOR == jstopping.FIXED_FACTOR


def test_closed_form_dedx_matches_bethe():
    e = np.linspace(25.0, 2300.0, 257).astype(np.float32)
    want = np.asarray(jstopping.d2_gas_stopping().dedx(jnp.asarray(e)))
    c = _rk4()
    got = tstopping.closed_form_dedx(c, torch.as_tensor(e)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    full = tstopping.d2_gas_stopping().dedx(torch.as_tensor(e)).numpy()
    np.testing.assert_allclose(full, want, rtol=1e-6)


def test_rk4_transport_matches_jax():
    """The port's transport (closed form) against the JAX package's
    rk4_transport (full formula): within 1e-3 keV, and frozen at the
    floor where the JAX package freezes."""
    e0 = _e0(2048, 1)
    want = np.asarray(jstopping.rk4_transport(
        jstopping.d2_gas_stopping().dedx, jnp.asarray(e0),
        SIMULTFIT_X_BINNING.centers, n_substeps=1))          # (M, N)
    got = tstopping.rk4_transport(_rk4(), torch.as_tensor(e0)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got == 20.0, want == 20.0)


# --- (b) ---------------------------------------------------------------

def _grid_rel(got, want):
    m = want > 1e-2 * want.max()
    return (np.abs(got[m] - want[m]) / want[m]).max()


def test_k4_plain_matches_pallas_interpret():
    e0 = _e0((3, 4096), 2)
    want = np.asarray(fused_transport_moments(
        e0, jstopping.d2_gas_stopping(), SIMULTFIT_X_BINNING.centers,
        ED_LO, ED_HI, ED_N, n_substeps=1, n_blk=2048, interpret=True))
    got = cuda_transport.transport_moments(
        torch.as_tensor(e0), _rk4(),
        cuda_transport.MomentBins(ED_LO, ED_HI, ED_N)).numpy()
    assert got.shape == want.shape == (3, 10, 4, ED_N)
    # counts per (row, depth, bin) equal; every channel to 1e-5 of the
    # row's sample count
    np.testing.assert_array_equal(got[:, :, 0], want[:, :, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * 4096)
    taylor = tforward.taylor_coeffs(tsimult.default_spec(
        4096, transport="rk4"))
    for r in range(3):
        assert _grid_rel((got[r] * taylor).sum(1),
                         (want[r] * taylor).sum(1)) < 1e-4


def test_taylor_grid_matches_energy_weight_grid():
    e0 = _e0(4096, 3)
    jspec = jsimult.default_spec(4096, transport="rk4")
    want = np.asarray(jforward.energy_weight_grid(jspec, jnp.asarray(e0)))
    tspec = tsimult.default_spec(4096, transport="rk4", sampling="mc")
    assert tspec.xs_mode == "taylor" and tspec.rk4_substeps == 1
    fwd = tforward.TofForward(tspec, (300.0,), (jsimult.tof_windows.mid,),
                              device="cpu")
    got = fwd.energy_weight_grid(torch.as_tensor(e0)[None]).numpy()[0]
    np.testing.assert_array_equal(tforward.taylor_coeffs(tspec),
                                  jforward._taylor_coeffs(jspec))
    assert _grid_rel(got, want) < 1e-4


def test_exact_grid_matches_energy_weight_grid():
    """xs_mode='exact': per-sample cross sections, then K3's plain
    version, against the JAX package's exact path (same bar)."""
    e0 = _e0(4096, 4)
    jspec = jsimult.default_spec(4096, transport="rk4", xs_mode="exact")
    want = np.asarray(jforward.energy_weight_grid(jspec, jnp.asarray(e0)))
    tspec = tsimult.default_spec(4096, transport="rk4", sampling="mc",
                                 xs_mode="exact")
    fwd = tforward.TofForward(tspec, (300.0,), (jsimult.tof_windows.mid,),
                              device="cpu")
    got = fwd.energy_weight_grid(torch.as_tensor(e0)[None]).numpy()[0]
    assert _grid_rel(got, want) < 1e-4


# --- (c) ---------------------------------------------------------------

@pytest.mark.parametrize("r,n,bins,n_valid", [(4, 4096, 50, None),
                                              (10, 5000, 45, 4321),
                                              (3, 2048, 128, None)])
def test_k3_plain_matches_pallas_and_xla(r, n, bins, n_valid):
    rng = np.random.default_rng(r)
    v = rng.uniform(-0.1, 1.1, (r, n)).astype(np.float32)
    w = rng.uniform(0, 2, (r, n)).astype(np.float32)
    got = cuda_hist.weighted_histogram(torch.as_tensor(v), 0.0, 1.0, bins,
                                       torch.as_tensor(w), n_valid).numpy()
    k = n if n_valid is None else n_valid
    v_pal = v if n_valid is None else v[:, :k]
    want_pal = np.asarray(pallas_weighted_histogram(
        v_pal, w[:, :k], 0.0, 1.0, bins, interpret=True))
    want_xla = np.asarray(jhist.weighted_histogram(
        jnp.asarray(v[:, :k]), 0.0, 1.0, bins, jnp.asarray(w[:, :k])))
    total = w[:, :k].sum(-1, keepdims=True)
    for want in (want_pal, want_xla):
        assert got.shape == want.shape == (r, bins)
        assert np.all(np.abs(got - want) <= 1e-5 * total)


def test_k3_edge_cases_exact():
    """tests/test_pallas_hist.py's right-edge and padding cases, plus
    NaN and a masked tail: equal to the Pallas kernel bit for bit."""
    v = np.array([[1.0, 0.0, 0.99999, 1.0001, -0.1, np.nan]] * 8,
                 np.float32)
    v = np.pad(v, ((0, 0), (0, 2042)), constant_values=5.0)
    w = np.ones_like(v)
    got = cuda_hist.weighted_histogram(torch.as_tensor(v), 0.0, 1.0, 10,
                                       torch.as_tensor(w)).numpy()
    want = np.asarray(pallas_weighted_histogram(
        np.nan_to_num(v, nan=5.0), w, 0.0, 1.0, 10, interpret=True))
    np.testing.assert_array_equal(got, want)
    assert got[0, -1] == 2.0 and got[0, 0] == 1.0 and got[0].sum() == 3.0

    rng = np.random.default_rng(1)
    v = rng.uniform(0, 1, (5, 3000)).astype(np.float32)
    got = cuda_hist.weighted_histogram(
        torch.as_tensor(v), 0.0, 1.0, 20, torch.ones((5, 3000)),
        n_valid=2500).numpy()
    for i in range(5):
        want, _ = np.histogram(v[i, :2500], 20, (0.0, 1.0))
        np.testing.assert_array_equal(got[i], want.astype(np.float32))


# --- (d) ---------------------------------------------------------------

PARAMS = [(1878.4, 850.0, 170.0, 0.5), (1830.0, 990.0, 280.0, 1.15)]


@pytest.mark.parametrize("rounds", [-1, 0])
def test_beam_energies_match_jax(rounds):
    n = 8192
    keys = jax.random.split(jax.random.PRNGKey(7), len(PARAMS))
    draws, want = [], []
    for key, p in zip(keys, PARAMS):
        key0, _ = jax.random.split(key)
        if rounds < 0:
            draws.append(np.asarray(jax.random.uniform(
                key0, (n,), minval=jnp.finfo(jnp.float32).tiny,
                maxval=1.0)))
        else:
            draws.append(np.asarray(jax.random.normal(key0, (n,))))
        want.append(np.asarray(jpdfs.beam_energy_rvs(
            key, n, *(jnp.float32(v) for v in p), n_redraw_rounds=rounds)))
    params = torch.as_tensor(np.array(PARAMS, np.float32))
    got = pdfs.beam_energies_from_uniforms(
        torch.as_tensor(np.stack(draws)), *params.T, truncated=rounds < 0)
    # e0 = beamE - (eLoss + scale W) cancels: an ulp of exp or ndtri in
    # the ~beamE-sized sum is an ulp of beamE in e0, whatever e0's size
    ulp = np.spacing(np.float32(max(p[0] for p in PARAMS)))
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=2e-6,
                               atol=2 * ulp)


def test_beam_energy_draws_follow_truncated_lognormal():
    beam_e, e_loss, scale, s = PARAMS[1]
    n = 20000
    u = pdfs.draw_beam_uniforms((1, 1, n), True,
                                torch.Generator().manual_seed(3), "cpu")
    p = torch.tensor([[beam_e, e_loss, scale, s]], dtype=torch.float32)
    e0 = pdfs.beam_energies_from_uniforms(u, *p.T, truncated=True)
    e0 = e0.reshape(-1).double().numpy()
    assert e0.min() > 0.0
    w_max = (beam_e - e_loss) / scale
    law = scipy.stats.lognorm(s)

    def cdf(x):   # P(e0 <= x) given W < w_max
        w = np.clip((beam_e - e_loss - x) / scale, 0.0, w_max)
        return (law.cdf(w_max) - law.cdf(w)) / law.cdf(w_max)

    assert scipy.stats.kstest(e0, cdf).pvalue > 1e-3
    # the untruncated law reaches below zero at these parameters
    z = pdfs.draw_beam_uniforms((1, 1, n), False,
                                torch.Generator().manual_seed(4), "cpu")
    e0u = pdfs.beam_energies_from_uniforms(z, *p.T, truncated=False)
    e0u = e0u.reshape(-1).double().numpy()
    untrunc = scipy.stats.lognorm(s, loc=e_loss, scale=scale)
    assert scipy.stats.kstest(beam_e - e0u, untrunc.cdf).pvalue > 1e-3
    assert (e0u < 0).mean() > 0.03


def test_device_seed_comes_from_the_eval_generator():
    shape = (2, 3, 64)
    a = pdfs.draw_beam_uniforms(shape, True, torch.Generator().manual_seed(5),
                                "cpu")
    b = pdfs.draw_beam_uniforms(shape, True, torch.Generator().manual_seed(5),
                                "cpu")
    c = pdfs.draw_beam_uniforms(shape, True, torch.Generator().manual_seed(6),
                                "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.min() >= TINY and a.max() < 1.0


# --- (e) ---------------------------------------------------------------

def test_xs_eval_np_derivatives_bitwise():
    e = np.linspace(0.0, 12000.0, 4001)        # both clamp regions
    got = txs.ddn_xs_uniform.eval_np(e, derivatives=True)
    want = jxs.ddn_xs_uniform.eval_np(e, derivatives=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_xs_per_sample_within_one_ulp():
    rng = np.random.default_rng(0)
    e = np.concatenate([rng.uniform(0.0, 1300.0, 20000),
                        np.arange(0.0, 1300.0, 10.0), [20.0, 1e4, 2e4]])
    e = e.astype(np.float32)
    got = txs.ddn_xs_uniform(torch.as_tensor(e)).numpy()
    want = np.asarray(jxs.ddn_xs_uniform(jnp.asarray(e)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_spec_combinations():
    """The mc path's spec rules: the JAX package's fall-back and errors;
    the redraw rounds earlier slices refused build a spec now."""
    spec = tsimult.default_spec(1000, transport="rk4", sampling="mc")
    assert (spec.xs_mode, spec.transport, spec.stopping_table,
            spec.e0_grid_table) == ("taylor", "rk4", None, None)
    with pytest.raises(ValueError, match="e0grid"):
        dataclasses.replace(spec, xs_mode="e0grid")
    with pytest.raises(ValueError, match="stopping"):
        dataclasses.replace(spec, stopping=None)
    assert dataclasses.replace(spec, n_redraw_rounds=3).n_redraw_rounds == 3
    with pytest.raises(ValueError, match="beam_source"):
        dataclasses.replace(spec, beam_source="cauchy")
    with pytest.raises(ValueError, match="transport='table'"):
        tsimult.default_spec(1000, transport="rk4", sampling="counts")
    with pytest.raises(ValueError, match="transport='table'"):
        jsimult.default_spec(1000, transport="rk4", sampling="counts")


@pytest.mark.parametrize("case", ["k3_shapes", "k3_dtype", "k3_n_valid",
                                  "k4_energies_out", "k4_dtype"])
def test_kernel_wrappers_refuse_bad_inputs(case):
    """The K3 and K4 wrappers refuse what neither their kernel nor their
    plain version takes, on the CPU as on the card."""
    v = torch.ones((2, 8))
    with pytest.raises((TypeError, ValueError)):
        if case == "k3_shapes":
            cuda_hist.weighted_histogram(v, 0.0, 1.0, 4, torch.ones((2, 7)))
        elif case == "k3_dtype":
            cuda_hist.weighted_histogram(v.double(), 0.0, 1.0, 4, v.double())
        elif case == "k3_n_valid":
            cuda_hist.weighted_histogram(v, 0.0, 1.0, 4, v, n_valid=9)
        elif case == "k4_energies_out":
            cuda_transport.transport_moments(
                v, _rk4(), cuda_transport.MomentBins(200.0, 1200.0, 50),
                energies_out=True)
        else:
            cuda_transport.transport_moments(
                v.double(), _rk4(), cuda_transport.MomentBins(200.0, 1200.0,
                                                              50))


@pytest.mark.parametrize("fault", [None, "d3_zeroed", "d1_scaled",
                                   "count_off_by_one"])
def test_moment_check_finds_a_wrong_channel(fault):
    """The per-channel check of K4's moments passes the plain version's
    float32 sums and fails each channel that is wrong."""
    c, bins = _rk4(), cuda_transport.MomentBins(ED_LO, ED_HI, ED_N)
    e0 = torch.as_tensor(_e0((3, 20_000), 8))
    e0[:, ::50] = float("nan")
    moments = cuda_transport.transport_moments_plain(e0, c, bins)
    if fault == "d3_zeroed":
        moments[:, :, 3] = 0.0
    elif fault == "d1_scaled":
        moments[:, :, 1] *= 1.001
    elif fault == "count_off_by_one":
        moments[0, 0, 0, 10] += 1.0
    counts_equal, ratio = cuda_transport.moment_check(
        moments, tstopping.rk4_transport(c, e0), bins)
    assert counts_equal == (fault != "count_off_by_one")
    assert (ratio <= 1.0) == (fault in (None, "count_off_by_one"))


def _kernel_int64_sums(e, bins):
    """K4's int64 workspace for energies ``e`` (R, M, N), emulated on the
    CPU: the count, and d, d^2, d^3 each rounded to the nearest multiple of
    its step (ties to even, as ``__float2int_rn``), summed exactly."""
    n_rows, n_x, _ = e.shape
    idx, chans = cuda_transport.moment_channels(e, bins)
    scales = torch.tensor([1.0] + [1.0 / s for s in
                                   cuda_transport.KERNEL_STEPS])
    terms = torch.round(chans * scales).long()              # (R, M, N, 4)
    cells = torch.arange(4) * bins.n_bins + idx[..., None]
    sums = torch.zeros((n_rows, n_x, 4 * bins.n_bins), dtype=torch.int64)
    sums.scatter_add_(-1, cells.reshape(n_rows, n_x, -1),
                      terms.reshape(n_rows, n_x, -1))
    return sums.reshape(n_rows, n_x, 4, bins.n_bins)


def test_kernel_sums_to_moments_meets_moment_check():
    """K4's last step, the int64 sums times each channel's step in float64
    rounded to float32 once: on the sums the kernel forms, the result meets
    ``moment_check`` (counts exact, d-channels within their steps) and
    agrees with the plain version; at the bound of a cell (2^31 samples
    each adding 2^13) the conversion is one rounding of the exact value."""
    c, bins = _rk4(), cuda_transport.MomentBins(ED_LO, ED_HI, ED_N)
    e0 = torch.as_tensor(_e0((3, 20_000), 9))
    e = tstopping.rk4_transport(c, e0)
    got = cuda_transport.kernel_sums_to_moments(_kernel_int64_sums(e, bins))
    assert got.dtype == torch.float32
    counts_equal, ratio = cuda_transport.moment_check(got, e, bins)
    assert counts_equal and ratio <= 1.0
    want = cuda_transport.transport_moments_plain(e0, c, bins)
    total = want[:, :, 0].sum(dim=(-2, -1))[:, None, None, None]
    assert torch.all((got - want).abs() <= 1e-5 * total)
    # the extremes: 2^44 is the largest magnitude 2^31 samples can reach
    big = np.array([2 ** 44, -(2 ** 44), 2 ** 44 - 1, 3, -1, 0],
                   np.int64)
    sums = torch.as_tensor(np.tile(big[:, None, None], (1, 4, 1)))
    steps = np.array([1.0, *cuda_transport.KERNEL_STEPS])
    exact = (big.astype(np.float64)[:, None] * steps).astype(np.float32)
    np.testing.assert_array_equal(
        cuda_transport.kernel_sums_to_moments(sums)[..., 0].numpy(), exact)
    assert cuda_transport.KERNEL_MAX_SAMPLES * 2 ** 13 == 2 ** 44
