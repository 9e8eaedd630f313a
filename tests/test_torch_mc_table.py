"""The mc estimator on the stopping table (the JAX presets' default) and
the 'expected' estimator of simultFit: the port (mcmctoffitting_tpu_torch)
against the JAX package at a small size (<= 4096 draws, F = 64, 4 walkers).

(a) ``eval_stopped`` against both of the JAX package's lookup methods,
    bitwise, on the simultFit and the oneBD tables.
(b) The per-sample fine-cell moments (4, F) against the JAX package's, per
    channel, and ``energy_weight_grid`` for table x {e0grid, taylor,
    exact} on the same initial energies.
(c) The slice as a whole with the same initial energies injected on both
    sides: spectra and log-probs walker by walker.
(d) The 'expected' spectra and log-probs (deterministic, no injection).
(e) ``default_spec`` field by field against the JAX preset.
(f) Short DE fits on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import ndtr, ndtri

from mcmctoffitting_tpu.models import forward as jforward
from mcmctoffitting_tpu.models import onebd as jonebd
from mcmctoffitting_tpu.models import simult as jsimult
from mcmctoffitting_tpu_torch import sampler
from mcmctoffitting_tpu_torch.models import forward as tforward
from mcmctoffitting_tpu_torch.models import onebd as tonebd
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import e0grid as te0grid
from mcmctoffitting_tpu_torch.utils import data_io as tdata_io

torch.set_num_threads(1)

N_DRAWS, N_FINE, N_RUNS, N_WALKERS = 4096, 64, 4, 4
TRUTH = np.concatenate([jsimult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])
PRESETS = {"simult": (jsimult, tsimult), "onebd": (jonebd, tonebd)}


def _thetas(n=N_WALKERS, seed=0):
    rng = np.random.default_rng(seed)
    spread = np.concatenate([jsimult.AGITATORS_SHARED, 0.05 * TRUTH[4:]])
    return (TRUTH + spread * rng.standard_normal((n, TRUTH.size))).astype(
        np.float32)


def _e0_draws(thetas, seed, n_draws=N_DRAWS):
    """Truncated-lognormal initial energies (W, R, N) at each walker's
    parameters, by inverse CDF in float64."""
    rng = np.random.default_rng(seed)
    beam_e, e_loss, scale, s = (thetas[:, k, None, None].astype(np.float64)
                                for k in range(4))
    u = rng.uniform(1e-12, 1.0, (thetas.shape[0], N_RUNS, n_draws))
    z = ndtri(u * ndtr(np.log((beam_e - e_loss) / scale) / s))
    return (beam_e - (e_loss + scale * np.exp(s * z))).astype(np.float32)


def _wide_energies(model, seed, shape=(3, 4096), nan=False):
    """Energies over and beyond the model's table and fine grid, with the
    table's ends and values below 0 among them (and a NaN, if asked)."""
    hi = 2000.0 if model == "simult" else 2600.0
    e = np.random.default_rng(seed).uniform(-50.0, hi, shape).astype(
        np.float32)
    e[0, :4] = [20.0 if model == "simult" else 100.0, 2300.0, 2400.0,
                np.nan if nan else 500.0]
    return e


# --- (a) the table lookup --------------------------------------------------

@pytest.mark.parametrize("method", ["onehot", "gather"])
@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_eval_stopped_bitwise(model, method):
    """The float32 lookup (truncating segment index, Horner) equals the
    JAX package's, bit for bit, NaN for NaN, on energies inside and
    outside the table; the tables themselves are held equal in
    tests/test_torch_tables.py."""
    if model == "simult":
        jtab, ttab = jsimult._build_table(8.565e-5), \
            tsimult._build_table(8.565e-5)
    else:
        jtab, ttab = jonebd._build_table(4 * 8.565e-5, 10), \
            tonebd._build_table(tonebd.RHO, 10)
    e = _wide_energies(model, 0, nan=True)
    want = np.stack([np.asarray(jtab.eval_stopped(jnp.asarray(row),
                                                  method=method))
                     for row in e])                          # (rows, N, M)
    got = ttab.eval_stopped(torch.as_tensor(e))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the forward's layout, depth before sample
    from mcmctoffitting_tpu_torch.ops.stopping import eval_stopped
    depth_major = eval_stopped(ttab, torch.as_tensor(e),
                               ttab.coeffs_tensor("cpu"))
    np.testing.assert_array_equal(depth_major.numpy(),
                                  np.swapaxes(want, -1, -2))


# --- (b) moments and grids on the same initial energies ---------------------

def _specs(model, xs_mode, **kw):
    jmod, tmod = PRESETS[model]
    jspec = jmod.default_spec(N_DRAWS, fine_grid=N_FINE, xs_mode=xs_mode)
    tspec = tmod.default_spec(N_DRAWS, fine_grid=N_FINE, xs_mode=xs_mode)
    return (dataclasses.replace(jspec, **kw),
            dataclasses.replace(tspec, **kw))


def _forward(model, tspec):
    tmod = PRESETS[model][1]
    cls = tmod.SimultFitProblem if model == "simult" else tmod.OneBDProblem
    return cls(tspec, device="cpu").forward


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_fine_cell_moments(model, monkeypatch):
    """Each channel S_k (F,) against the JAX package's to 2e-6 of the
    channel's largest cell (both sum float32 terms, in different orders);
    the grid contracted from them more loosely, to 5e-5 of the grid's
    largest cell (the contraction cancels across the channels with
    condition ~16, so 2e-6 of a channel becomes ~3e-5 of the grid).  A NaN
    energy is not among them: the JAX package's one-hot product spreads it
    over every cell, the port drops it; a NaN arises only from NaN
    parameters, and then every sample is NaN and both log-probs are -inf."""
    jspec, tspec = _specs(model, "e0grid")
    fwd = _forward(model, tspec)
    e = _wide_energies(model, 1)
    monkeypatch.setattr(jforward, "_e0grid_contract", lambda spec, m: m)
    want = np.stack([np.asarray(jforward._e0grid_weight_grid(
        jspec, jnp.asarray(row))) for row in e])            # (rows, 4, F)
    got = te0grid.fine_cell_moments(fwd.e0grid, torch.as_tensor(e))
    assert got.shape == want.shape == (3, 4, N_FINE)
    assert want[:, 0].sum() > 0.5 * e.size            # most samples inside
    for k in range(4):
        scale = np.abs(want[:, k]).max()
        np.testing.assert_allclose(got[:, k].numpy(), want[:, k], rtol=0,
                                   atol=2e-6 * scale)
    # the count channel holds integers: equal exactly
    np.testing.assert_array_equal(got[:, 0].numpy(), want[:, 0])
    monkeypatch.undo()
    grid_j = np.stack([np.asarray(jforward._e0grid_contract(
        jspec, jnp.asarray(m))) for m in want])
    grid_t = te0grid.contract(fwd.e0grid, got).numpy()
    np.testing.assert_allclose(grid_t, grid_j, rtol=0,
                               atol=5e-5 * np.abs(grid_j).max())


@pytest.mark.parametrize("xs_mode", ["e0grid", "taylor", "exact"])
@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_energy_weight_grid_on_the_table(model, xs_mode):
    """(M, Be) grids (attenuation included for oneBD) of the same initial
    energies: 'taylor' and 'exact' sum the same float32 terms in another
    order, to 1e-5 of the grid's largest cell; 'e0grid' carries the
    contraction's cancellation, to 5e-5 of it."""
    jspec, tspec = _specs(model, xs_mode)
    fwd = _forward(model, tspec)
    if model == "simult":
        e = _e0_draws(_thetas(2), 2)[:, 0]                  # (2, N)
    else:
        rng = np.random.default_rng(2)
        e = (2490.0 - (1300.0 + 80.0 * np.exp(
            0.6 * rng.standard_normal((2, N_DRAWS))))).astype(np.float32)
    want = np.stack([np.asarray(jforward.energy_weight_grid(
        jspec, jnp.asarray(row))) for row in e])
    got = fwd.energy_weight_grid(torch.as_tensor(e)).numpy()
    assert got.shape == want.shape
    assert np.all(np.isfinite(got)) and np.abs(want).max() > 0
    tol = 5e-5 if xs_mode == "e0grid" else 1e-5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_exact_chunks_agree_on_the_table(monkeypatch):
    """The table 'exact' grid does not depend on how its rows are
    chunked."""
    _, tspec = _specs("simult", "exact")
    fwd = _forward("simult", tspec)
    e0 = torch.as_tensor(_e0_draws(_thetas(2), 3)[:, :, :1024])
    whole = fwd.energy_weight_grid(e0)
    monkeypatch.setattr(tforward, "_EXACT_CHUNK", 3 * 10 * 1024)
    chunked = fwd.energy_weight_grid(e0)
    assert whole.shape == (2, N_RUNS, 10, 50)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


# --- (c) the slice as a whole, injected initial energies ---------------------

@pytest.fixture(scope="module")
def observed():
    """Observed spectra from the port's own default forward at the truth."""
    problem = tsimult.SimultFitProblem(
        tsimult.default_spec(N_DRAWS, fine_grid=N_FINE), n_runs=N_RUNS,
        device="cpu")
    return tdata_io.synthesize_observed(0, problem, TRUTH)


def _inject(monkeypatch, thetas, e0, seed):
    """Both packages' beam draws return ``e0`` (W, R, N); the JAX side
    finds walker w, run r by its draw key, split(fold_in(key_w, r))[0]."""
    keys = jax.random.split(jax.random.PRNGKey(seed), thetas.shape[0])
    table = jnp.stack([jax.random.split(jax.random.fold_in(k, r))[0]
                       for k in keys for r in range(N_RUNS)])
    flat = jnp.asarray(e0.reshape(-1, e0.shape[-1]))

    def jax_draw(key, spec, params, n=0):
        hit = jnp.all(table == key[None], axis=-1)
        return flat[jnp.argmax(hit)]

    monkeypatch.setattr(jforward, "sample_beam_energies", jax_draw)
    monkeypatch.setattr(tforward.TofForward, "sample_beam_energies",
                        lambda self, params, generator: torch.as_tensor(e0))
    return keys


def _jax_both(jspec, likelihood, observed, thetas, keys):
    jprob = jsimult.SimultFitProblem(jspec, n_runs=N_RUNS,
                                     likelihood=likelihood)
    jlogp = jprob.make_log_prob_fn(observed)
    fn = jax.jit(jax.vmap(lambda t, k: (jlogp(t, k),
                                        jprob.run_spectra(t, k))))
    lp, spectra = fn(jnp.asarray(thetas), keys)
    return np.asarray(lp), [np.asarray(s) for s in spectra]


def _port_both(tspec, likelihood, observed, thetas):
    tprob = tsimult.SimultFitProblem(tspec, n_runs=N_RUNS,
                                     likelihood=likelihood, device="cpu")
    t = torch.as_tensor(thetas)
    lp = tprob.make_log_prob_fn(observed)(t, torch.Generator())
    return lp.numpy(), tprob.run_spectra(t, torch.Generator()).numpy(), \
        tprob.windows


def _assert_close(lp_j, spec_j, lp_t, spec_t, windows, observed):
    """Tolerances of tests/test_torch_slice.py::test_parity_without_rint:
    spectra rtol 1e-5 plus 1e-5 of each run's peak, corrected
    log-likelihood to 1e-5 of its term scale."""
    for r, win in enumerate(windows):
        want = spec_j[r]
        np.testing.assert_allclose(spec_t[:, r, :win.n_bins], want,
                                   rtol=1e-5, atol=1e-5 * want.max())
        np.testing.assert_array_equal(spec_t[:, r, win.n_bins:], 0.0)
    scale = sum(np.sum(np.abs(o * np.log(np.maximum(s, 1e-3))) + s, -1)
                for o, s in zip(observed, spec_j))
    # a walker outside the prior box is -inf on both sides
    ok = np.isfinite(lp_j)
    assert ok.sum() >= 3 and np.array_equal(ok, np.isfinite(lp_t))
    assert np.all(np.abs(lp_t[ok] - lp_j[ok]) <= 1e-5 * scale[ok]), (lp_t,
                                                                     lp_j)


@pytest.mark.parametrize("xs_mode", ["e0grid", "taylor", "exact"])
def test_mc_table_parity_without_rint(monkeypatch, observed, xs_mode):
    """simultFit, mc on the table, corrected likelihood, rint_draws=False,
    same initial energies on both sides."""
    thetas = _thetas(seed=1)
    e0 = _e0_draws(thetas, 1)
    keys = _inject(monkeypatch, thetas, e0, 1)
    jspec, tspec = _specs("simult", xs_mode, rint_draws=False)
    lp_j, spec_j = _jax_both(jspec, "poisson", observed, thetas, keys)
    lp_t, spec_t, windows = _port_both(tspec, "poisson", observed, thetas)
    _assert_close(lp_j, spec_j, lp_t, spec_t, windows, observed)


def test_mc_default_parity_with_rint(monkeypatch, observed):
    """The default preset (mc, table, e0grid) with rint_draws=True: the
    spectra to 1e-3 relative L1 per walker and run (a last-bit difference
    of a grid cell can move its rounded draw count by one)."""
    thetas = _thetas(seed=2)
    e0 = _e0_draws(thetas, 2)
    keys = _inject(monkeypatch, thetas, e0, 2)
    jspec, tspec = _specs("simult", "e0grid")
    _, spec_j = _jax_both(jspec, "reference", observed, thetas, keys)
    lp_t, spec_t, windows = _port_both(tspec, "reference", observed, thetas)
    assert np.all(np.isfinite(lp_t))
    for r, win in enumerate(windows):
        got, want = spec_t[:, r, :win.n_bins], spec_j[r]
        rel_l1 = np.abs(got - want).sum(-1) / np.abs(want).sum(-1)
        assert np.all(rel_l1 < 1e-3), (r, rel_l1)


# --- (d) the 'expected' estimator --------------------------------------------

@pytest.mark.parametrize("closure", ["exact", "cell"])
def test_expected_parity(observed, closure):
    """sampling='expected' draws nothing: spectra and corrected log-probs
    against the JAX package's ``tof_spectra_multi`` with the tolerances of
    the other parity tests, and the generator is left alone."""
    thetas = _thetas(seed=3)
    jspec = dataclasses.replace(
        jsimult.default_spec(N_DRAWS, fine_grid=N_FINE, sampling="expected"),
        rint_draws=False, moment_closure=closure)
    tspec = dataclasses.replace(
        tsimult.default_spec(N_DRAWS, fine_grid=N_FINE, sampling="expected"),
        rint_draws=False, moment_closure=closure)
    keys = jax.random.split(jax.random.PRNGKey(3), thetas.shape[0])
    lp_j, spec_j = _jax_both(jspec, "poisson", observed, thetas, keys)
    tprob = tsimult.SimultFitProblem(tspec, n_runs=N_RUNS,
                                     likelihood="poisson", device="cpu")
    gen = torch.Generator().manual_seed(7)
    before = gen.get_state()
    t = torch.as_tensor(thetas)
    lp_t = tprob.make_log_prob_fn(observed)(t, gen).numpy()
    spec_t = tprob.run_spectra(t, gen).numpy()
    assert torch.equal(gen.get_state(), before)
    _assert_close(lp_j, spec_j, lp_t, spec_t, tprob.windows, observed)
    # one grid and one mean for every run of a walker
    grids, means = tprob.forward.grid_and_mean(t[:, :4], gen)
    assert grids.shape == (N_WALKERS, 1, 10, 50)
    assert means.shape == (N_WALKERS, N_RUNS)
    assert torch.equal(means, means[:, :1].expand(-1, N_RUNS))


# --- (e) the preset ----------------------------------------------------------

SPEC_FIELDS = ("transport", "rk4_substeps", "zero_degree", "cell_attenuation",
               "bg_mode", "n_samples", "rint_draws", "n_redraw_rounds",
               "xs_mode", "e0_grid_fine", "sampling", "e0_mean_mode",
               "moment_closure", "a_dtype")


def assert_same_spec(tspec, jspec):
    """Every result-changing field of the port's spec equals the JAX
    preset's; the tables are compared by value."""
    for name in SPEC_FIELDS:
        assert getattr(tspec, name) == getattr(jspec, name), name
    assert dataclasses.asdict(tspec.geometry) == dataclasses.asdict(
        jspec.geometry)
    for name in ("ed_binning", "x_binning"):
        got, want = getattr(tspec, name), getattr(jspec, name)
        assert (got.lo, got.hi, got.n) == (want.lo, want.hi, want.n), name
    assert tspec.stopping.materials == jspec.stopping.materials
    assert type(tspec.beam_timing).__name__ == type(
        jspec.beam_timing).__name__
    np.testing.assert_array_equal(tspec.beam_timing.kernel,
                                  jspec.beam_timing.kernel)
    assert (tspec.stopping_table is None) == (jspec.stopping_table is None)
    if tspec.stopping_table is not None:
        np.testing.assert_array_equal(tspec.stopping_table.table,
                                      jspec.stopping_table.table)
    assert (tspec.e0_grid_table is None) == (jspec.e0_grid_table is None)


SIMULT_ARGS = [dict(), dict(sampling="expected"), dict(xs_mode="taylor"),
               dict(xs_mode="exact"), dict(sampling="counts"),
               dict(n_samples=50_000, sampling="counts"),
               dict(transport="rk4"), dict(transport="rk4", xs_mode="exact"),
               dict(sampling="expected", xs_mode="taylor"),
               dict(fine_grid=96)]


@pytest.mark.parametrize("kw", SIMULT_ARGS,
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in
                                                 kw.items()) or "default")
def test_simult_default_spec_matches_the_jax_preset(kw, monkeypatch):
    """Field by field; the operator build is replaced by a marker on both
    sides (tests/test_torch_e0grid.py holds the operators equal)."""
    import mcmctoffitting_tpu.ops.e0grid as je0grid
    monkeypatch.setattr(je0grid, "cached_e0_grid_table",
                        lambda *a: ("operator",) + a[3:])
    monkeypatch.setattr(tsimult, "cached_e0_grid_table",
                        lambda *a: ("operator",) + a[3:])
    tspec, jspec = tsimult.default_spec(**kw), jsimult.default_spec(**kw)
    assert_same_spec(tspec, jspec)
    assert tspec.e0_grid_table == jspec.e0_grid_table     # same F asked for


# --- (f) short fits ----------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(sampling="expected"),
                                dict(xs_mode="taylor"),
                                dict(xs_mode="exact")],
                         ids=["default", "expected", "taylor", "exact"])
@pytest.mark.parametrize("likelihood", ["reference", "poisson"])
def test_short_de_fit_on_cpu(likelihood, kw):
    spec = tsimult.default_spec(2048, fine_grid=N_FINE, **kw)
    problem = tsimult.SimultFitProblem(spec, n_runs=N_RUNS,
                                       likelihood=likelihood, device="cpu")
    observed = tdata_io.synthesize_observed(0, problem, TRUTH)
    logp = problem.make_log_prob_fn(observed)
    gen = torch.Generator().manual_seed(1)
    p0 = problem.initial_walkers_from_observed(gen, 16, observed)
    eval_gen = torch.Generator().manual_seed(2)
    if kw.get("xs_mode") in ("taylor", "exact"):
        # such a grid is a sum of non-negative weights: every walker finite
        assert torch.all(torch.isfinite(logp(p0, eval_gen)))
    state = sampler.init_state(p0, logp, generator=gen,
                               eval_generator=eval_gen)
    chain = sampler.run_mcmc(state, 6, logp, move="de")
    assert chain.positions.shape == (6, 16, problem.n_dim)
    assert torch.all(torch.isfinite(chain.positions))
    assert torch.isfinite(chain.log_probs[-1]).float().mean() > 0.8
