"""The port's simple model family (v0-v2.5) against the JAX package's, on
the CPU at a small size (8k draws, 8 walkers).

The same (x, z) draws go through both: the JAX package's own
``sample_tof`` / ``SimpleProblem.log_prob`` with ``jax.random.uniform``
and ``jax.random.normal`` replaced for the call by the numpy-seeded
uniforms and normals, and the port's deterministic core.  v0-v2: TOF
values, weights, pdf and log-prob within 1e-5 relative.  v2.5: the port
transports with the closed-form dE/dx where the JAX package evaluates the
full Bethe formula (a difference by design, ROADMAP Queue 3): the
transported energies within 1e-4 relative, the pdf within 1e-3 in L1
(samples 1e-5 keV apart flip a TOF bin now and then).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.cli import simple_tof as jcli
from mcmctoffitting_tpu.constants import TUNL_SSA_CSI as JGEOM
from mcmctoffitting_tpu.constants import TofWindow as JWindow
from mcmctoffitting_tpu.models import simple as jsimple
from mcmctoffitting_tpu.ops import stopping as jstopping
from mcmctoffitting_tpu_torch.constants import TUNL_SSA_CSI, TofWindow
from mcmctoffitting_tpu_torch.models import simple as tsimple
from mcmctoffitting_tpu_torch.ops import stopping as tstopping

torch.set_num_threads(1)

N = 8000
W = 8
MODELS = ("v0", "v1", "v2", "v2.5")


def _specs(model, n=N):
    """(JAX spec, port spec, standoff) as the CLI builds them."""
    cfg = jcli.MODEL_CONFIGS[model]
    kw = dict(poly_order=cfg.get("poly_order", 1),
              sigma_growth=cfg.get("sigma_growth", False),
              xs_weighting=cfg.get("xs", False),
              convolve_beam=cfg.get("conv", False),
              bethe_transport=cfg.get("bethe", False),
              add_half_zero_deg=model != "v0", n_samples=n)
    lo, hi, nb = (175.0, 200.0, 25) if model == "v0" else (175.0, 225.0, 50)
    jspec = jsimple.SimpleSpec(
        window=JWindow(lo, hi, nb), stopping=(
            jstopping.d2_gas_stopping(rho=8.37e-5) if cfg.get("bethe")
            else None), **kw)
    tspec = tsimple.SimpleSpec(
        window=TofWindow(lo, hi, nb), stopping=(
            tstopping.d2_gas_stopping(rho=8.37e-5) if cfg.get("bethe")
            else None), **kw)
    standoff = (JGEOM.cell_to_zero if model == "v0" else JGEOM.standoff_mid)
    return jspec, tspec, standoff


def _thetas(model, w=W, seed=0):
    cfg = jcli.MODEL_CONFIGS[model]
    rng = np.random.default_rng(seed)
    truth = np.asarray(cfg["truth"])
    span = np.asarray(cfg["hi"]) - np.asarray(cfg["lo"])
    return (truth + 0.05 * span * rng.standard_normal((w, len(truth)))
            ).astype(np.float32)


def _draws(w=W, n=N, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (w, n)).astype(np.float32),
            rng.standard_normal((w, n)).astype(np.float32))


def _jax_on_draws(monkeypatch, fn, u, z):
    """``fn()`` with jax.random.uniform / normal returning u (scaled to
    [minval, maxval)) and z."""
    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        return jnp.asarray(u) * (maxval - minval) + minval

    def normal(key, shape=(), dtype=jnp.float32):
        return jnp.asarray(z)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "normal", normal)
    try:
        return fn()
    finally:
        monkeypatch.undo()


def _observed(jspec, standoff, model):
    truth = jnp.asarray(jcli.MODEL_CONFIGS[model]["truth"])
    tofs, _, _, _ = jsimple.sample_tof(jax.random.PRNGKey(7), truth,
                                       jspec, standoff)
    w = jspec.window
    return np.histogram(np.asarray(tofs), w.n_bins, w.range)[0].astype(
        np.float64)


@pytest.mark.parametrize("model", MODELS)
def test_core_matches_the_jax_package(model, monkeypatch):
    """sample_tof, model_pdf and log_prob on the same draws."""
    jspec, tspec, standoff = _specs(model)
    thetas = _thetas(model)
    u, z = _draws()
    cfg = jcli.MODEL_CONFIGS[model]
    obs = _observed(jspec, standoff, model)
    jprob = jsimple.SimpleProblem(spec=jspec, standoff=standoff,
                                  param_lo=cfg["lo"], param_hi=cfg["hi"])
    tprob = tsimple.SimpleProblem(tspec, standoff, cfg["lo"], cfg["hi"],
                                  device="cpu")
    x_t = torch.as_tensor(u) * TUNL_SSA_CSI.cell_length
    z_t = torch.as_tensor(z)
    th_t = torch.as_tensor(thetas)
    t_tofs, t_w, t_ed = tsimple.sample_tof_from_draws(x_t, z_t, th_t, tspec,
                                                      standoff)
    t_pdf = tsimple.model_pdf_from_draws(x_t, z_t, th_t, tspec, standoff)
    t_lp = tprob.log_prob_from_draws(
        th_t, x_t, z_t, torch.as_tensor(obs, dtype=torch.float32)).numpy()
    key = jax.random.PRNGKey(0)
    for i in range(W):
        theta = jnp.asarray(thetas[i])
        j_tofs, j_w, j_ed, _ = _jax_on_draws(
            monkeypatch, lambda: jsimple.sample_tof(key, theta, jspec,
                                                    standoff), u[i], z[i])
        j_pdf = np.asarray(_jax_on_draws(
            monkeypatch, lambda: jsimple.model_pdf(key, theta, jspec,
                                                   standoff), u[i], z[i]))
        j_lp = float(_jax_on_draws(
            monkeypatch, lambda: jprob.log_prob(theta, key, jnp.asarray(
                obs, jnp.float32)), u[i], z[i]))
        if model == "v2.5":
            np.testing.assert_allclose(t_ed[i].numpy(), np.asarray(j_ed),
                                       rtol=1e-4)
            l1 = np.abs(t_pdf[i].numpy() - j_pdf).sum() / np.abs(j_pdf).sum()
            assert l1 < 1e-3, l1
            assert np.isfinite(t_lp[i]) == np.isfinite(j_lp)
            if np.isfinite(j_lp):
                assert abs(t_lp[i] - j_lp) <= 1e-3 * abs(j_lp)
            continue
        np.testing.assert_allclose(t_tofs[i].numpy(), np.asarray(j_tofs),
                                   rtol=1e-6)
        if j_w is None:
            assert t_w is None
        else:
            np.testing.assert_allclose(t_w[i].numpy(), np.asarray(j_w),
                                       rtol=1e-5)
        np.testing.assert_allclose(t_pdf[i].numpy(), j_pdf, rtol=1e-5,
                                   atol=1e-5 * j_pdf.max())
        assert np.isfinite(t_lp[i]) == np.isfinite(j_lp)
        if np.isfinite(j_lp):
            assert abs(t_lp[i] - j_lp) <= 1e-5 * abs(j_lp)


def test_v25_transport_against_the_full_bethe_formula():
    """The closed-form RK4 of the port against the JAX package's RK4 of
    the full formula, at the 10 x centres, within 1e-4 relative."""
    _, tspec, _ = _specs("v2.5")
    rng = np.random.default_rng(3)
    e0 = rng.normal(900.0, 45.0, (4, 2000)).astype(np.float32)
    got = tstopping.rk4_transport(tsimple._rk4(tspec), torch.as_tensor(e0))
    want = jstopping.rk4_transport(
        jstopping.d2_gas_stopping(rho=8.37e-5).dedx, jnp.asarray(e0),
        tsimple.transport_centres(tspec), n_substeps=4)   # (M, 4, N)
    np.testing.assert_allclose(got.numpy(),
                               np.moveaxis(np.asarray(want), 0, 1),
                               rtol=1e-4)


def test_problem_batches_walkers_and_outside_the_box_is_minus_inf():
    """log_prob is per walker: a batch equals its rows one at a time on
    the same draws; a walker on the strict box edge is -inf; the default
    device is the GPU."""
    _, tspec, standoff = _specs("v1")
    cfg = jcli.MODEL_CONFIGS["v1"]
    prob = tsimple.SimpleProblem(tspec, standoff, cfg["lo"], cfg["hi"],
                                 device="cpu")
    thetas = torch.as_tensor(_thetas("v1", 4))
    thetas[3, 0] = cfg["lo"][0]
    u, z = _draws(4)
    x = torch.as_tensor(u) * TUNL_SSA_CSI.cell_length
    pdf = tsimple.model_pdf_from_draws(x[:3], torch.as_tensor(z[:3]),
                                       thetas[:3], tspec, standoff)
    obs = torch.where(torch.all(pdf > 0, dim=0), 20.0, 0.0)
    batch = prob.log_prob_from_draws(thetas, x, torch.as_tensor(z), obs)
    for i in range(4):
        one = prob.log_prob_from_draws(thetas[i:i + 1], x[i:i + 1],
                                       torch.as_tensor(z[i:i + 1]), obs)
        assert torch.equal(one[0], batch[i])
    assert torch.isneginf(batch[3]) and torch.all(torch.isfinite(batch[:3]))
    lp = prob.make_log_prob_fn(obs.numpy())(thetas,
                                            torch.Generator().manual_seed(0))
    assert lp.shape == (4,)
    import mcmctoffitting_tpu_torch.models.forward as fwd
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            tsimple.SimpleProblem(tspec, standoff, cfg["lo"], cfg["hi"])
    finally:
        monkey.undo()
    assert fwd.resolve_device("cpu").type == "cpu"


def test_multinomial_loglike_guards():
    """Zero-count bins add 0 whatever the pdf; data where the pdf is 0
    gives -inf; NaN gives -inf; batched over walkers; equal to the JAX
    package's on the same arrays."""
    from mcmctoffitting_tpu.ops.likelihoods import (
        multinomial_loglike as jmulti)
    from mcmctoffitting_tpu_torch.ops.likelihoods import multinomial_loglike
    rng = np.random.default_rng(4)
    pdf = rng.uniform(0.0, 0.1, (5, 12)).astype(np.float32)
    obs = rng.poisson(3.0, 12).astype(np.float32)
    obs[2] = 0
    pdf[1, 2] = 0.0            # no data there: still finite
    pdf[2, 3] = 0.0
    obs[3] = 4.0               # data where the pdf is 0: -inf
    pdf[3, 5] = np.nan
    got = multinomial_loglike(torch.as_tensor(pdf),
                              torch.as_tensor(obs)).numpy()
    want = np.array([float(jmulti(jnp.asarray(p), jnp.asarray(obs)))
                     for p in pdf])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.isfinite(got[[0, 1, 4]]).all()
    assert got[2] == -np.inf and got[3] == -np.inf
