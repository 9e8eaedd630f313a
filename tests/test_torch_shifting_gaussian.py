"""The port's shifting-Gaussian model and its CLI against the JAX
package's, on the CPU at small sizes.

(a) The model's functions (projected pdf in closed form and by the
    64-node rule, log-likelihood, box prior, log-probability) on 64 thetas
    that include the box's edges, batched, against the JAX functions
    vmapped over the same thetas: within 1e-5 relative where finite (the
    closed form also within the float32 erf's rounding, see ERF_ULPS),
    the same non-finite values elsewhere, the prior exactly.
(b) ``cli.shifting_gaussian`` at ``--debug`` (analytic) and ``-model
    tof`` at small sizes: the JAX CLI's printed lines and result keys, the
    JAX tests' gates (tests/test_shifting_gaussian.py,
    tests/test_pt_sampler.py), the chain files; without a GPU the default
    device is an error.
"""
import io
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import quad

from mcmctoffitting_tpu.cli import shifting_gaussian as jcli
from mcmctoffitting_tpu.models import shifting_gaussian as jsg
from mcmctoffitting_tpu_torch.cli import shifting_gaussian as tcli
from mcmctoffitting_tpu_torch.models import shifting_gaussian as tsg
from mcmctoffitting_tpu_torch.utils import chain_io

torch.set_num_threads(1)

EDGES = np.array([[0.0, -0.2, 5.0], [5.0, -0.2, 5.0], [1.0, -0.5, 5.0],
                  [1.0, 0.1, 5.0], [1.0, -0.2, 0.0], [1.0, -0.2, 10.0],
                  [5.0, 0.1, 10.0], [4.999, -0.499, 9.999]], np.float32)


def _thetas():
    """56 thetas inside the box (sigma >= 1, so no projected density
    underflows) and the 8 edge thetas: (64, 3) float32."""
    rng = np.random.default_rng(0)
    inside = np.stack([rng.uniform(1.0, 4.9, 56), rng.uniform(-0.49, 0.09, 56),
                       rng.uniform(0.5, 9.5, 56)], axis=1)
    return np.concatenate([inside.astype(np.float32), EDGES])


def _data(n=400):
    rng = np.random.default_rng(1)
    x = rng.uniform(0.0, 10.0, n)
    return (-0.2 * x + 6.0 + rng.standard_normal(n)).astype(np.float32)


# The closed form divides a difference of two float32 erf values by m.
# Each package's erf is within two ulps (2^-24 each, near 1) of the true
# value, so where the difference is small the two packages' results may
# differ by up to ERF_ULPS x 2^-24 x sqrt(pi/2) sigma / |m|, whatever the
# order of operations; the comparison allows that beside the 1e-5
# relative (the 64-node rule needs no such allowance).
ERF_ULPS = 8


def _erf_slack(thetas):
    """(B, 1) absolute error of the closed-form pdf from float32 erf."""
    sigma, m = thetas[:, 0:1].astype(np.float64), thetas[:, 1:2]
    return ERF_ULPS * 2.0 ** -24 * np.sqrt(np.pi / 2) * sigma / np.abs(m)


def _close(got, want, rtol=1e-5, atol=0.0):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    atol = np.broadcast_to(atol, want.shape)[finite]
    assert np.all(np.abs(got[finite] - want[finite])
                  <= rtol * np.abs(want[finite]) + atol)


@pytest.mark.parametrize("numeric", [False, True])
def test_projected_pdf_matches_jax(numeric):
    thetas, y = _thetas()[:56], _data(50)
    t = torch.as_tensor(thetas)
    sigma, m, b = (t[:, k, None] for k in range(3))
    fn_t = (tsg.projected_prob_numeric if numeric
            else tsg.projected_prob_analytic)
    fn_j = (jsg.projected_prob_numeric if numeric
            else jsg.projected_prob_analytic)
    got = fn_t(torch.as_tensor(y), m, b, sigma).numpy()
    want = np.stack([np.asarray(fn_j(y, th[1], th[2], th[0]))
                     for th in thetas])
    _close(got, want, atol=0.0 if numeric else _erf_slack(thetas))


def test_numeric_projection_matches_quad():
    sigma, m, b = 1.2, -0.2, 6.0
    y = np.linspace(2.0, 8.0, 25)
    got = tsg.projected_prob_numeric(torch.as_tensor(y, dtype=torch.float32),
                                     m, b, sigma).numpy()

    def integrand(x, yv):
        return (np.exp(-((yv - (m * x + b)) ** 2) / (2 * sigma ** 2))
                / (sigma * np.sqrt(2 * np.pi)))

    want = np.array([quad(integrand, 0.0, 10.0, args=(yv,))[0] for yv in y])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("numeric", [False, True])
def test_loglike_prior_and_lnprob_match_jax(numeric):
    thetas, y = _thetas(), _data()
    t, obs = torch.as_tensor(thetas), torch.as_tensor(y)
    jy = jnp.asarray(y)
    want_ll = jax.vmap(lambda th: jsg.loglike_projected(
        th, jy, numeric=numeric))(thetas)
    want_lp = jax.vmap(jsg.lnprior)(thetas)
    want = jax.vmap(lambda th: jsg.lnprob(th, jy, numeric=numeric))(thetas)
    slack = 0.0
    if not numeric:
        # first order in log p: the erf slack of each term over its p
        with np.errstate(divide="ignore", invalid="ignore"):
            p = np.stack([np.asarray(jsg.projected_prob_analytic(
                y, th[1], th[2], th[0]), np.float64) for th in thetas])
            slack = np.nan_to_num(
                (_erf_slack(thetas) / np.abs(p)).sum(-1), posinf=0.0)
    _close(tsg.loglike_projected(t, obs, numeric=numeric), want_ll,
           atol=slack)
    np.testing.assert_array_equal(tsg.lnprior(t).numpy(),
                                  np.asarray(want_lp))
    _close(tsg.lnprob(t, obs, numeric=numeric), want, atol=slack)
    # the edges are outside the strict box, the rest inside
    assert np.all(np.isneginf(tsg.lnprior(t).numpy()[56:-1]))
    assert np.all(tsg.lnprior(t).numpy()[:56] == 0.0)
    # the closures the samplers take
    logp = tsg.make_log_prob_fn(y, numeric=numeric)
    _close(logp(t, torch.Generator()), want, atol=slack)
    loglike, logprior = tsg.make_pt_fns(y, numeric=numeric)
    _close(loglike(t), want_ll, atol=slack)
    assert logprior is tsg.lnprior


def test_generate_data_follows_the_model():
    y = tsg.generate_data(torch.Generator().manual_seed(0), 200_000,
                          1.0, -0.2, 6.0).numpy()
    assert y.dtype == np.float32 and y.shape == (200_000,)
    # x uniform on [0, 10]: mean m 5 + b, variance m^2 100/12 + sigma^2
    assert abs(y.mean() - 5.0) < 0.01
    assert abs(y.var() - (0.04 * 100 / 12 + 1.0)) < 0.02


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue().splitlines()


def _shape(lines):
    """The printed lines reduced to their fixed words: the text before the
    first number, and the keys of a JSON line."""
    import json
    shape = []
    for line in lines:
        if line.startswith("{"):
            shape.append(sorted(json.loads(line)))
        else:
            shape.append(line.split("=")[0].split(":")[0].split("(")[0])
    return shape


def test_analytic_cli_debug(tmp_path):
    """--debug on the CPU: the JAX CLI's lines and keys (the port adds one
    rate line), the JAX test's gates, the two chain files."""
    result, lines = _run(tcli.main, [
        "--debug", "-device", "cpu",
        "-outputPrefix", str(tmp_path / "sg_")])
    assert abs(result["pt"]["sigma"] - tcli.TRUTH[0]) < 0.3
    assert abs((5 * result["pt"]["m"] + result["pt"]["b"])
               - (5 * tcli.TRUTH[1] + tcli.TRUTH[2])) < 0.5
    ln_z, d_ln_z = result["pt_ln_evidence"]
    assert np.isfinite(ln_z) and np.isfinite(d_ln_z) and d_ln_z >= 0.0
    assert all(0.0 < s < 1.0 for s in result["pt_swap_acceptance"])
    assert len(result["pt_swap_acceptance"]) == 3
    assert result["pt_walker_steps_per_sec"] > 0
    assert result["ensemble_walker_steps_per_sec"] > 0
    # the JAX CLI on the same (tiny) flags prints the same lines
    tiny = ["-nSamples", "100", "-nWalkers", "8", "-nSteps", "4",
            "-nTemps", "3", "-ptWalkers", "8", "-ptBurnin", "2",
            "-ptSteps", "4", "-thin", "2"]
    want, want_lines = _run(jcli.main, tiny + [
        "-outputPrefix", str(tmp_path / "j_")])
    got, got_lines = _run(tcli.main, tiny + [
        "-device", "cpu", "-outputPrefix", str(tmp_path / "t_")])
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"pt_walker_steps_per_sec",
                                    "ensemble_walker_steps_per_sec"}
    rate_line = [sorted(["pt_walker_steps_per_sec",
                         "ensemble_walker_steps_per_sec"])]
    assert _shape(got_lines) == (_shape(want_lines)[:-1] + rate_line
                                 + _shape(want_lines)[-1:])
    for prefix in ("j_", "t_"):
        pos, lp = chain_io.read_chain_text(
            str(tmp_path / f"{prefix}chain.dat"))[:2]
        assert pos.shape == (4, 8, 3) and np.all(np.isfinite(lp))
        pos, lp = chain_io.read_chain_text(
            str(tmp_path / f"{prefix}pt_coldchain.dat"))[:2]
        assert pos.shape == (2, 8, 3) and np.all(np.isfinite(lp))


def test_tof_cli_small(tmp_path, monkeypatch):
    """-model tof on the CPU at the JAX test's widths (4 temperatures x 16
    walkers, 2 runs), its 50k draws cut to 8k and fewer steps: the JAX
    CLI's keys and lines, the ridge traversed, swaps firing, ln Z
    reported."""
    from mcmctoffitting_tpu_torch.models import simult
    default_spec = simult.default_spec
    monkeypatch.setattr(simult, "default_spec", lambda n_samples, **kw:
                        default_spec(min(n_samples, 8000), **kw))
    result, lines = _run(tcli.main, [
        "-model", "tof", "-device", "cpu", "-nTemps", "4", "-ptWalkers",
        "16", "-ptBurnin", "10", "-ptSteps", "30", "-thin", "2",
        "-outputPrefix", str(tmp_path / "sg_")])
    assert {"beamE_span_keV", "swap_acceptance",
            "pt_ln_evidence"} <= set(result)
    assert result["beamE_span_keV"] > 1.0
    assert all(0.0 <= s <= 1.0 for s in result["swap_acceptance"])
    assert max(result["swap_acceptance"]) > 0.01
    ln_z, d_ln_z = result["pt_ln_evidence"]
    assert np.isfinite(ln_z) and np.isfinite(d_ln_z) and d_ln_z >= 0.0
    assert result["initial_finite_fraction"] >= 0.98
    assert lines[0].startswith("PT on reduced TOF posterior (4 temps x 16")
    assert any("cold-chain beamE 95% span" in line for line in lines)
    assert any("ln Z (thermodynamic integration)" in line for line in lines)
    assert lines[-1].startswith('{"beamE_span_keV"')


def test_entry_points_need_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--debug"], ["-model", "tof"]):
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            tcli.main(argv)
