"""The port's gradient samplers (mcmctoffitting_tpu_torch.sampler: NUTS,
HMC, random-walk Metropolis) in distribution, and ``-sampler nuts|hmc``
of its two flagship command-line drivers, on the CPU.

The samplers draw from torch generators, so chains are compared with the
JAX package's in law, on the targets and with the bounds of
``tests/test_nuts.py``, ``tests/test_hmc.py`` and
``tests/test_gradient_cli.py`` (chains a little shorter where the bound
allows it): standard-normal moments, a correlated Gaussian's covariance,
the divergence flag on a pathological target, mass adaptation on an
anisotropic target; the CLI refuses what the JAX CLI refuses, with its
messages, and a ``-device cpu -debug 1`` run writes a ``mainchain.dat``
that parses back.
"""
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.cli import csi_onebd as tcli_onebd
from mcmctoffitting_tpu_torch.cli import simult_fit as tcli_simult
from mcmctoffitting_tpu_torch.sampler import (hmc_sample, metropolis_sample,
                                              nuts_sample)
from mcmctoffitting_tpu_torch.sampler._adapt import LogpAndGrad
from mcmctoffitting_tpu_torch.sampler.nuts import _transition
from mcmctoffitting_tpu_torch.utils import chain_io

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _flat(positions, burn=0):
    z = positions[burn:].numpy()
    return z.reshape(-1, z.shape[-1])


def _gaussian(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def test_nuts_standard_normal_moments():
    p0 = torch.randn((4, 3), generator=_gen(0))
    chain = nuts_sample(_gen(1), p0, 600, _gaussian, n_warmup=200,
                        max_depth=6)
    z = _flat(chain.positions)
    tol = 4.0 / np.sqrt(400.0)
    assert np.abs(z.mean(axis=0)).max() < tol
    assert np.abs(z.std(axis=0) - 1.0).max() < 2.0 * tol
    assert 0.05 < chain.step_size < 5.0
    assert 0.55 < float(chain.accept_stat.mean()) <= 1.0
    assert not bool(chain.diverging.any())
    assert chain.positions.shape == (600, 4, 3)
    assert chain.log_probs.shape == chain.tree_depth.shape == (600, 4)
    # one batched evaluation per leaf (at most 2^6 - 1 a transition), of
    # the chains still building their trees
    assert 800 < chain.n_grad_evals <= 1 + 800 * 63
    assert chain.n_grad_evals < chain.n_chain_grads < 4 * chain.n_grad_evals


def test_nuts_correlated_gaussian_covariance():
    cov = np.array([[1.0, 0.95], [0.95, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)

    def logp(x):
        return -0.5 * torch.sum((x @ prec) * x, dim=-1)

    p0 = 0.1 * torch.randn((4, 2), generator=_gen(2))
    chain = nuts_sample(_gen(3), p0, 600, logp, n_warmup=300, max_depth=8)
    z = _flat(chain.positions, burn=100)
    emp = np.cov(z.T)
    assert np.abs(emp - cov).max() < 0.2, emp
    # the correlated target needs multi-doubling trajectories
    mean_depth = float(chain.tree_depth.float().mean())
    assert 1.5 < mean_depth < 8.0, mean_depth


def test_nuts_divergence_flag_on_pathological_target():
    """A target of scale 1/50 at a step size of 10 flags divergences."""
    def logp(x):
        return -0.5 * torch.sum((x * 50.0) ** 2, dim=-1)

    vg = LogpAndGrad(logp)
    p0 = torch.ones((2, 2))
    lp0, g0 = vg(p0)
    out = _transition(vg, p0, lp0, g0, torch.tensor(10.0), 4, torch.ones(2),
                      _gen(7))
    assert bool(out[5].all())
    # a divergent first leaf ends the transition at depth 1, and the chain
    # stays where it was
    assert out[4].tolist() == [1, 1]
    assert torch.equal(out[0], p0)


def test_nuts_mass_matrix_adaptation_handles_anisotropy():
    """Scales (1, 0.05): the windowed warm-up estimates the diagonal metric
    and recovers both scales; the identity metric needs deeper trees."""
    scales = torch.tensor([1.0, 0.05])

    def logp(x):
        return -0.5 * torch.sum((x / scales) ** 2, dim=-1)

    p0 = torch.randn((4, 2), generator=_gen(11)) * scales
    chain = nuts_sample(_gen(12), p0, 500, logp, n_warmup=300, max_depth=8)
    z = _flat(chain.positions, burn=100)
    assert abs(z[:, 0].std() - 1.0) < 0.15
    assert abs(z[:, 1].std() - 0.05) < 0.01
    im = chain.inv_mass.numpy()
    assert 0.4 < im[0] < 2.5
    assert 0.4 < im[1] / 0.05 ** 2 < 2.5
    depth_adapted = float(chain.tree_depth.float().mean())
    chain_id = nuts_sample(_gen(13), p0, 100, logp, n_warmup=100,
                           max_depth=8, adapt_mass=False)
    depth_identity = float(chain_id.tree_depth.float().mean())
    assert depth_adapted < depth_identity, (depth_adapted, depth_identity)


def test_nuts_finished_chains_are_masked():
    """Chains end their transitions at different depths: each leaf
    evaluates only the chains whose subtree is still growing, and the
    depths of one transition differ between chains (an anisotropic target
    of scales 1 and 30 under the identity metric)."""
    scales = torch.tensor([1.0, 30.0])

    def logp(x):
        return -0.5 * torch.sum((x / scales) ** 2, dim=-1)

    vg = LogpAndGrad(logp)
    z = torch.randn((8, 2), generator=_gen(4)) * scales
    lp, g = vg(z)
    gen = _gen(5)
    spread = []
    for _ in range(20):
        z, lp, g, _, depth, _ = _transition(vg, z, lp, g, torch.tensor(0.5),
                                            8, torch.ones(2), gen)
        assert (depth >= 1).all() and (depth <= 8).all()
        spread.append(int(depth.max() - depth.min()))
    assert max(spread) >= 2
    assert vg.chain_evals < 8 * vg.calls


def test_hmc_recovers_gaussian():
    p0 = 0.1 * torch.randn((8, 3), generator=_gen(0))
    chain = hmc_sample(_gen(1), p0, 400, _gaussian, n_warmup=150)
    samples = _flat(chain.positions, burn=100)
    assert abs(samples.mean()) < 0.1
    np.testing.assert_allclose(samples.std(axis=0), 1.0, atol=0.12)
    assert 0.01 < chain.step_size < 2.0
    assert float(chain.accept_prob.mean()) > 0.5
    # one call per leapfrog step, at most 19 steps per transition
    assert chain.n_grad_evals <= 1 + 550 * 19


def test_hmc_correlated_target():
    cov = np.array([[1.0, 0.8], [0.8, 1.0]])
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)

    def logp(x):
        return -0.5 * torch.sum((x @ prec) * x, dim=-1)

    p0 = 0.1 * torch.randn((8, 2), generator=_gen(2))
    chain = hmc_sample(_gen(3), p0, 500, logp, n_warmup=150)
    got = np.cov(_flat(chain.positions, burn=150).T)
    np.testing.assert_allclose(got, cov, atol=0.2)


def test_metropolis_recovers_gaussian():
    p0 = 0.1 * torch.randn((16, 2), generator=_gen(4))
    qs, lps, acc = metropolis_sample(_gen(5), p0, 2000, _gaussian,
                                     proposal_scale=0.8)
    samples = _flat(qs, burn=500)
    assert abs(samples.mean()) < 0.12
    np.testing.assert_allclose(samples.std(axis=0), 1.0, atol=0.15)
    assert 0.1 < float(acc.float().mean()) < 0.9
    assert torch.equal(lps[-1], _gaussian(qs[-1]))


# --- the command-line drivers ------------------------------------------------

def test_gradient_sampler_requires_differentiable_config(tmp_path,
                                                         monkeypatch):
    """The JAX CLI's one-line errors where the configuration has no
    gradient (``tests/test_gradient_cli.py``)."""
    monkeypatch.chdir(tmp_path)
    cpu = ["-device", "cpu", "-debug", "1", "-batch", "1"]
    with pytest.raises(SystemExit, match="expectedForward"):
        tcli_simult.main(cpu + ["-sampler", "nuts"])
    with pytest.raises(SystemExit, match="likelihood"):
        tcli_simult.main(cpu + ["-sampler", "hmc", "-expectedForward"])
    with pytest.raises(SystemExit, match="deterministicBG"):
        tcli_onebd.main(cpu + ["-sampler", "nuts", "-expectedForward",
                               "-likelihood", "poisson"])
    with pytest.raises(SystemExit, match="resume"):
        tcli_simult.main(cpu + ["-sampler", "nuts", "-expectedForward",
                                "-likelihood", "poisson", "-resume",
                                "x.npz"])


def test_nuts_cli_end_to_end(tmp_path, monkeypatch, capsys):
    """A tiny NUTS fit of simultFit on the CPU: the chain in the emcee
    text format, medians near the synthesis truth (the expected forward is
    noiseless), the rate line and the tree statistics printed."""
    monkeypatch.chdir(tmp_path)
    out = tcli_simult.main(["-device", "cpu", "-debug", "1", "-nRuns", "1",
                            "-batch", "1", "-sampler", "nuts",
                            "-expectedForward", "-likelihood", "poisson",
                            "-nChains", "2", "-maxDepth", "2"])
    q = out["quantiles"]
    assert abs(q["beamE"][0] - 1878.4) < 40.0
    assert abs(q["eLoss"][0] - 850.0) < 60.0
    assert abs(q["s"][0] - 0.5) < 0.1
    chain, _, n_params, n_walkers, n_steps = chain_io.read_chain_text(
        "mainchain.dat")
    assert (n_steps, n_walkers, n_params) == (10, 2, 5)
    assert np.isfinite(chain).all()
    text = capsys.readouterr().out
    assert "rint draw rounding disabled" in text
    assert "mean tree depth" in text and "divergences" in text
    assert '{"walker_steps_per_sec": ' in text
    assert out["walker_steps_per_sec"] > 0


@pytest.mark.parametrize("model,sampler", [("simult", "hmc"),
                                           ("onebd", "nuts")])
def test_gradient_cli_runs_both_flagships(model, sampler, tmp_path,
                                          monkeypatch):
    """-sampler hmc on simultFit and -sampler nuts on oneBD (expected
    forward, deterministic background): finite quantiles for every
    parameter and a chain of (10, chains, D)."""
    monkeypatch.chdir(tmp_path)
    argv = ["-device", "cpu", "-debug", "1", "-batch", "1", "-sampler",
            sampler, "-expectedForward", "-likelihood", "poisson",
            "-nChains", "2", "-maxDepth", "2"]
    if model == "simult":
        out = tcli_simult.main(argv + ["-nRuns", "1"])
        n_dim = 5
    else:
        out = tcli_onebd.main(argv + ["-deterministicBG"])
        n_dim = 9
    q = out["quantiles"]
    assert len(q) == n_dim
    assert all(np.all(np.isfinite(v)) for v in q.values())
    chain, _, d, w, s = chain_io.read_chain_text("mainchain.dat")
    assert (s, w, d) == (10, 2, n_dim)
