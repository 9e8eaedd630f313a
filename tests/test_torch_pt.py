"""The port's parallel tempering (mcmctoffitting_tpu_torch.sampler.pt)
against the JAX package's, on the CPU at small sizes.

(a) The ladder and the thermodynamic-integration evidence: the same
    numbers as the JAX package's on the same (S, T, W) array (within
    1e-12), odd ladders included, and the same ValueErrors.
(b) The deterministic cores fed the draws the JAX functions make from a
    fixed key, reproduced here by the JAX package's own key splits
    (``sampler/pt.py:173``, ``:211-213``, ``:244-245``, ``:279``): the
    tempered stretch and DE half-updates, the replica-exchange sweep and
    one whole step of each move give the same positions (within 1e-6),
    log-likelihoods, log-priors, accept masks and swap counts.
(c) In distribution, the port alone at the JAX tests' sizes and
    tolerances (tests/test_pt_sampler.py, tests/test_pt_evidence.py): the
    cold chain recovers a Gaussian, hot rungs are wider, swaps happen, a
    bimodal target is mixed, thinning keeps rows 0, thin, ..., the
    adaptive ladder equalizes interior swap acceptance, and the TI ln Z
    matches the analytic Gaussian evidence and ranks two models.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.sampler import pt as jpt
from mcmctoffitting_tpu_torch.models import shifting_gaussian as tsg
from mcmctoffitting_tpu_torch.sampler import pt as tpt

torch.set_num_threads(1)

T, W, D = 5, 12, 3


# --- (a) the ladder and the evidence --------------------------------------

@pytest.mark.parametrize("n_temps, t_max", [(5, None), (4, 100.0),
                                            (16, None), (21, None),
                                            (7, 300.0)])
def test_default_beta_ladder_matches_jax(n_temps, t_max):
    got = tpt.default_beta_ladder(n_temps, t_max)
    want = jpt.default_beta_ladder(n_temps, t_max)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[0] == 1.0


@pytest.mark.parametrize("n_temps", [4, 15, 16, 21])
def test_ti_evidence_matches_jax(n_temps):
    rng = np.random.default_rng(n_temps)
    betas = jpt.default_beta_ladder(n_temps)
    ll = (-3.0 - 2.0 * rng.standard_normal((40, n_temps, 8))
          - 5.0 * betas[None, :, None]).astype(np.float32)
    for fburnin in (0.1, 0.3):
        got = tpt.thermodynamic_integration_log_evidence(
            torch.as_tensor(ll), betas, fburnin=fburnin)
        want = jpt.thermodynamic_integration_log_evidence(
            jnp.asarray(ll), betas, fburnin=fburnin)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # a ladder that reaches beta = 0 takes no extrapolated endpoint
    betas0 = np.linspace(1.0, 0.0, n_temps)
    np.testing.assert_allclose(
        tpt.thermodynamic_integration_log_evidence(ll, betas0),
        jpt.thermodynamic_integration_log_evidence(ll, betas0),
        rtol=0, atol=1e-12)


def test_ti_odd_ladder_error_bar_keeps_beta0_endpoint():
    """Mean ln L exactly linear in beta: the trapezoid rule is exact at any
    resolution, so the error bar is ~0 for odd and even ladders."""
    for n_temps in (15, 16, 21):
        betas = tpt.default_beta_ladder(n_temps)
        ll = (2.0 + 3.0 * betas)[None, :, None] * np.ones((50, n_temps, 4))
        ln_z, d_ln_z = tpt.thermodynamic_integration_log_evidence(
            ll, betas, fburnin=0.2)
        assert d_ln_z < 1e-3, (n_temps, d_ln_z)
        assert abs(ln_z - 3.5) < 1e-2
        assert (ln_z, d_ln_z) == jpt.thermodynamic_integration_log_evidence(
            ll, betas, fburnin=0.2)


def test_ti_rejects_bad_ladders():
    betas = tpt.default_beta_ladder(6)
    ll = np.zeros((10, 6, 4))
    for mod in (tpt, jpt):
        with pytest.raises(ValueError, match="decreasing"):
            mod.thermodynamic_integration_log_evidence(ll, betas[::-1])
        with pytest.raises(ValueError, match="decreasing"):
            mod.thermodynamic_integration_log_evidence(ll, betas * 0.5)
        with pytest.raises(ValueError, match="T == len"):
            mod.thermodynamic_integration_log_evidence(ll, betas[:-1])
        with pytest.raises(ValueError, match="T == len"):
            mod.thermodynamic_integration_log_evidence(ll[0], betas)


# --- (b) the cores on the JAX package's draws ------------------------------

def _jax_loglike(theta):
    return -0.5 * jnp.sum((theta - 0.3) ** 2 / 0.7)


def _jax_logprior(theta):
    return jnp.where(jnp.all(jnp.abs(theta) < 2.0), 0.0, -jnp.inf)


def _torch_loglike(theta):
    return -0.5 * torch.sum((theta - 0.3) ** 2 / 0.7, dim=-1)


def _torch_logprior(theta):
    return torch.where(torch.all(theta.abs() < 2.0, dim=-1), 0.0,
                       -torch.inf)


def _evaluate(prop):
    return _torch_loglike(prop), _torch_logprior(prop)


def _inputs(seed):
    """(T, W, D) walkers, some outside the prior box, and their ll, lp
    (one -inf log-likelihood among them)."""
    pos = np.random.default_rng(seed).normal(0.0, 1.0, (T, W, D)).astype(
        np.float32)
    ll = np.array(jax.vmap(jax.vmap(_jax_loglike))(pos))
    lp = np.asarray(jax.vmap(jax.vmap(_jax_logprior))(pos))
    ll[2, 3] = -np.inf
    return pos, ll, lp


def _to_torch(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


def _jax_batched():
    return (jpt._make_batched(_jax_loglike, False),
            jpt._make_batched(_jax_logprior, False))


def _assert_same(got, want):
    """(pos, ll, lp, ...) of the port against the JAX package's."""
    pos_t, ll_t, lp_t = got[:3]
    pos_j, ll_j, lp_j = (np.asarray(v) for v in want[:3])
    np.testing.assert_allclose(pos_t.numpy(), pos_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(lp_t.numpy(), lp_j)


def _stretch_draws(key, n_half):
    kz, kj, ku, _ = jax.random.split(key, 4)
    u = jax.random.uniform(kz, (T, n_half))
    j = jax.random.randint(kj, (T, n_half), 0, n_half)
    log_u = jnp.log(jax.random.uniform(ku, (T, n_half)))
    return _to_torch(u, np.asarray(j, np.int64), log_u)


def _de_draws(key, n_half, gamma0, de_sigma):
    kg, kj, ku, _ = jax.random.split(key, 4)
    k1, k2 = jax.random.split(kj)
    j1 = jax.random.randint(k1, (T, n_half), 0, n_half)
    j2 = (j1 + 1 + jax.random.randint(k2, (T, n_half), 0,
                                      n_half - 1)) % n_half
    g = gamma0 * (1.0 + de_sigma * jax.random.normal(kg, (T, n_half)))
    log_u = jnp.log(jax.random.uniform(ku, (T, n_half)))
    return _to_torch(g, np.asarray(j1, np.int64), np.asarray(j2, np.int64),
                     log_u)


def _exchange_draws(key, n_temps, n_walkers):
    perms = np.zeros((n_temps - 1, n_walkers), np.int64)
    log_u = np.zeros((n_temps - 1, n_walkers), np.float32)
    for i in range(n_temps - 2, -1, -1):
        k_perm, k_acc, key = jax.random.split(jax.random.fold_in(key, i), 3)
        perms[i] = np.asarray(jax.random.permutation(k_perm, n_walkers))
        log_u[i] = np.asarray(jnp.log(jax.random.uniform(k_acc,
                                                         (n_walkers,))))
    return _to_torch(perms, log_u)


BETAS = jpt.default_beta_ladder(T, t_max=20.0)


@pytest.mark.parametrize("parity", [0, 1])
def test_tempered_stretch_core_matches_jax(parity):
    pos, ll, lp = _inputs(1)
    key = jax.random.key(11 + parity)
    llb, lpb = _jax_batched()
    want = jpt._tempered_half_update(
        jnp.asarray(pos), jnp.asarray(ll), jnp.asarray(lp),
        jnp.asarray(BETAS, jnp.float32), parity, key, llb, lpb, 2.0, D)
    u, j, log_u = _stretch_draws(key, W // 2)
    pos_t, ll_t, lp_t = _to_torch(pos, ll, lp)
    acc = tpt.tempered_stretch_core(
        pos_t, ll_t, lp_t, torch.as_tensor(BETAS, dtype=torch.float32),
        parity, u, j, log_u, _evaluate, 2.0)
    _assert_same((pos_t, ll_t, lp_t), want)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want[3]))
    assert 0 < int(acc.sum()) < acc.numel()


@pytest.mark.parametrize("parity", [0, 1])
def test_tempered_de_core_matches_jax(parity):
    pos, ll, lp = _inputs(2)
    key = jax.random.key(21 + parity)
    gamma0, de_sigma = 2.38 / (2.0 * D) ** 0.5, 0.1
    llb, lpb = _jax_batched()
    want = jpt._tempered_half_update_de(
        jnp.asarray(pos), jnp.asarray(ll), jnp.asarray(lp),
        jnp.asarray(BETAS, jnp.float32), parity, key, llb, lpb, gamma0,
        de_sigma)
    g, j1, j2, log_u = _de_draws(key, W // 2, gamma0, de_sigma)
    pos_t, ll_t, lp_t = _to_torch(pos, ll, lp)
    acc = tpt.tempered_de_core(
        pos_t, ll_t, lp_t, torch.as_tensor(BETAS, dtype=torch.float32),
        parity, g, j1, j2, log_u, _evaluate)
    _assert_same((pos_t, ll_t, lp_t), want)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want[3]))
    assert 0 < int(acc.sum()) < acc.numel()


def test_replica_exchange_core_matches_jax():
    pos, ll, lp = _inputs(3)
    ll[0, 5] = ll[1, 7] = -np.inf     # -inf on both sides of a pair
    key = jax.random.key(31)
    betas = jnp.asarray(BETAS, jnp.float32)
    want = jpt._replica_exchange(jnp.asarray(pos), jnp.asarray(ll),
                                 jnp.asarray(lp), betas, key)
    perms, log_u = _exchange_draws(key, T, W)
    pos_t, ll_t, lp_t = _to_torch(pos, ll, lp)
    accepts = tpt.replica_exchange_core(
        pos_t, ll_t, lp_t, torch.as_tensor(BETAS, dtype=torch.float32),
        perms, log_u)
    _assert_same((pos_t, ll_t, lp_t), want)
    np.testing.assert_array_equal(accepts.sum(1).numpy(),
                                  np.asarray(want[3]))
    assert 0 < int(accepts.sum()) < accepts.numel()
    # swaps permute walkers within the ladder and carry their ll, lp
    flat = np.sort(pos_t.numpy().reshape(-1, D), axis=0)
    np.testing.assert_array_equal(flat, np.sort(pos.reshape(-1, D), axis=0))


@pytest.mark.parametrize("move, step_idx", [("stretch", 0), ("de", 0),
                                            ("mixed", 0), ("mixed", 1)])
def test_one_step_matches_jax(move, step_idx):
    """make_pt_step's whole step (two half-updates, then the sweep) as the
    JAX package takes it, against the port's cores in the same order on
    the same draws."""
    pos, ll, lp = _inputs(4)
    key = jax.random.key(41)
    llb, lpb = _jax_batched()
    state = jpt.PTState(jnp.asarray(pos), jnp.asarray(ll), jnp.asarray(lp),
                        key, jnp.asarray(step_idx, jnp.int32))
    step = jpt.make_pt_step(llb, lpb, BETAS, 2.0, move=move)
    _, want = step(state, None)
    _, k_e, k_o, k_s = jax.random.split(jax.random.fold_in(key, step_idx),
                                        4)
    pos_t, ll_t, lp_t = _to_torch(pos, ll, lp)
    betas = torch.as_tensor(BETAS, dtype=torch.float32)
    gamma0 = 2.38 / (2.0 * D) ** 0.5
    use_de = move == "de" or (move == "mixed" and step_idx == 1)
    accepted = torch.zeros((T, W), dtype=torch.bool)
    for parity, k in ((0, k_e), (1, k_o)):
        if use_de:
            g, j1, j2, log_u = _de_draws(k, W // 2, gamma0, 1e-5)
            acc = tpt.tempered_de_core(pos_t, ll_t, lp_t, betas, parity, g,
                                       j1, j2, log_u, _evaluate)
        else:
            u, j, log_u = _stretch_draws(k, W // 2)
            acc = tpt.tempered_stretch_core(pos_t, ll_t, lp_t, betas,
                                            parity, u, j, log_u, _evaluate)
        accepted[:, parity::2] = acc
    perms, log_u = _exchange_draws(k_s, T, W)
    swaps = tpt.replica_exchange_core(pos_t, ll_t, lp_t, betas, perms,
                                      log_u).sum(1)
    _assert_same((pos_t, ll_t, lp_t), want)
    np.testing.assert_array_equal(accepted.numpy(),
                                  np.asarray(want[3]).astype(bool))
    np.testing.assert_array_equal(swaps.numpy(), np.asarray(want[4]))


def test_step_draws_drive_the_cores():
    """make_pt_step's own draws (torch generators) go through the same
    cores: one step of the port equals its cores fed a copy of the
    generator's stream."""
    pos, ll, lp = _inputs(5)
    llb = tpt._make_batched(_torch_loglike, False)
    lpb = tpt._make_batched(_torch_logprior, False)
    gen = torch.Generator().manual_seed(3)
    state = tpt.PTState(*_to_torch(pos, ll, lp), gen, torch.Generator(), 0)
    replay = torch.Generator().manual_seed(3)
    new, accepted, swaps = tpt.make_pt_step(llb, lpb, BETAS)(state)
    pos_t, ll_t, lp_t = _to_torch(pos, ll, lp)
    betas = torch.as_tensor(BETAS, dtype=torch.float32)
    for parity in (0, 1):
        u = torch.rand((T, W // 2), generator=replay)
        j = torch.randint(0, W // 2, (T, W // 2), generator=replay)
        log_u = torch.log(torch.rand((T, W // 2), generator=replay))
        acc = tpt.tempered_stretch_core(pos_t, ll_t, lp_t, betas, parity, u,
                                        j, log_u, _evaluate)
        assert torch.equal(acc, accepted[:, parity::2])
    perms = torch.stack([torch.randperm(W, generator=replay)
                         for _ in range(T - 1)])
    log_u = torch.log(torch.rand((T - 1, W), generator=replay))
    got = tpt.replica_exchange_core(pos_t, ll_t, lp_t, betas, perms, log_u)
    assert torch.equal(got.sum(1), swaps)
    for a, b in ((pos_t, new.positions), (ll_t, new.log_like),
                 (lp_t, new.log_prior)):
        assert torch.equal(a, b)
    assert new.step == 1


# --- (c) in distribution ----------------------------------------------------

def _gaussian(theta):
    return -0.5 * torch.sum(theta ** 2, dim=-1)


def _flat(theta):
    return torch.zeros(theta.shape[0])


def _sample(p0, n_steps, loglike, logprior, seed, **kw):
    return tpt.sample_pt(torch.as_tensor(p0, dtype=torch.float32), n_steps,
                         loglike, logprior,
                         generator=torch.Generator().manual_seed(seed),
                         eval_generator=torch.Generator().manual_seed(seed),
                         **kw)


def _p0(seed, shape, scale=0.1, loc=0.0):
    return loc + scale * np.random.default_rng(seed).standard_normal(shape)


def test_cold_chain_recovers_gaussian():
    chain = _sample(_p0(0, (4, 32, 2)), 500, _gaussian, _flat, 1)
    cold = chain.cold_chain[200:].reshape(-1, 2).numpy()
    assert abs(cold.mean()) < 0.12
    np.testing.assert_allclose(cold.std(axis=0), 1.0, atol=0.12)


def test_hot_chains_are_wider():
    chain = _sample(_p0(2, (4, 32, 2)), 500, _gaussian, _flat, 3)
    pos = chain.positions[300:].numpy()       # (S, T, W, D)
    # beta_hot = 2^-1.5 ~ 0.35 -> std ~ 1/sqrt(beta) ~ 1.68x wider
    assert pos[:, -1].std() > 1.2 * pos[:, 0].std()


def test_swaps_happen():
    chain = _sample(_p0(4, (3, 16, 2)), 100, _gaussian, _flat, 5)
    swaps = chain.n_swaps_accepted.numpy()
    assert swaps.shape == (2,)
    assert (swaps > 0).all(), "replica exchange never accepted a swap"


@pytest.mark.parametrize("move", ["stretch", "de", "mixed"])
def test_multimodal_mixing_beats_plain_ensemble(move):
    """A well-separated bimodal target, every walker started in one mode:
    the cold chain populates both."""
    def loglike(theta):
        x = theta[:, 0]
        return torch.logaddexp(-0.5 * ((x - 6.0) / 0.5) ** 2,
                               -0.5 * ((x + 6.0) / 0.5) ** 2)

    def logprior(theta):
        return torch.where(theta[:, 0].abs() < 20.0, 0.0, -torch.inf)

    chain = _sample(_p0(6, (8, 32, 1), 0.3, 6.0), 800, loglike, logprior, 7,
                    betas=tpt.default_beta_ladder(8, t_max=300.0), move=move)
    cold = chain.cold_chain[400:].reshape(-1).numpy()
    frac_left = (cold < 0).mean()
    assert 0.1 < frac_left < 0.9, (
        f"cold chain stuck in one mode (left fraction {frac_left})")


def test_thinning():
    chain = _sample(_p0(8, (2, 8, 2)), 100, _gaussian, _flat, 9, thin=10)
    assert chain.positions.shape[0] == 10
    acc = chain.acceptance_fraction.numpy()
    assert np.all(acc <= 1.0) and acc.mean() > 0.1
    # rows 0, thin, 2 thin, ...: ceil(n / thin) rows
    chain = _sample(_p0(8, (2, 8, 2)), 10, _gaussian, _flat, 9, thin=3)
    assert chain.positions.shape == (4, 2, 8, 2)
    assert chain.n_steps == 10


def test_p0_forms_and_refusals():
    chain = _sample(_p0(1, (8, 2)), 3, _gaussian, _flat, 1, n_temps=3)
    assert chain.positions.shape == (3, 3, 8, 2)
    assert chain.betas == tuple(tpt.default_beta_ladder(3))
    with pytest.raises(ValueError, match="n_temps"):
        _sample(_p0(1, (8, 2)), 3, _gaussian, _flat, 1)
    with pytest.raises(ValueError, match="W even"):
        _sample(_p0(1, (2, 7, 2)), 3, _gaussian, _flat, 1)
    with pytest.raises(ValueError, match="unknown move"):
        _sample(_p0(1, (2, 8, 2)), 3, _gaussian, _flat, 1, move="walk")
    with pytest.raises(ValueError, match=">= 4 walkers"):
        _sample(_p0(1, (2, 2, 2)), 3, _gaussian, _flat, 1, move="de")
    for bad, match in (([1.0, 0.5], ">= 3 temperatures"),
                       ([0.9, 0.5, 0.1], "betas\\[0\\] == 1.0"),
                       ([1.0, 0.5, 0.6], "strictly decreasing")):
        with pytest.raises(ValueError, match=match):
            tpt.sample_pt_adaptive(
                torch.zeros((len(bad), 8, 2)), 3, _gaussian, _flat,
                betas=np.asarray(bad), generator=torch.Generator(),
                eval_generator=torch.Generator())


def test_stochastic_likelihood_gets_the_host_generator():
    """With ``stochastic``, the log-likelihood takes the eval generator,
    once per half-update for every rung's walkers at once."""
    calls = []

    def loglike(theta, generator):
        calls.append(theta.shape)
        noise = torch.randn(theta.shape[0], generator=generator)
        return _gaussian(theta) + 1e-3 * noise

    def logprior(theta, generator):
        return _flat(theta)

    chain = _sample(_p0(3, (3, 8, 2)), 4, loglike, logprior, 2,
                    stochastic=True)
    assert calls == [(24, 2)] + [(12, 2)] * 8
    assert torch.all(torch.isfinite(chain.log_like))


def test_adaptive_ladder_equalizes_swap_acceptance():
    """sample_pt_adaptive (Vousden-style): from a lopsided ladder, the
    interior pair swap acceptances end up closer to uniform than a fixed
    ladder's, the ladder stays valid with its endpoints pinned, and the
    cold posterior recovers the truth."""
    rng = np.random.default_rng(3)
    x = rng.uniform(tsg.X_MIN, tsg.X_MAX, 800)
    data = (-0.2 * x + 6.0 + rng.standard_normal(800)).astype(np.float32)
    loglike, logprior = tsg.make_pt_fns(data, numeric=True)
    betas0 = np.asarray([1.0, 0.05, 0.045, 0.04, 0.035], np.float32)
    p0 = _p0(4, (5, 16, 3), 0.01, np.array([1.2, -0.25, 5.5]))
    fixed = _sample(p0, 250, loglike, logprior, 5, betas=betas0)
    adapt, betas_f, b_hist = tpt.sample_pt_adaptive(
        torch.as_tensor(p0, dtype=torch.float32), 250, loglike, logprior,
        betas=betas0, adapt_t0=50.0, adapt_nu=2.0,
        generator=torch.Generator().manual_seed(5),
        eval_generator=torch.Generator().manual_seed(5))

    def spread(chain):
        acc = chain.n_swaps_accepted.numpy().astype(float) / (250 * 16)
        inner = acc[:-1]
        return inner.max() - inner.min()

    assert spread(adapt) < spread(fixed)
    b = betas_f.numpy()
    assert b[0] == 1.0 and np.all(np.diff(b) < 0)
    np.testing.assert_allclose(b[-1], betas0[-1], rtol=1e-3)
    assert b_hist.shape == (250, 5)
    np.testing.assert_array_equal(b_hist[-1].numpy(), b)
    assert adapt.betas == tuple(float(v) for v in b.astype(np.float64))
    cold = adapt.cold_chain[120:].reshape(-1, 3).numpy()
    q50 = np.percentile(cold, 50, axis=0)
    assert abs(q50[0] - 1.0) < 0.25
    assert abs((5 * q50[1] + q50[2]) - 5.0) < 0.4


S_PRIOR, SIG = 3.0, 1.0
LNZ_TRUE = 2 * (-0.5 * np.log(2 * np.pi * (SIG ** 2 + S_PRIOR ** 2)))


def _gauss_loglike(sig):
    def loglike(th):
        return torch.sum(-0.5 * (th / sig) ** 2
                         - 0.5 * np.log(2 * np.pi * sig ** 2), dim=-1)
    return loglike


def _gauss_logprior(th):
    return torch.sum(-0.5 * (th / S_PRIOR) ** 2
                     - 0.5 * np.log(2 * np.pi * S_PRIOR ** 2), dim=-1)


@pytest.fixture(scope="module")
def pt_chain():
    betas = tpt.default_beta_ladder(16)
    p0 = _p0(1, (16, 64, 2), S_PRIOR)
    return _sample(p0, 800, _gauss_loglike(SIG), _gauss_logprior, 0,
                   betas=betas), betas


def test_ti_log_evidence_matches_analytic(pt_chain):
    chain, betas = pt_chain
    ln_z, d_ln_z = tpt.thermodynamic_integration_log_evidence(
        chain.log_like, betas, fburnin=0.3)
    assert abs(ln_z - LNZ_TRUE) < 0.15
    assert abs(ln_z - LNZ_TRUE) < 4.0 * d_ln_z + 0.05
    assert 0.0 < d_ln_z < 0.5
    # the chain's own ladder (float64) is the default
    assert chain.thermodynamic_integration_log_evidence(fburnin=0.3) == (
        ln_z, d_ln_z)
    np.testing.assert_array_equal(np.asarray(chain.betas), betas)


def test_ti_evidence_ranks_models(pt_chain):
    """A mis-scaled likelihood (sigma 3x too wide) loses in evidence."""
    chain, betas = pt_chain
    chain_bad = _sample(_p0(3, (16, 64, 2), S_PRIOR), 800,
                        _gauss_loglike(3 * SIG), _gauss_logprior, 2,
                        betas=betas)
    ln_z, _ = chain.thermodynamic_integration_log_evidence(fburnin=0.3)
    ln_z_bad, _ = chain_bad.thermodynamic_integration_log_evidence(
        fburnin=0.3)
    lnz_bad_true = 2 * (-0.5 * np.log(2 * np.pi * ((3 * SIG) ** 2
                                                   + S_PRIOR ** 2)))
    assert ln_z > ln_z_bad
    assert abs(ln_z_bad - lnz_bad_true) < 0.15
