"""Walker sharding of the port (mcmctoffitting_tpu_torch.parallel) over
gloo ranks on the CPU: the counterparts of tests/test_sharding.py, at
small sizes (<= 4 ranks, 16-32 walkers, 8k draws, F = 128).

Each fixture starts its ranks once (``parallel.launch.launch``, a 120 s
deadline: a hang fails the fixture's tests, it does not stall the run)
and the tests read what the ranks returned against the same run in this
process, unsharded:

* a Gaussian log-prob, sharded, equals the local one; the stretch and DE
  chains on it are bit for bit the unsharded ones;
* contract A (``parallel/mesh.py``): small simultFit counts and
  'expected' fits, sharded over 2 and 4 ranks, with chunks inside a
  shard, are bit for bit the unsharded fit; PT on the counts posterior
  through ``make_sharded_pt_batch`` is bit for bit the unsharded
  ``sample_pt``;
* contract B: an mc fit is bit for bit one process that evaluates the
  same shards in turn with the same shard seeds;
* contract C: every rank holds the same positions at the end;
* the "not divisible" ValueError of both evaluators.
"""
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.models import simult
from mcmctoffitting_tpu_torch.ops.likelihoods import box_lnprior
from mcmctoffitting_tpu_torch.parallel import (WalkerMesh, launch, make_mesh,
                                               make_sharded_logp_batch,
                                               make_sharded_pt_batch)
from mcmctoffitting_tpu_torch.parallel.mesh import all_gather_rows, shard_seeds
from mcmctoffitting_tpu_torch.sampler import (init_state, run_mcmc,
                                              sample_pt)
from mcmctoffitting_tpu_torch.utils import data_io

torch.set_num_threads(1)

DEADLINE_S = 120.0
N_RUNS, N_DRAWS, N_FINE = 2, 8000, 128
TRUTH = np.concatenate([simult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])
FIT_WALKERS, FIT_STEPS = 16, 5
PT_TEMPS, PT_WALKERS, PT_STEPS = 4, 16, 3


def gaussian_logp(thetas):
    return -0.5 * torch.sum(thetas ** 2, dim=-1)


def _gauss_thetas(n=32, d=4, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32))


def _gauss_chain(logp, move):
    p0 = 0.1 * _gauss_thetas(32, 3, seed=2)
    state = init_state(p0, logp, generator=torch.Generator().manual_seed(3),
                       eval_generator=torch.Generator().manual_seed(4))
    return run_mcmc(state, 30, logp, move=move)


def _problem(sampling):
    spec = simult.default_spec(N_DRAWS, fine_grid=N_FINE, sampling=sampling)
    problem = simult.SimultFitProblem(spec, n_runs=N_RUNS,
                                      likelihood="poisson", device="cpu")
    return problem, data_io.synthesize_observed(11, problem, TRUTH)


def _fit(logp_batch, problem, observed):
    """FIT_STEPS DE steps from the problem's initial walkers: (positions
    (S, W, D), log-probs (S, W), the final state)."""
    p0 = problem.initial_walkers_from_observed(
        torch.Generator().manual_seed(12), FIT_WALKERS, observed)
    state = init_state(p0, logp_batch,
                       generator=torch.Generator().manual_seed(13),
                       eval_generator=torch.Generator().manual_seed(14))
    chain = run_mcmc(state, FIT_STEPS, logp_batch, move="de")
    return chain.positions, chain.log_probs, chain.state


def _pt(loglike_batch, problem, observed):
    """PT_STEPS tempered DE steps on the counts posterior: positions,
    log-likelihoods, log-priors of the (S, T, W) chain."""
    lo, hi = (torch.as_tensor(v, dtype=torch.float32)
              for v in (problem.param_lo, problem.param_hi))
    p0 = problem.initial_walkers_from_observed(
        torch.Generator().manual_seed(15), PT_TEMPS * PT_WALKERS,
        observed).reshape(PT_TEMPS, PT_WALKERS, -1)
    chain = sample_pt(
        p0, PT_STEPS, None, lambda th: box_lnprior(th, lo, hi,
                                                   inclusive=True),
        generator=torch.Generator().manual_seed(16),
        eval_generator=torch.Generator().manual_seed(17), move="de",
        loglike_batch=loglike_batch)
    return chain.positions, chain.log_like, chain.log_prior


def _pt_loglike(problem, observed):
    obs = problem.observed_runs(observed)

    def loglike(thetas, generator, **rows):
        return problem.log_like(thetas, generator, obs, **rows)

    return loglike


def _same_on_every_rank(x, mesh):
    """Contract C: gather every rank's tensor and compare."""
    parts = all_gather_rows(x[None].contiguous(), mesh)
    return all(torch.equal(parts[0], p) for p in parts[1:])


def _gauss_rank():
    mesh = make_mesh("cpu")
    logp = make_sharded_logp_batch(gaussian_logp, mesh, stochastic=False)
    out = {"logp": logp(_gauss_thetas(), None)}
    sharded = make_sharded_logp_batch(lambda th, g: gaussian_logp(th), mesh)
    for move in ("stretch", "de"):
        chain = _gauss_chain(sharded, move)
        out[move] = (chain.positions, chain.log_probs)
        out[f"{move}_same_on_ranks"] = _same_on_every_rank(
            chain.state.positions, mesh)
    return out


def _physics_rank():
    mesh = make_mesh("cpu")
    out = {}
    for sampling, chunk in (("counts", None), ("counts", 2),
                            ("expected", None), ("mc", None)):
        problem, observed = _problem(sampling)
        logp = make_sharded_logp_batch(problem.make_log_prob_fn(observed),
                                       mesh, chunk=chunk,
                                       by_row=problem.draws_by_row)
        pos, lp, state = _fit(logp, problem, observed)
        out[(sampling, chunk)] = (pos, lp)
        out[(sampling, chunk, "same_on_ranks")] = _same_on_every_rank(
            state.positions, mesh)
    problem, observed = _problem("counts")
    out["pt"] = _pt(make_sharded_pt_batch(
        _pt_loglike(problem, observed), mesh, n_temps=PT_TEMPS,
        by_row=True), problem, observed)
    return out


@pytest.fixture(scope="module")
def gauss_ranks():
    return launch.launch(_gauss_rank, 2, backend="gloo",
                         timeout_s=DEADLINE_S)


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def physics_ranks(request):
    return launch.launch(_physics_rank, request.param, backend="gloo",
                         timeout_s=DEADLINE_S)


def test_sharded_logp_matches_local(gauss_ranks):
    want = gaussian_logp(_gauss_thetas())
    for rank in gauss_ranks:
        np.testing.assert_array_equal(rank["logp"], want)


@pytest.mark.parametrize("move", ["stretch", "de"])
def test_sharded_chain_matches_unsharded(gauss_ranks, move):
    """The moves are replicated and only the log-prob is sharded: the
    chain is the unsharded one, bit for bit, on every rank."""
    chain = _gauss_chain(lambda th, g: gaussian_logp(th), move)
    for rank in gauss_ranks:
        pos, lp = rank[move]
        np.testing.assert_array_equal(pos, chain.positions)
        np.testing.assert_array_equal(lp, chain.log_probs)
        assert rank[f"{move}_same_on_ranks"]


@pytest.mark.parametrize("sampling,chunk", [("counts", None), ("counts", 2),
                                            ("expected", None)])
def test_sharded_fit_matches_unsharded_bitwise(physics_ranks, sampling,
                                               chunk):
    """Contract A on the CPU: every rank's chain equals the unsharded fit
    bit for bit (the counts drawn by row through K1's counter offset;
    chunks inside a shard change nothing)."""
    problem, observed = _problem(sampling)
    pos, lp, _ = _fit(problem.make_log_prob_fn(observed), problem, observed)
    assert torch.isfinite(lp).all() and pos.shape == (FIT_STEPS,
                                                      FIT_WALKERS, 6)
    for rank in physics_ranks:
        got_pos, got_lp = rank[(sampling, chunk)]
        np.testing.assert_array_equal(got_pos, pos)
        np.testing.assert_array_equal(got_lp, lp)
        assert rank[(sampling, chunk, "same_on_ranks")]


def test_sharded_mc_fit_has_per_shard_streams(physics_ranks):
    """Contract B: the mc fit draws each shard from a generator seeded by
    its shard seed; it equals, bit for bit, one process evaluating the
    same shards in turn with the same seeds, and differs from the
    unsharded fit (which draws other numbers)."""
    n_ranks = len(physics_ranks)
    problem, observed = _problem("mc")
    logp = problem.make_log_prob_fn(observed)

    def in_turn(thetas, generator):
        seeds = shard_seeds(generator, n_ranks)
        m = thetas.shape[0] // n_ranks
        return torch.cat([
            logp(thetas[r * m:(r + 1) * m],
                 torch.Generator().manual_seed(seeds[r]))
            for r in range(n_ranks)])

    pos, lp, _ = _fit(in_turn, problem, observed)
    for rank in physics_ranks:
        got_pos, got_lp = rank[("mc", None)]
        np.testing.assert_array_equal(got_pos, pos)
        np.testing.assert_array_equal(got_lp, lp)
        assert rank[("mc", None, "same_on_ranks")]
    _, lp_unsharded, _ = _fit(logp, problem, observed)
    assert not torch.equal(lp_unsharded, lp)
    assert torch.isfinite(lp).all()


def test_sharded_pt_matches_unsharded_sample_pt(physics_ranks):
    """make_sharded_pt_batch in sample_pt's loglike_batch hook: every
    rung's walkers sharded, K1 drawing each shard's rows of every rung
    (walker_blocks); the tempered chain equals the unsharded sample_pt's
    bit for bit."""
    problem, observed = _problem("counts")
    want = _pt(_pt_loglike(problem, observed), problem, observed)
    assert torch.isfinite(want[1]).all()
    for rank in physics_ranks:
        for got, ref in zip(rank["pt"], want):
            np.testing.assert_array_equal(got, ref)


def test_indivisible_walker_count_raises():
    mesh = WalkerMesh(None, 8, 0, torch.device("cpu"))
    logp = make_sharded_logp_batch(gaussian_logp, mesh, stochastic=False)
    with pytest.raises(ValueError, match="not divisible"):
        logp(_gauss_thetas(30), None)                    # 30 % 8 != 0
    pt = make_sharded_pt_batch(lambda th: gaussian_logp(th), mesh,
                               n_temps=3, stochastic=False)
    with pytest.raises(ValueError, match="not divisible"):
        pt(_gauss_thetas(3 * 12), None)                  # 12 % 8 != 0
