"""The counts log-prob as one CUDA graph replay (``models/logp_graph.py``).

On the CPU: which evaluations take the graph (counts on a CUDA tensor
that needs no gradient; not the CPU, mc, 'expected' or autograd), the
cache key (``walker_offset`` and ``walker_blocks`` make keys of their
own), the bound on the cache, the order of eager call, capture and
replays, and the seed words a replay relies on: the eager log-prob with
its K1 seeds read from a ``DeviceSeeds`` refilled from the host
generator gives the host generator's bits and leaves the generator where
the host path does.  Marked ``cuda`` and skipped without a GPU: at the
benchmark cells' shapes (128 walkers x 200k draws), 8 evaluations
through the graph and 8 eager ones from equal generator states give the
same bits and leave the generator in the same state; a result held
across the next two calls is unchanged; the counters; mc and a gradient
call take no graph.  On a machine with one (this file imports no jax):

    python -m pytest --noconftest -m cuda tests/test_torch_logp_graph.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.models import logp_graph, onebd, simult
from mcmctoffitting_tpu_torch.models.logp_graph import (GraphCache,
                                                        graph_key, graphable,
                                                        log_prob_graph)
from mcmctoffitting_tpu_torch.ops.cuda_contract import a_contract
from mcmctoffitting_tpu_torch.ops.cuda_poisson import poisson
from mcmctoffitting_tpu_torch.ops.cuda_rates import counts_rates
from mcmctoffitting_tpu_torch.ops.cuda_tof import tof_hist_segments
from mcmctoffitting_tpu_torch.ops.poisson import DeviceSeeds, launch_seed
from mcmctoffitting_tpu_torch.utils import data_io


def _problem(model, n_samples, device, sampling="counts", fine_grid=None):
    if model == "simult":
        spec = simult.default_spec(n_samples, sampling=sampling,
                                   fine_grid=fine_grid)
        problem = simult.SimultFitProblem(spec, n_runs=4,
                                          likelihood="poisson", device=device)
        truth = np.concatenate([simult.GUESS_SHARED, np.full(4, 5e4)])
    else:
        spec = onebd.default_spec(n_samples, hardcore=fine_grid is None,
                                  sampling=sampling, fine_grid=fine_grid)
        problem = onebd.OneBDProblem(spec, n_runs=3, likelihood="poisson",
                                     device=device)
        truth = data_io.ONEBD_TRUTH
    observed = data_io.synthesize_observed(9, problem, truth)
    return problem, observed


def _walkers(problem, observed, n, seed):
    return problem.initial_walkers_from_observed(
        torch.Generator(problem.device).manual_seed(seed), n, observed)


def _counters():
    return (logp_graph.log_prob_graph.captures,
            logp_graph.log_prob_graph.replays)


# --- on the CPU -------------------------------------------------------------

def _cuda_like(requires_grad=False):
    """What ``graphable`` reads of a CUDA tensor, on a machine without one."""
    return SimpleNamespace(is_cuda=True, requires_grad=requires_grad)


@pytest.mark.parametrize("sampling,thetas,want", [
    ("counts", "cuda", True),
    ("counts", "cpu", False),
    ("counts", "cuda_grad", False),
    ("mc", "cuda", False),
    ("expected", "cuda", False),
    ("expected", "cuda_grad", False),
])
def test_graphable_only_counts_on_the_card_without_a_gradient(sampling,
                                                              thetas, want):
    spec = SimpleNamespace(sampling=sampling)
    x = {"cuda": _cuda_like(), "cuda_grad": _cuda_like(True),
         "cpu": torch.zeros(2, 8)}[thetas]
    assert graphable(spec, x) is want


def test_graphable_reads_the_tensor_not_a_switch():
    """A CPU tensor, with or without a gradient, never takes the graph."""
    spec = SimpleNamespace(sampling="counts")
    assert not graphable(spec, torch.zeros(2, 8, requires_grad=True))
    assert not graphable(spec, torch.zeros(2, 8, dtype=torch.float64))


def test_cache_key_separates_shape_dtype_rows_and_observed():
    obs = SimpleNamespace(counts=torch.zeros(3), mask=torch.ones(3))
    other = SimpleNamespace(counts=torch.zeros(3), mask=torch.ones(3))
    x = torch.zeros(128, 8)
    base = graph_key(x, 0, None, obs)
    assert graph_key(torch.ones(128, 8), 0, None, obs) == base
    variants = [graph_key(x, 128, None, obs),
                graph_key(x, 0, (64, 128), obs),
                graph_key(x, 128, (64, 128), obs),
                graph_key(x, 128, (32, 128), obs),
                graph_key(torch.zeros(64, 8), 0, None, obs),
                graph_key(x.double(), 0, None, obs),
                graph_key(x, 0, None, other)]
    assert len({base, *variants}) == len(variants) + 1
    # blocks given as a list key as the same tuple
    assert graph_key(x, 0, [64, 128], obs) == graph_key(x, 0, (64, 128), obs)


def test_cache_keeps_the_most_recently_used_keys():
    cache = GraphCache()
    keys = [f"k{i}" for i in range(logp_graph.MAX_GRAPHS + 2)]
    for k in keys:
        cache.put(k, None)
    assert list(cache.entries) == keys[2:]
    cache.put(keys[2], "graph")          # used again: now the newest
    cache.put("new", None)
    assert list(cache.entries) == keys[4:] + [keys[2], "new"]
    assert len(cache.entries) == logp_graph.MAX_GRAPHS


class _FakeCaptured:
    """Stands in for a captured graph: replays call the eager function."""

    def __init__(self, eager, observed, rows):
        self.eager, self.observed, self.rows = eager, observed, rows

    def replay(self, thetas, generator):
        logp_graph.log_prob_graph.replays += 1
        return self.eager(thetas, generator, self.observed, **self.rows)


def test_first_call_eager_second_captures_then_replays(monkeypatch):
    """The order of ``log_prob_graph`` for each key: eager, then one
    capture and a replay, then replays; a key dropped from the cache starts
    again from an eager call."""
    eager_calls, captured = [], []

    class Problem:
        logp_graphs = GraphCache()

        def log_prob_eager(self, thetas, generator, observed, **rows):
            eager_calls.append((tuple(thetas.shape), rows["walker_offset"]))
            return thetas.sum(-1)

    def fake_capture(eager, thetas, observed, rows):
        captured.append((tuple(thetas.shape), rows["walker_offset"]))
        logp_graph.log_prob_graph.captures += 1
        return _FakeCaptured(eager, observed, rows)

    monkeypatch.setattr(logp_graph, "capture", fake_capture)
    monkeypatch.setattr(logp_graph.log_prob_graph, "captures", 0)
    monkeypatch.setattr(logp_graph.log_prob_graph, "replays", 0)
    problem, gen = Problem(), torch.Generator()
    obs = SimpleNamespace(counts=torch.zeros(3), mask=torch.ones(3))
    x = torch.ones(4, 2)
    for _ in range(8):
        out = log_prob_graph(problem, x, gen, obs)
        assert torch.equal(out, torch.full((4,), 2.0))
    assert _counters() == (1, 7) and len(eager_calls) == 8
    assert captured == [((4, 2), 0)]
    # another offset is another key: eager first
    log_prob_graph(problem, x, gen, obs, walker_offset=4)
    assert _counters() == (1, 7)
    for off in range(1, logp_graph.MAX_GRAPHS + 1):   # evicts offset 0
        log_prob_graph(problem, torch.ones(4, 2), gen, obs,
                       walker_offset=100 + off)
    log_prob_graph(problem, x, gen, obs)
    assert _counters() == (1, 7)          # offset 0 was dropped: eager again
    log_prob_graph(problem, x, gen, obs)
    assert _counters() == (2, 8)


def test_device_seeds_hand_out_rows_in_order_and_run_out():
    seeds = DeviceSeeds("cpu")
    gen, ref = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    seeds.refill(gen, DeviceSeeds.SLOTS)
    for _ in range(DeviceSeeds.SLOTS):
        assert tuple(launch_seed(seeds).tolist()) == launch_seed(ref)
    assert torch.equal(gen.get_state(), ref.get_state())
    with pytest.raises(RuntimeError, match="slots"):
        launch_seed(seeds)


@pytest.mark.parametrize("model,n_seeds", [("simult", 1), ("onebd", 2)])
def test_eager_log_prob_on_device_seeds_is_the_host_generators(model,
                                                               n_seeds):
    """What a replay does, on the CPU without a graph: the seed words drawn
    from the host generator into a ``DeviceSeeds`` (the cells', and on
    oneBD the background's, in that order) give the log-prob the generator
    gives, and leave the generator where it leaves it; ``log_prob`` on the
    CPU takes no graph."""
    torch.set_num_threads(1)
    problem, observed = _problem(model, 8000, "cpu", fine_grid=128)
    obs = problem.observed_runs(observed)
    thetas = _walkers(problem, observed, 8, seed=1)
    before = _counters()
    host, copy = torch.Generator().manual_seed(5), torch.Generator()
    copy.set_state(host.get_state())
    for _ in range(2):
        want = problem.log_prob(thetas, host, obs)
        seeds = DeviceSeeds("cpu")
        seeds.refill(copy, n_seeds)
        got = problem.log_prob_eager(thetas, seeds, obs)
        assert seeds.taken == n_seeds
        assert torch.equal(got, want)
        assert torch.equal(copy.get_state(), host.get_state())
        thetas = thetas.flip(0).contiguous()
    assert torch.isfinite(want).all()
    assert _counters() == before
    assert "logp_graphs" not in problem.__dict__


# --- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _bits(t):
    return t.detach().cpu().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_graph_equals_eager_bit_for_bit_at_the_cells_shape(dev, model):
    """The benchmark cells' configurations at their half-ensemble (128
    walkers x 200k draws): 8 evaluations of ``log_prob`` (one eager, one
    capture and replay, six replays) and 8 of ``log_prob_eager`` from equal
    host generator states: the same bits, and the generators in the same
    state after both; one capture and seven replays; each result unchanged
    by the two calls after it; the kernels' launch counters moved by three
    evaluations' launches (the eager first call, the warm-up, the capture),
    since a replay calls no wrapper."""
    problem, observed = _problem(model, 200_000, dev)
    obs = problem.observed_runs(observed)
    walkers = _walkers(problem, observed, 8 * 128, seed=1)
    host, copy = torch.Generator().manual_seed(11), torch.Generator()
    copy.set_state(host.get_state())
    counters0 = _counters()
    kernels = (poisson, tof_hist_segments, counts_rates, a_contract)
    launches0 = [fn.launches for fn in kernels]
    got = []
    for i in range(8):
        got.append(problem.log_prob(walkers[i::8], host, obs))
    graph_counts = [fn.launches - n for fn, n in zip(kernels, launches0)]
    held = [g.clone() for g in got]
    assert tuple(b - a for a, b in zip(counters0, _counters())) == (1, 7)
    want = [problem.log_prob_eager(walkers[i::8], copy, obs)
            for i in range(8)]
    torch.cuda.synchronize()
    assert torch.equal(host.get_state(), copy.get_state())
    per_eval = (2 if model == "onebd" else 1, 1, 1, 1)
    assert graph_counts == [3 * n for n in per_eval]
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(_bits(g), _bits(w)), f"evaluation {i}"
        assert torch.equal(_bits(g), _bits(held[i]))
    assert torch.isfinite(torch.cat(want)).float().mean().item() > 0.9


@pytest.mark.cuda
def test_a_result_held_is_not_overwritten_by_later_replays(dev):
    problem, observed = _problem("simult", 200_000, dev)
    obs = problem.observed_runs(observed)
    walkers = _walkers(problem, observed, 4 * 128, seed=2)
    gen = torch.Generator().manual_seed(3)
    problem.log_prob(walkers[0::4], gen, obs)                 # eager
    held = problem.log_prob(walkers[1::4], gen, obs)          # replay
    copy = held.clone()
    for i in (2, 3):
        later = problem.log_prob(walkers[i::4], gen, obs)
        torch.cuda.synchronize()
        assert not torch.equal(later, held)
        assert torch.equal(_bits(held), _bits(copy))


@pytest.mark.cuda
def test_shards_and_shapes_take_graphs_of_their_own(dev):
    """Two shards (``walker_offset`` 0 and 64) and the whole batch,
    interleaved: the sharded draws the rows of the whole batch's, bit for
    bit, and the host generator in step with the eager path."""
    problem, observed = _problem("onebd", 200_000, dev)
    obs = problem.observed_runs(observed)
    walkers = _walkers(problem, observed, 128, seed=4)
    host, copy = torch.Generator().manual_seed(8), torch.Generator()
    copy.set_state(host.get_state())
    for _ in range(3):
        for rows, offset in ((walkers, 0), (walkers[:64], 0),
                             (walkers[64:], 64)):
            got = problem.log_prob(rows, host, obs, walker_offset=offset)
            want = problem.log_prob_eager(rows, copy, obs,
                                          walker_offset=offset)
            assert torch.equal(_bits(got), _bits(want))
        assert torch.equal(host.get_state(), copy.get_state())
    assert len(problem.logp_graphs.entries) == 3


@pytest.mark.cuda
def test_mc_and_gradient_calls_take_no_graph(dev):
    before = _counters()
    problem, observed = _problem("simult", 20_000, dev, sampling="mc")
    obs = problem.observed_runs(observed)
    thetas = _walkers(problem, observed, 16, seed=5)
    gen = torch.Generator().manual_seed(6)
    for _ in range(3):
        assert torch.isfinite(problem.log_prob(thetas, gen, obs)).any()
    problem, observed = _problem("simult", 20_000, dev, sampling="expected")
    obs = problem.observed_runs(observed)
    thetas = _walkers(problem, observed, 16, seed=5).requires_grad_(True)
    for _ in range(3):
        lp = problem.log_prob(thetas, gen, obs)
        lp.sum().backward()
    assert torch.isfinite(thetas.grad).all()
    assert _counters() == before
