"""The port's spans (``utils/profiling.py``): off by default and then one
shared do-nothing context; on inside ``spans()``, where they record their
host intervals, enclosing spans and own times, and open a profiler label
under ``torch.profiler``; and a sampler run that is the same, bit for
bit, with them on."""
import time

import pytest
import torch

from mcmctoffitting_tpu_torch import sampler
from mcmctoffitting_tpu_torch.utils import profiling


def test_off_records_nothing_and_is_one_shared_object():
    a, b = profiling.span("mcmctof.a"), profiling.span("mcmctof.b")
    assert a is b
    with a as inside:
        assert inside is None
    with profiling.spans() as rec:
        pass
    with profiling.span("mcmctof.a"):
        torch.ones(2)
    assert rec.records == [] and rec.summary() == {}


def test_nesting_gives_parents_and_self_time_is_total_less_children():
    with profiling.spans() as rec:
        with profiling.span("mcmctof.outer"):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.span("mcmctof.inner"):
                    time.sleep(0.003)
                    with profiling.span("mcmctof.leaf"):
                        time.sleep(0.001)
        with profiling.span("mcmctof.inner"):
            pass
    assert [r.name for r in rec.records] == [
        "mcmctof.leaf", "mcmctof.inner", "mcmctof.leaf", "mcmctof.inner",
        "mcmctof.outer", "mcmctof.inner"]
    parents = [r.parent for r in rec.records]
    assert parents == ["mcmctof.inner", "mcmctof.outer", "mcmctof.inner",
                       "mcmctof.outer", None, None]
    by_name = {}
    for r in rec.records:
        by_name.setdefault(r.name, []).append(r)
    outer = by_name["mcmctof.outer"][0]
    inner = by_name["mcmctof.inner"][:2]
    assert outer.self_ns == (outer.end_ns - outer.start_ns) - sum(
        r.end_ns - r.start_ns for r in inner)
    for r, leaf in zip(inner, by_name["mcmctof.leaf"]):
        assert r.start_ns <= leaf.start_ns <= leaf.end_ns <= r.end_ns
        assert r.self_ns == (r.end_ns - r.start_ns) - (leaf.end_ns
                                                       - leaf.start_ns)
        assert leaf.self_ns == leaf.end_ns - leaf.start_ns
    s = rec.summary()
    assert s["mcmctof.inner"]["calls"] == 3
    assert s["mcmctof.outer"]["parent"] is None
    assert s["mcmctof.leaf"]["parent"] == "mcmctof.inner"
    total = s["mcmctof.outer"]["total_ms"]
    assert s["mcmctof.outer"]["self_ms"] == pytest.approx(
        total - 1e-6 * sum(r.end_ns - r.start_ns for r in inner))
    assert total >= 10.0          # 2 + 2 x (3 + 1) ms of sleep


def test_an_inner_spans_block_records_apart():
    with profiling.spans() as outer:
        with profiling.span("mcmctof.a"):
            with profiling.spans() as inner:
                with profiling.span("mcmctof.b"):
                    pass
        with profiling.span("mcmctof.c"):
            pass
    assert [r.name for r in inner.records] == ["mcmctof.b"]
    assert [r.name for r in outer.records] == ["mcmctof.a", "mcmctof.c"]


def test_under_the_profiler_a_span_is_a_labelled_host_event():
    from torch.profiler import ProfilerActivity, profile
    with profiling.spans():
        with profiling.span("mcmctof.alone"):
            pass
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("mcmctof.outer"):
                with profiling.span("mcmctof.inner"):
                    torch.ones(8, 8) @ torch.ones(8, 8)
    events = {e.name: e for e in prof.events()}
    assert "mcmctof.alone" not in events
    outer, inner = events["mcmctof.outer"], events["mcmctof.inner"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end


def _logp(thetas, generator):
    noise = torch.rand(thetas.shape[0], generator=generator)
    return -0.5 * torch.sum(thetas ** 2, dim=-1) + 1e-3 * noise


@pytest.mark.parametrize("move", ["de", "stretch"])
def test_a_chain_is_the_same_with_the_spans_on(move):
    def run():
        p0 = torch.randn(8, 3, generator=torch.Generator().manual_seed(0))
        state = sampler.init_state(
            p0, _logp, generator=torch.Generator().manual_seed(1),
            eval_generator=torch.Generator().manual_seed(2))
        return sampler.run_mcmc(state, 4, _logp, move=move)

    off = run()
    with profiling.spans() as rec:
        on = run()
    assert torch.equal(on.positions, off.positions)
    assert torch.equal(on.log_probs, off.log_probs)
    s = rec.summary()
    assert s["mcmctof.step"]["calls"] == 4
    assert s["mcmctof.half_update"]["calls"] == 8
    assert s["mcmctof.half_update"]["parent"] == "mcmctof.step"
