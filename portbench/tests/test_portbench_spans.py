"""The readings of the program's spans (``program_spans.py``): the
attribution of sub-window C's device operations and idle gaps on a
synthetic event list, the span readers on synthetic readings and with
nothing to read, and a traced run on the CPU that reports the three
host-clock metrics."""
import time

import pytest
import torch

from portbench import harness, plan as plans, program_spans
from portbench.plan import ROOT
from portbench.program_spans import NO_SPAN, SUBWINDOW

READERS = ("logp_enqueue_ms_per_eval", "sampler_enqueue_ms_per_step",
           "beam_draw_ops_per_eval")
HOST = {"logp_enqueue_ms_per_eval", "sampler_enqueue_ms_per_step"}


def test_innermost_span_of_nested_spans():
    spans = [(0, 100, "a"), (10, 50, "b"), (20, 30, "c"), (60, 90, "d")]
    times = [5, 25, 40, 55, 70, 95, 120, 10, 30]
    assert program_spans.innermost(spans, times) == [
        "a", "c", "b", "a", "d", "a", None, "b", "c"]


def test_attribution_on_a_synthetic_sub_window():
    E = program_spans.Event
    events = [
        E(SUBWINDOW, "host", 0.0, 1000.0),
        E(SUBWINDOW, "device", 0.0, 1000.0),          # the profiler's twin
        E("mcmctof.logp", "host", 100.0, 600.0),
        E("mcmctof.rates", "host", 120.0, 300.0),
        E("mcmctof.rates", "device", 150.0, 320.0),   # a twin as well
        E("aten::erfc", "host", 130.0, 160.0),
        E("mcmctof.k2", "host", 420.0, 430.0),
        E("mcmctof.shape", "host", 435.0, 480.0),
        E("cudaHostAlloc", "host", 705.0, 990.0),
        E("cudaLaunchKernel", "launch", 140.0, 145.0, 7),
        E("cudaLaunchKernel", "launch", 400.0, 405.0, 8),
        E("cudaLaunchKernel", "launch", 20.0, 25.0, 9),
        E("cudaLaunchKernel", "launch", 440.0, 445.0, 10),
        E("erfc_kernel", "device", 150.0, 160.0, 7),  # in logp, then rates
        E("mul_kernel", "device", 410.0, 430.0, 8),   # in logp alone
        E("copy", "device", 30.0, 40.0, 9),           # before any span
        # no launch in the trace: after mul's launch (400), before
        # add's (440), so in k2, the one span between them
        E("tof_hist_kernel", "device", 431.0, 433.0, 77),
        E("add_kernel", "device", 450.0, 455.0, 10),
        # no launch, the last of its stream: between 440 and the end
        E("memset", "device", 700.0, 710.0, 99),
    ]
    r = program_spans.attribute(events)
    assert r["n_ops"] == 6 and r["placed"] == 2
    assert r["ops"] == {"mcmctof.rates": 1, "mcmctof.logp": 1,
                        "mcmctof.k2": 1, "mcmctof.shape": 1, NO_SPAN: 2}
    assert r["window_ms"] == pytest.approx(1.0)
    assert r["busy_ms"] == pytest.approx(0.057)
    # gaps by their middles: 0-30 and 40-150 (95) before any span,
    # 160-410 (285) in rates, 430-431 in logp, 433-450 (441.5) and
    # 455-700 in shape and logp, 710-1000 (855, in cudaHostAlloc) after
    assert r["idle_ms"][NO_SPAN] == pytest.approx((30 + 110 + 290) * 1e-3)
    assert r["idle_ms"]["mcmctof.rates"] == pytest.approx(0.25)
    assert r["idle_ms"]["mcmctof.shape"] == pytest.approx(0.017)
    assert r["idle_ms"]["mcmctof.logp"] == pytest.approx(0.246)
    assert r["gaps"][0] == [f"{NO_SPAN} cudaHostAlloc",
                            pytest.approx(0.29)]
    assert [NO_SPAN, pytest.approx(0.03)] in r["gaps"]
    with pytest.raises(RuntimeError):
        program_spans.attribute(events[2:])


def test_an_operation_without_its_launch_is_placed_by_stream_order():
    spans = [(0, 100, "logp"), (10, 20, "rates"), (30, 40, "k1"),
             (50, 90, "background")]
    # between the last launch of rates and the first after k1
    assert program_spans.between(spans, 15, 45) == "k1"
    # both launches inside one span
    assert program_spans.between(spans, 55, 80) == "background"
    # two spans between the launches: the one open at both
    assert program_spans.between(spans, 5, 95) == "logp"
    assert program_spans.between(spans, -5, 200) is None


def _readings(program, profile):
    r = harness.Readings(plan=None, campaign=None, walkers=256, spans=None,
                         profile=None, device_name="NVIDIA H100 80GB HBM3")
    r.program, r.program_profile = program, profile
    return r


def test_readers_on_synthetic_readings():
    program = {"steps": 10, "wall_ms": 150.0, "order": [], "spans": {
        "mcmctof.step": {"calls": 10, "total_ms": 140.0, "self_ms": 1.0,
                         "parent": None},
        "mcmctof.logp": {"calls": 20, "total_ms": 120.0, "self_ms": 2.0,
                         "parent": "mcmctof.half_update"},
        "mcmctof.beam_draw": {"calls": 20, "total_ms": 80.0,
                              "self_ms": 80.0, "parent": "mcmctof.logp"}}}
    profile = {"n_ops": 12_000, "ops": {"mcmctof.beam_draw": 800},
               "idle_ms": {}, "calls": {"mcmctof.logp": 20,
                                        "mcmctof.beam_draw": 20}}
    r = _readings(program, profile)

    def read(name):
        return plans.metric_reader(name)(r)

    # host ms of a span in B over its calls; device operations launched
    # inside a span in C over the calls of mcmctof.logp
    assert read("logp_enqueue_ms_per_eval") == pytest.approx(6.0)
    assert read("sampler_enqueue_ms_per_step") == pytest.approx(2.0)
    assert read("beam_draw_ops_per_eval") == pytest.approx(40.0)
    # an estimator without a beam draw (counts): no beam-draw reading
    del program["spans"]["mcmctof.beam_draw"]
    del profile["calls"]["mcmctof.beam_draw"]
    r = _readings(program, dict(profile, ops={}))
    assert read("beam_draw_ops_per_eval") is None
    assert read("logp_enqueue_ms_per_eval") == pytest.approx(6.0)
    # a sub-window with no log-prob span: no per-evaluation readings
    del program["spans"]["mcmctof.logp"]
    del profile["calls"]["mcmctof.logp"]
    r = _readings(program, dict(profile, ops={"mcmctof.beam_draw": 800}))
    assert read("logp_enqueue_ms_per_eval") is None
    assert read("beam_draw_ops_per_eval") is None


@pytest.mark.parametrize("name", READERS)
def test_readers_without_spans_return_nothing(name, monkeypatch):
    reader = plans.metric_reader(name)
    assert reader(_readings(None, None)) is None
    # a program without spans (the parent's): nothing measured, no error
    monkeypatch.setattr(program_spans, "program_profiling", lambda: None)
    monkeypatch.setattr(program_spans, "ON_THE_CPU", True)
    plan = plans.resolve("simult-counts", plans.benchmark(ROOT))
    bare = harness.Readings(plan, None, 16, None, None, "cpu")
    assert reader(bare) is None
    assert bare.program is None and bare.program_profile is None
    # the CPU, where the traced run has no profiled sub-window either
    monkeypatch.undo()
    bare = harness.Readings(plan, None, 16, None, None, "cpu")
    assert reader(bare) is None


def test_a_traced_run_on_the_cpu_reports_the_host_clock_metrics(
        monkeypatch, capfd):
    from portbench.tests.test_portbench_run import tiny
    monkeypatch.setattr(program_spans, "ON_THE_CPU", True)
    plan = tiny("simult-counts")
    torch.set_num_threads(1)
    out = harness.run(plan, 2 ** 31 + 77, 1.0, True,
                      t_start=time.perf_counter(), device="cpu",
                      log=lambda s: None)
    assert out["correct"], out["checks"]
    got = set(out["metrics"])
    # the host-clock metrics (the counts cells' names for them), and none
    # read from a device trace
    host = {f"{name}.counts" for name in HOST}
    assert host <= got <= host | {
        "sampler_self_ms_per_step.counts", "logp_ms_per_eval.counts",
        "window_walker_steps_per_s", "window_segment_ms_p95"}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["logp_enqueue_ms_per_eval.counts"] > 0
    assert m["sampler_enqueue_ms_per_step.counts"] > 0
    err = capfd.readouterr().err
    for name in ("mcmctof.step", "mcmctof.logp", "mcmctof.rates",
                 "mcmctof.k2", NO_SPAN):
        assert f"portbench: spans: {name}" in err
