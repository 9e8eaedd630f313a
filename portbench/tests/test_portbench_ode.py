"""The benchmark's cell on the mc estimator's ODE path,
``simult-taylor-rk4``: it resolves by name, runs through the whole
harness on the CPU at a small size and is correct there; faults planted
in its timed path (``faults_mc.py``) fail the check; K4's bytes and
operations are pinned by hand; the cell's three readers read synthetic
readings and return nothing with nothing to read."""
import json
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import faults_mc, harness, plan as plans
from portbench.plan import HERE, ROOT
from portbench.roofline import k4_transport_moments as k4, peaks

CELL = "simult-taylor-rk4"
NEW = ("k4_transport_moments_roofline", "device_ms_outside_k4_per_step",
       "beam_draw_ops_per_eval")
H100 = "NVIDIA H100 80GB HBM3"


def small(n_samples=5000, n_runs=2, evaluations=8):
    """The cell at a CPU test's size: 16 walkers, segments of 2 steps."""
    plan = plans.resolve(CELL, plans.benchmark(ROOT))
    c = plan.config
    d = 4 + n_runs
    plan.config = dict(c, n_samples=n_samples, n_runs=n_runs,
                       truth=c["truth"][:d],
                       agitators=[a * 0.2 for a in c["agitators"][:d]])
    plan.traffic = dict(plan.traffic, walkers=16, segment_steps=2,
                        record_share=0.5, check_evaluations=evaluations)
    return plan


def run(plan, seed=20260, trace=False):
    torch.set_num_threads(1)
    return harness.run(plan, seed, 1.0, trace, t_start=time.perf_counter(),
                       device="cpu", log=lambda s: None)


def test_the_cell_resolves_by_name():
    bench = plans.benchmark(ROOT)
    plan = plans.resolve(CELL, bench)
    assert plan.chips == 1 and plan.config_name == "simultfit-4run-ode"
    t = plan.traffic
    assert (t["sampling"], t["transport"], t["xs_mode"], t["likelihood"],
            t["move"]) == ("mc", "rk4", "taylor", "poisson", "de")
    fixture = json.loads((HERE / "tests" / "data" / "traffic"
                          / "mc-taylor-rk4-de-256.json").read_text())
    assert {k: v for k, v in t.items() if k != "what"} == {
        k: v for k, v in fixture.items() if k != "what"}
    c = plan.config
    assert (c["model"], c["n_runs"], c["n_samples"], c["n_walkers"]) == (
        "simult", 4, 200_000, 256)
    counts = plans.resolve("simult-counts", bench).config
    assert c["truth"] == counts["truth"]
    assert c["agitators"] == counts["agitators"]
    assert set(plan.limits) == {"proposal_mismatch", "logp_gap_p90",
                                "accept_mismatch", "nonfinite_steps"}
    assert plan.limits["proposal_mismatch"] == 0
    assert plan.limits["nonfinite_steps"] == 0
    assert set(NEW) <= {m["name"] for m in plan.per_layer}
    for m in bench["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
    for cell in ("simult-counts", "onebd-hardcore-counts"):
        assert not set(NEW) & {m["name"] for m in
                               plans.resolve(cell, bench).per_layer}


def test_the_cell_runs_through_the_harness_and_is_correct():
    plan = small()
    out = run(plan)
    assert out["correct"], out["checks"]
    assert out["numbers"]["proposal_mismatch"] == 0
    assert 0 < out["numbers"]["evaluations"] <= 8
    assert out["failed"] == 0 and out["attempted"] > 0
    line = harness.result_line(plan, out, {"name": "cpu",
                                           "power_limit": "none"}, False)
    assert set(line["metrics"]) == {"walker_steps_per_s", "segment_ms_p95",
                                    "setup_s"}
    traced = run(plan, trace=True)
    assert traced["correct"], traced["checks"]
    # the CPU has no trace of a device: the span readers alone
    assert set(traced["metrics"]) == {"sampler_self_ms_per_step",
                                      "logp_ms_per_eval"}


# the size at which each fault shows: the stopping table moves a draw
# count of the rounded lattice in a few cells of a walker-run only, so
# it needs the cell's runs and half its draws (the window then has one
# segment, of which an untraced run could not take a p95: traced)
FAULT_SIZE = {"seed_words_shifted": {},
              "stopping_table": {"n_samples": 100_000, "n_runs": 4}}


@pytest.mark.parametrize("fault", sorted(FAULT_SIZE))
def test_a_broken_forward_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(*faults_mc.planted(fault))
    out = run(small(**FAULT_SIZE[fault]), trace=True)
    assert not out["correct"], out["checks"]
    assert out["numbers"]["proposal_mismatch"] == 0


def test_k4_bytes_and_operations_are_pinned_by_hand():
    # 512 rows x 200k energies read (409.6 MB), (512, 10, 4, 50)
    # histograms written (4.1 MB); 46 operations a (sample, depth) pair
    # at one substep: 46 x 1.024e9
    shape = dict(rows=512, n=200_000, n_x=10, n_bins=50, substeps=1)
    assert k4.bytes_moved(**shape) == 4 * (102_400_000 + 1_024_000)
    assert k4.operations(**shape) == 47_104_000_000
    least, by = k4.bound_s(shape, peaks.peaks_of(H100))
    assert by == "operations"
    assert least * 1e3 == pytest.approx(0.703045, rel=1e-5)
    # the templates' shape: 4 substeps, 100 depths, 150 bins
    tmpl = dict(rows=128, n=200_000, n_x=100, n_bins=150, substeps=4)
    assert k4.operations(**tmpl) == 178 * 128 * 200_000 * 100


def _campaign(runs=4, n=200_000, n_x=10, n_ed=50, substeps=1):
    return SimpleNamespace(n_runs=runs, n_samples=n, x=SimpleNamespace(
        n=n_x), ed=SimpleNamespace(n=n_ed), rk4=SimpleNamespace(
        substeps=substeps))


def test_k4_shape_from_a_campaign():
    assert k4.shape(_campaign(), 256) == dict(rows=512, n=200_000, n_x=10,
                                              n_bins=50, substeps=1)
    from portbench.reference import mc
    camp = mc.campaign(small().config, small().traffic)
    assert k4.shape(camp, 16) == dict(rows=16, n=5000, n_x=10, n_bins=50,
                                      substeps=1)


def _readings(**kw):
    base = dict(plan=None, campaign=None, walkers=0, spans=None,
                profile=None, device_name="cpu")
    base.update(kw)
    return harness.Readings(**base)


def test_the_readers_on_synthetic_readings():
    kernel_s = {"void mcmctof::(anonymous namespace)::"
                "transport_moments_kernel<false>(float const*)": [8e-3] * 4,
                "mcmctof::(anonymous namespace)::fixed_point_to_float("
                "long long const*, float*, long long, int)": [1e-5] * 4,
                "void tof_hist_kernel<10>": [8e-6] * 4}
    profile = {"window_s": 0.1, "busy_s": 0.09, "n_ops": 900, "steps": 2,
               "kernel_s": kernel_s}
    r = _readings(profile=profile, campaign=_campaign(), walkers=256,
                  device_name=H100)
    least, _ = k4.bound_s(k4.shape(_campaign(), 256), peaks.peaks_of(H100))
    assert plans.metric_reader(NEW[0])(r) == pytest.approx(
        100 * least / (8e-3 + 1e-5))
    assert plans.metric_reader(NEW[1])(r) == pytest.approx(
        1e3 * (0.09 - 4 * (8e-3 + 1e-5)) / 2)
    r.program = None
    r.program_profile = {"n_ops": 500, "ops": {"mcmctof.beam_draw": 60,
                                               "mcmctof.logp": 40},
                         "calls": {"mcmctof.logp": 2,
                                   "mcmctof.beam_draw": 2}}
    assert plans.metric_reader(NEW[2])(r) == pytest.approx(30.0)


def test_the_readers_return_nothing_with_nothing_to_read():
    for name in NEW:
        assert plans.metric_reader(name)(_readings()) is None
    no_k4 = _readings(profile={"window_s": 1.0, "busy_s": 0.5, "n_ops": 3,
                               "steps": 1, "kernel_s": {"gemm": [1e-3]}},
                      campaign=_campaign(), walkers=256, device_name=H100)
    assert plans.metric_reader(NEW[0])(no_k4) is None
    assert plans.metric_reader(NEW[1])(no_k4) is None
    counts = _readings()
    counts.program = None
    counts.program_profile = {"n_ops": 300, "ops": {"mcmctof.rates": 1},
                              "calls": {"mcmctof.logp": 2,
                                        "mcmctof.rates": 2}}
    assert plans.metric_reader(NEW[2])(counts) is None
