"""The cell on the simultFit CLI's default estimator, ``simult-mc`` (mc
on the stopping table through the e0grid operator, F = 256): it resolves
by name to its own reference, runs through the whole harness on the CPU
at a small size and is correct there; the fine-cell moments' bytes and
bound and the A contraction's shape are pinned by hand at the cell's
shape; the two new readers read synthetic readings and return nothing
with nothing to read."""
import json
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, plan as plans
from portbench.plan import HERE, ROOT
from portbench.roofline import a_contract, fine_cell_moments as fcm, peaks

CELL = "simult-mc"
NEW = ("fine_moments_roofline", "fine_moments_ops_per_eval",
       "a_contract_roofline.mc")
H100 = "NVIDIA H100 80GB HBM3"


@pytest.fixture(scope="module")
def plan():
    return plans.resolve(CELL, plans.benchmark(ROOT))


@pytest.fixture(scope="module")
def camp(plan):
    return plans.reference_of(plan.traffic).campaign(plan.config,
                                                     plan.traffic)


def test_the_cell_resolves_to_its_own_reference(plan):
    assert plan.chips == 1 and plan.config_name == "simultfit-4run-mc"
    t = plan.traffic
    assert (t["sampling"], t["transport"], t["xs_mode"], t["fine_grid"],
            t["reference"], t["likelihood"], t["move"], t["walkers"],
            t["segment_steps"]) == ("mc", "table", "e0grid", None,
                                    "mc_table", "poisson", "de", 256, 3)
    ref = plans.reference_of(t)
    assert ref.__file__ == str(HERE / "reference" / "mc_table.py")
    assert callable(ref.campaign) and callable(ref.Reference)
    fixture = json.loads((HERE / "tests" / "data" / "traffic"
                          / "mc-table-de-256.json").read_text())
    assert {k: v for k, v in t.items() if k != "what"} == {
        k: v for k, v in fixture.items() if k != "what"}
    c = plan.config
    assert (c["model"], c["n_runs"], c["n_samples"], c["n_walkers"]) == (
        "simult", 4, 200_000, 256)
    counts = plans.resolve("simult-counts", plans.benchmark(ROOT)).config
    assert (c["truth"], c["agitators"]) == (counts["truth"],
                                            counts["agitators"])
    assert plan.limits["proposal_mismatch"] == 0
    assert plan.limits["nonfinite_steps"] == 0
    assert {m["name"] for m in plan.end_to_end} == {
        "walker_steps_per_s", "segment_ms_p95", "setup_s"}
    names = {m["name"] for m in plan.per_layer}
    assert set(NEW) <= names
    assert not {"k4_transport_moments_roofline",
                "device_ms_outside_k4_per_step"} & names
    for m in plan.per_layer:
        assert m["moves"] == "walker_steps_per_s"
        assert callable(plans.metric_reader(m["name"]))


def test_the_program_is_the_clis_default(plan):
    from mcmctoffitting_tpu_torch.models import simult
    problem = harness.build_program(plan, "cpu")
    default = simult.default_spec(int(plan.config["n_samples"]))
    for field in ("sampling", "transport", "xs_mode", "e0_grid_fine"):
        assert getattr(problem.spec, field) == getattr(default, field)
    assert problem.spec.e0_grid_fine == 256


def small(plan, n_samples=5000, n_runs=2):
    """The cell at a CPU test's size: 16 walkers, segments of 2 steps."""
    c = plan.config
    d = 4 + n_runs
    config = dict(c, n_samples=n_samples, n_runs=n_runs,
                  truth=c["truth"][:d],
                  agitators=[a * 0.2 for a in c["agitators"][:d]])
    traffic = dict(plan.traffic, walkers=16, segment_steps=2,
                   record_share=0.5, check_evaluations=8)
    return plans.Plan(**dict(vars(plan), config=config, traffic=traffic))


def test_the_cell_runs_through_the_harness_and_is_correct(plan):
    torch.set_num_threads(1)
    p = small(plan)
    out = harness.run(p, 2 ** 31 + 24017, 1.0, False,
                      t_start=time.perf_counter(), device="cpu",
                      log=lambda s: None)
    assert out["correct"], out["checks"]
    assert out["numbers"]["proposal_mismatch"] == 0
    assert 0 < out["numbers"]["evaluations"] <= 8
    assert out["failed"] == 0 and out["attempted"] > 0
    line = harness.result_line(p, out, {"name": "cpu",
                                        "power_limit": "none"}, False)
    assert set(line["metrics"]) == {"walker_steps_per_s", "segment_ms_p95",
                                    "setup_s"}


def test_fine_moments_bytes_and_bound_are_pinned_by_hand(camp):
    # 128 walkers x 4 runs of 200k float32 energies read (409.6 MB), the
    # (512, 4, 256) float32 moments written (2.1 MB)
    shape = fcm.shape(camp, 256)
    assert shape == dict(rows=512, n=200_000, n_fine=256)
    assert fcm.bytes_moved(**shape) == 411_697_152
    assert fcm.operations(**shape) == 13 * 512 * 200_000
    least, by = fcm.bound_s(shape, peaks.peaks_of(H100))
    assert by == "bytes"
    assert least * 1e3 == pytest.approx(0.1229, rel=1e-3)


def test_the_a_contraction_at_the_cells_shape(camp):
    # 128 walkers x 4 runs of 4 x 256 moments into 10 x 50 cells
    shape = a_contract.shape(camp, 256)
    assert (shape["rows"], shape["k"], shape["n_cols"]) == (512, 1024, 500)
    assert 0 < shape["nnz"] < 1024 * 500 // 20
    assert a_contract.bytes_moved(**shape) == \
        4 * (512 * 1024 + 512 * 500) + 8 * shape["nnz"]


def _readings(**kw):
    base = dict(plan=None, campaign=None, walkers=0, spans=None,
                profile=None, device_name="cpu")
    base.update(kw)
    return harness.Readings(**base)


def _campaign():
    return SimpleNamespace(n_runs=4, n_samples=200_000,
                           operator=SimpleNamespace(n_fine=256))


SCATTER = ("void at::native::_scatter_gather_elementwise_kernel<128, 8, "
           "at::native::_cuda_scatter_gather_internal_kernel<true, long>"
           "::operator()<at::native::ReduceAdd>(...)::{lambda(int)#1}>"
           "(int, ...)")


def test_the_fine_moments_roofline_reads_its_kernels_alone():
    kernel_s = {SCATTER: [4e-3] * 24,
                "void mcmctof::a_contract_kernel<4>(float const*)": [1e-5],
                "void at::native::vectorized_elementwise_kernel": [1.0]}
    r = _readings(profile={"window_s": 0.2, "busy_s": 0.19, "n_ops": 900,
                           "steps": 3, "kernel_s": kernel_s},
                  campaign=_campaign(), walkers=256, device_name=H100)
    least, _ = fcm.bound_s(fcm.shape(_campaign(), 256), peaks.peaks_of(H100))
    reader = plans.metric_reader("fine_moments_roofline")
    # 24 launches over 6 evaluations: 16 ms an evaluation
    assert reader(r) == pytest.approx(100 * least / 16e-3)
    r.profile = dict(r.profile, kernel_s={
        "void mcmctof::fine_cell_moments_kernel<256>": [2e-4] * 6})
    assert reader(r) == pytest.approx(100 * least / 2e-4)
    # nothing to read: no profile, no such launch, no known chip
    assert reader(_readings()) is None
    r.profile = dict(r.profile, kernel_s={"gemm": [1e-3]})
    assert reader(r) is None
    r.profile["kernel_s"] = kernel_s
    r.device_name = "cpu"
    assert reader(r) is None


def test_the_fine_moments_ops_reader_on_synthetic_readings():
    reader = plans.metric_reader("fine_moments_ops_per_eval")
    r = _readings()
    r.program = None
    r.program_profile = {"n_ops": 900, "ops": {"mcmctof.fine_moments": 78,
                                               "mcmctof.beam_draw": 80},
                         "calls": {"mcmctof.logp": 2,
                                   "mcmctof.fine_moments": 2}}
    assert reader(r) == pytest.approx(39.0)
    # a program before the span, another estimator, no spans at all
    r.program_profile = {"n_ops": 900, "ops": {"mcmctof.energy_grid": 78},
                         "calls": {"mcmctof.logp": 2,
                                   "mcmctof.energy_grid": 2}}
    assert reader(r) is None
    r.program_profile = {"n_ops": 0, "ops": {}, "calls": {}}
    assert reader(r) is None
    assert reader(_readings()) is None


def test_the_split_a_contract_roofline_reads_as_its_original(camp):
    kernel_s = {"void mcmctof::a_contract_kernel<4>(float const*)":
                [1e-5, 2e-5]}
    r = _readings(profile={"window_s": 1.0, "busy_s": 0.5, "n_ops": 2,
                           "steps": 1, "kernel_s": kernel_s},
                  campaign=camp, walkers=256, device_name=H100)
    got = plans.metric_reader("a_contract_roofline.mc")(r)
    assert got == plans.metric_reader("a_contract_roofline")(r)
    least, _ = a_contract.bound_s(a_contract.shape(camp, 256),
                                  peaks.peaks_of(H100))
    assert got == pytest.approx(100 * least / 1.5e-5)
