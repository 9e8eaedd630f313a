"""Loading the benchmark by name: BENCHMARK.json against its required
shape, each cell's configuration, traffic, limits and metric readers,
and a new traffic mix that is only data."""
import json
import re
import time

import numpy as np
import pytest
import torch

from portbench import harness, plan as plans
from portbench.plan import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return plans.benchmark(ROOT)


def test_benchmark_json_has_its_required_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("cell", ["simult-counts", "onebd-hardcore-counts"])
def test_every_cell_resolves_by_name(bench, cell):
    plan = plans.resolve(cell, bench)
    assert plan.chips == 1 and plan.traffic["sampling"] == "counts"
    assert set(plan.limits) == {"proposal_mismatch", "logp_gap_p90",
                                "accept_mismatch", "nonfinite_steps"}
    assert {m["name"] for m in plan.end_to_end} == {
        "walker_steps_per_device_s", "setup_s"}
    for m in plan.per_layer:
        assert callable(plans.metric_reader(m["name"]))
    assert len(plan.config["truth"]) == len(plan.config["agitators"])


@pytest.mark.parametrize("cell", ["simult-counts", "onebd-hardcore-counts",
                                  "simult-taylor-rk4"])
def test_each_per_layer_metric_moves_a_metric_its_cell_reports(bench, cell):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric, and each per-layer metric it reports moves one of
    its end-to-end metrics."""
    plan = plans.resolve(cell, bench)
    e2e = {m["name"] for m in plan.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and plan.per_layer
    for m in plan.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_a_split_metric_reads_as_its_original(bench):
    """``<metric>.counts`` is ``<metric>`` under a name of its own."""
    from portbench.tests.test_portbench_arithmetic import _readings
    r = _readings(spans={"segment_ms": [10.0, 12.0], "logp_ms": [3.0] * 4,
                         "steps": 4})
    split = [m["name"] for m in bench["per_layer"]
             if m["name"].endswith(".counts")]
    assert len(split) == 6
    for name in split:
        original = name[: -len(".counts")]
        assert plans.metric_reader(name)(r) == \
            plans.metric_reader(original)(r)
    assert plans.metric_reader("sampler_self_ms_per_step.counts")(r) == 2.5


def test_the_window_readers_read_the_untraced_window():
    r = harness.Readings(None, None, 256, None, None, "cpu",
                         {"walker_steps_per_s": 2.5e5,
                          "segment_ms_p95": 14.5})
    assert plans.metric_reader("window_walker_steps_per_s")(r) == 2.5e5
    assert plans.metric_reader("window_segment_ms_p95")(r) == 14.5
    bare = harness.Readings(None, None, 256, None, None, "cpu")
    assert plans.metric_reader("window_walker_steps_per_s")(bare) is None
    assert plans.metric_reader("window_segment_ms_p95")(bare) is None


def test_every_config_file_is_under_paths(bench):
    for conf in bench["configs"]:
        path = ROOT / conf["file"]
        assert path.resolve().is_relative_to(HERE)
        data = json.loads(path.read_text())
        assert data["name"] == conf["name"]
        assert data["reduced"] == conf["reduced"] == []
        assert data["source"] == conf["source"]


def _fixture_plan(bench, cell, config, traffic):
    """A cell of a later PR, from data files under ``tests/data/``."""
    data = HERE / "tests" / "data"
    bench = dict(bench, workloads=bench["workloads"] + [
        {"name": cell, "config": config, "traffic": traffic, "chips": 1,
         "why": "fixture"}])
    return plans.resolve(cell, bench, traffic_dir=data / "traffic",
                         workload_dir=data / "workloads")


def _small(plan):
    plan.config = dict(plan.config, n_samples=3000, n_runs=2,
                       truth=plan.config["truth"][:6],
                       agitators=[a * 0.2 for a in
                                  plan.config["agitators"][:6]])
    plan.traffic = dict(plan.traffic, walkers=8, segment_steps=2,
                        record_share=0.5, check_evaluations=4)
    return plan


def _run(plan):
    torch.set_num_threads(1)
    return harness.run(plan, 31, 0.5, False, t_start=time.perf_counter(),
                       device="cpu", log=lambda s: None)


def test_a_new_counts_mix_is_only_data(bench):
    """A later cell on the counts estimator (1,024 walkers) from data
    files alone runs through the whole harness and its check."""
    plan = _fixture_plan(bench, "simult-counts-w1024", "simultfit-4run",
                         "counts-de-1024")
    assert plan.traffic["walkers"] == 1024
    out = _run(_small(plan))
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(plan.limits)


def test_a_mix_on_another_estimator_names_the_reference_it_needs(bench):
    """A later cell (the simultFit CLI's default: mc on the stopping table
    through the e0grid operator) from data files alone: it resolves, the
    program's problem is the CLI's default and runs segments; the harness
    stops at the one missing part, the reference the mix names
    (``reference: mc_table``), and names the file to add."""
    plan = _small(_fixture_plan(bench, "simult-mc", "simultfit-4run",
                                "mc-table-de-256"))
    assert plan.traffic["reference"] == "mc_table"
    problem = harness.build_program(plan, "cpu")
    from mcmctoffitting_tpu_torch.models import simult
    default = simult.default_spec(int(plan.config["n_samples"]))
    for field in ("sampling", "transport", "xs_mode", "e0_grid_fine"):
        assert getattr(problem.spec, field) == getattr(default, field)
    assert (problem.spec.sampling, problem.spec.transport,
            problem.spec.xs_mode, problem.spec.e0_grid_fine) == (
        "mc", "table", "e0grid", 256)
    from mcmctoffitting_tpu_torch import sampler
    rng = np.random.default_rng(0)
    p0 = torch.as_tensor(
        np.asarray(plan.config["truth"], np.float32)
        + np.asarray(plan.config["agitators"], np.float32)
        * rng.standard_normal((8, 6)).astype(np.float32))
    obs = [np.full(w.n_bins, 100.0) for w in problem.windows]
    logp = problem.make_log_prob_fn(obs)
    state = sampler.init_state(p0, logp, generator=torch.Generator()
                               .manual_seed(1), eval_generator=torch
                               .Generator().manual_seed(2))
    win = harness.run_segments(state, logp, 2, plan.traffic["move"],
                               n_segments=1)
    assert win.chains[0][0].shape == (2, 8, 6)
    assert np.all(np.isfinite(win.chains[0][1]))
    with pytest.raises(plans.MissingPart,
                       match="portbench/reference/mc_table.py"):
        _run(plan)


@pytest.mark.parametrize("cell, module", [
    ("simult-counts", "counts"), ("onebd-hardcore-counts", "counts"),
    ("simult-taylor-rk4", "mc")])
def test_each_cell_loads_the_reference_of_its_estimator(bench, cell, module):
    """No accepted cell's mix names a reference: each loads
    ``reference/<sampling>.py``, as before mixes could name one."""
    plan = plans.resolve(cell, bench)
    assert "reference" not in plan.traffic
    assert plan.traffic["sampling"] == module
    ref = plans.reference_of(plan.traffic)
    assert ref is plans.part("reference", "reference", module)
    assert ref.__file__ == str(HERE / "reference" / f"{module}.py")
    assert callable(ref.campaign) and callable(ref.Reference)


def test_a_named_reference_takes_the_place_of_the_estimators():
    assert plans.reference_of({"sampling": "mc", "reference": "counts"}) \
        is plans.reference_of({"sampling": "counts"})
    with pytest.raises(plans.MissingPart,
                       match="portbench/reference/mc_table.py"):
        plans.reference_of({"sampling": "mc", "reference": "mc_table"})


def test_a_missing_part_is_named():
    with pytest.raises(plans.MissingPart, match="portbench/metrics/x_y.py"):
        plans.metric_reader("x_y")
    with pytest.raises(plans.MissingPart,
                       match="portbench/programs/csi2016.py"):
        plans.program("csi2016")
