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
        "walker_steps_per_s", "segment_ms_p95", "setup_s"}
    for m in plan.per_layer:
        assert callable(plans.metric_reader(m["name"]))
    assert len(plan.config["truth"]) == len(plan.config["agitators"])


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
    """A later cell (mc on the ODE path) from data files alone: it
    resolves and the program's problem builds and runs segments; the
    harness stops at the one missing part, the mc estimator's reference,
    and names the file to add."""
    plan = _small(_fixture_plan(bench, "simult-taylor-rk4",
                                "simultfit-4run", "mc-taylor-rk4-de-256"))
    assert plan.traffic["transport"] == "rk4"
    problem = harness.build_program(plan, "cpu")
    assert problem.spec.xs_mode == "taylor" and \
        problem.spec.transport == "rk4"
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
    with pytest.raises(plans.MissingPart, match="portbench/reference/mc.py"):
        _run(plan)


def test_a_missing_part_is_named():
    with pytest.raises(plans.MissingPart, match="portbench/metrics/x_y.py"):
        plans.metric_reader("x_y")
    with pytest.raises(plans.MissingPart,
                       match="portbench/programs/csi2016.py"):
        plans.program("csi2016")
