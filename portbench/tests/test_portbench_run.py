"""Runs of the harness on the CPU at a tiny size (the kernels' plain
versions): the result line's keys, the check against the plain
reference, the check failing on a broken timed path, and the refusals
(no card; a checkout without the program; JAX loaded)."""
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import faults, harness, plan as plans
from portbench.plan import HERE, ROOT

CARD = {"name": "cpu", "power_limit": "none"}


def tiny(cell, **config):
    """The cell at a CPU test's size: 16 walkers, 5,000 draws, segments
    of 2 steps, 8 evaluations checked."""
    plan = plans.resolve(cell, plans.benchmark(ROOT))
    c = dict(plan.config, n_samples=5000)
    if c["model"] == "simult":       # two runs: theta (beamE .. s, N_1, N_2)
        c.update(n_runs=2, truth=c["truth"][:6],
                 agitators=[a * 0.2 for a in c["agitators"][:6]])
    else:                            # the default 100 x 10 grid
        c.update(hardcore=False)
    c.update(config)
    plan.config = c
    plan.traffic = dict(plan.traffic, walkers=16, segment_steps=2,
                        record_share=0.5, check_evaluations=8)
    return plan


def run_tiny(plan, seed=20260, trace=False, seconds=1.0):
    torch.set_num_threads(1)
    return harness.run(plan, seed, seconds, trace, t_start=time.perf_counter(),
                       device="cpu", log=lambda s: None)


@pytest.mark.parametrize("cell", ["simult-counts", "onebd-hardcore-counts"])
def test_the_port_agrees_with_the_reference_on_the_cpu(cell):
    out = run_tiny(tiny(cell))
    assert out["correct"], out["checks"]
    assert out["numbers"]["proposal_mismatch"] == 0
    assert 0 < out["numbers"]["evaluations"] <= 8
    assert out["failed"] == 0 and out["attempted"] > 0


def test_the_result_line_has_the_required_keys():
    plan = tiny("simult-counts")
    for trace in (False, True):
        out = run_tiny(plan, trace=trace)
        line = harness.result_line(plan, out, CARD, trace)
        assert list(line)[:5] == ["correct", "attempted", "failed",
                                  "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        names = {m["name"] for m in (plan.per_layer if trace
                                     else plan.end_to_end)}
        assert set(line["metrics"]) <= names
        if not trace:   # the CPU has no trace of a device
            assert set(line["metrics"]) == names - {
                "walker_steps_per_device_s"}
        else:   # the window and the spans only, for the same reason
            assert set(line["metrics"]) == {
                "window_walker_steps_per_s", "window_segment_ms_p95",
                "sampler_self_ms_per_step.counts", "logp_ms_per_eval.counts"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
        json.dumps(line)


@pytest.mark.parametrize("cell", ["simult-counts", "onebd-hardcore-counts"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault, cell):
    monkeypatch.setattr(*faults.planted(fault))
    out = run_tiny(tiny(cell))
    assert not out["correct"], out["checks"]
    if fault.startswith("de_"):
        assert out["numbers"]["proposal_mismatch"] > 0


def _run_py(args, cwd, env=None):
    return subprocess.run([sys.executable, "portbench/run.py"] + args,
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run_py(["--workload", "simult-counts", "--seed", "5",
                 "--seconds", "1", "--trace", "0"], ROOT, env)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_the_benchmark_alone_cannot_build_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); "
            "from portbench import harness, plan; "
            "p = plan.resolve('simult-counts', plan.benchmark(plan.ROOT)); "
            "harness.build_program(p, 'cpu')")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "mcmctoffitting_tpu_torch" in r.stderr
    r = _run_py(["--workload", "simult-counts", "--seed", "5",
                 "--seconds", "1", "--trace", "0"], tmp_path)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mcmctoffitting_tpu_torch_x", sys)
    assert "mcmctoffitting_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_a_seed_gives_the_same_inputs():
    plan = tiny("simult-counts")
    ref = plans.reference_of(plan.traffic)
    camp = ref.campaign(plan.config, plan.traffic)
    big = 2 ** 31 + 12345
    a = harness.observed_spectra(ref, camp, plan.config["truth"], big)
    b = harness.observed_spectra(ref, camp, plan.config["truth"], big)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(harness.starting_walkers(plan, camp, big),
                          harness.starting_walkers(plan, camp, big))
    c = harness.observed_spectra(ref, camp, plan.config["truth"], big + 1)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))
