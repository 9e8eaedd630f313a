"""What the port's spans cost when they are on, and what a profiler
session leaves behind, on one card.

    python perf/spans_cost.py --workload simult-counts --seconds 50
        --seeds 11 12 13 [--after-profiler 5] [--out out/spans_cost.jsonl]

For each seed, in one process and in turns (off, on; then on, off for the
next seed, and so on), one untraced run of the benchmark's cell
(``portbench.harness.run``, the window ``--seconds`` long) with the
program's spans off, and one with them on (``utils.profiling.spans``
around the whole run: every span records, no profiler).  Prints one JSON
line a run: the seed, spans on or off, ``walker_steps_per_s``,
``segment_ms_p95``, ``setup_s``, the spans recorded and, spans on, each
span's calls and its host ms and own ms a call over the whole run (set-up,
window and the check's sample).

``--after-profiler N`` then times N segments (host ms a DE step, each
segment ending in a synchronize) with the spans off, runs one segment
under ``torch.profiler`` (CPU and CUDA), and times N segments again: the
host's speed before and after a profiler session in one process.
Needs a CUDA card.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def cost_runs(plan, seeds, seconds, log):
    from mcmctoffitting_tpu_torch.utils import profiling
    from portbench import harness
    lines = []
    for i, seed in enumerate(seeds):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            rec = None
            if on:
                with profiling.spans() as rec:
                    out = harness.run(plan, seed, seconds, False,
                                      t_start=time.perf_counter(), log=log)
            else:
                out = harness.run(plan, seed, seconds, False,
                                  t_start=time.perf_counter(), log=log)
            line = {"workload": plan.cell, "seed": seed, "spans": on,
                    "correct": out["correct"],
                    "spans_recorded": len(rec.records) if rec else 0}
            line.update({k: v["value"] for k, v in out["metrics"].items()})
            if rec:
                line["spans_a_call"] = {
                    name: [s["calls"], s["total_ms"] / s["calls"],
                           s["self_ms"] / s["calls"]]
                    for name, s in rec.summary().items()}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


def after_profiler(plan, n):
    """Host ms a step of ``n`` segments before and after one profiled
    segment, in one process."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcmctoffitting_tpu_torch import sampler
    from portbench import harness, plan as plans
    t = plan.traffic
    steps, move = int(t["segment_steps"]), t["move"]
    ref = plans.reference(t["sampling"])
    camp = ref.campaign(plan.config, t)
    observed = harness.observed_spectra(ref, camp, plan.config["truth"], 7)
    dev = torch.device("cuda")
    p0 = torch.as_tensor(harness.starting_walkers(plan, camp, 7), device=dev)
    logp = harness.build_program(plan, dev).make_log_prob_fn(observed)
    state = sampler.init_state(
        p0, logp, generator=torch.Generator(dev).manual_seed(1),
        eval_generator=torch.Generator().manual_seed(2))
    state = harness.run_segments(state, logp, steps, move,
                                 n_segments=2).state

    def timed():
        nonlocal state
        ms = []
        for _ in range(n):
            w = harness.run_segments(state, logp, steps, move,
                                     n_segments=1)
            state = w.state
            ms.append(1e3 * w.wall_s / steps)
        return ms

    before = timed()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        harness.run_segments(state, logp, steps, move, n_segments=1)
    after = timed()
    line = {"workload": plan.cell, "step_ms_before_profiler": before,
            "step_ms_after_profiler": after}
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--after-profiler", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import plan as plans
    if not torch.cuda.is_available():
        print("spans_cost: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    plan = plans.resolve(args.workload, plans.benchmark(ROOT), ROOT)

    def log(text):
        print(f"spans_cost: {text}", file=sys.stderr, flush=True)

    lines = cost_runs(plan, args.seeds, args.seconds, log)
    if args.after_profiler:
        lines.append(after_profiler(plan, args.after_profiler))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
