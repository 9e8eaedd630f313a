"""The program's own spans (``mcmctoffitting_tpu_torch/utils/profiling.py``)
in a traced run: where the host's time and the device's operations go,
stage by stage.

After the traced window and the profiled sub-window, the readers of the
span metrics measure two more sub-windows, once a run (the first reader
to ask measures, the others read what it left on the ``Readings``):

* B: ``profile_segments`` closed-loop segments with the program's spans
  on, no profiler and no synchronize but the window's last: host ms a
  span (``program``);
* C: as many segments with the spans on under ``torch.profiler``: each
  device operation (kernel, copy, memset) put down to the innermost
  ``mcmctof.*`` span open when the host launched it (the profiler links
  an operation to its launching runtime call), and each idle gap of the
  device to the innermost span open at the gap's middle
  (``program_profile``).

Both run in a process of their own (``python -m portbench.program_spans``,
the plan as JSON on its standard input): after a ``torch.profiler``
session a process's host runs slower for good (15-40% a step on the
H100's machine), so B could not follow the harness's profiled
sub-window in the run's own process.  The process builds the cell's
program as the harness does (``harness.build_program``), with data and
walkers from a seed of this module's own (the host's work a step does not
depend on the data's values), warms it up with ``warmup_segments``
segments and ``WARMUP_S`` seconds more, then measures B and C.  A program without spans, and a run on
the CPU (where the traced run has no profiled sub-window either) unless
``ON_THE_CPU`` is set, measure nothing: the readers then return None.
One table a run goes to the log (standard error).
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from typing import NamedTuple

import torch

from . import harness, plan as plans

SUBWINDOW = "portbench.spans_subwindow"
PREFIX = "mcmctof."
NO_SPAN = "(no span)"
SEED = 1_700_000_017
ON_THE_CPU = False
TIMEOUT_S = 900
WARMUP_S = 3.0


def program_profiling():
    """The program's ``utils.profiling`` module where it has spans, else
    None."""
    try:
        from mcmctoffitting_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "spans") and hasattr(profiling, "span")):
        return None
    return profiling


def of(readings):
    """``(program, program_profile)`` of the run whose ``readings`` these
    are, measured on the first call (None where nothing was measured)."""
    if not hasattr(readings, "program"):
        readings.program, readings.program_profile = measure(readings)
    return readings.program, readings.program_profile


# --- attribution ------------------------------------------------------------

def innermost(spans, times):
    """For each of ``times``, the name of the innermost of ``spans``
    ((start, end, name), nested as one thread's spans are) open at it,
    or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [None] * len(times), [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(spans) and spans[i][0] <= t:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[q] = stack[-1][2] if stack else None
    return out


class Event(NamedTuple):
    """One event of sub-window C's trace (times in us).  ``kind``: 'host'
    (the sub-window, a ``mcmctof.*`` span, an operator), 'launch' (a
    runtime call that launched device work) or 'device' (a device
    operation); ``corr``: the correlation id that a launch and its
    operation share; ``stream``: a device operation's stream."""
    name: str
    kind: str
    start: float
    end: float
    corr: int = 0
    stream: int = 0


def between(spans, t0, t1):
    """The span in which an operation launched between ``t0`` and ``t1``
    ran: the one span, among those wholly between them, with no other
    inside it; else the innermost span open at both (or None)."""
    inside = [s for s in spans if t0 < s[0] and s[1] < t1]
    leaves = [s for s in inside
              if not any(o is not s and s[0] <= o[0] and o[1] <= s[1]
                         for o in inside)]
    if len(leaves) == 1:
        return leaves[0][2]
    around = [s for s in spans if s[0] <= t0 and t1 <= s[1]]
    return max(around)[2] if around else None


def attribute(events) -> dict:
    """Device operations and idle time of sub-window C by span.

    ``events``: :class:`Event` s.  An operation counts for the innermost
    span open when its runtime call started.  One whose call the trace
    lacks (a kernel of the port's own library, which links its own CUDA
    runtime) is placed by stream order: it was launched after the
    operation before it on its stream and before the one after it, so it
    counts for the span between those two launches (:func:`between`).  A
    device event named like a span or the sub-window is the profiler's
    device-side twin of a host label, no operation.  Returns the
    sub-window's ``window_ms`` and ``busy_ms``, ``n_ops``, and per span
    name (``NO_SPAN`` where none was open) ``ops`` and ``idle_ms``,
    ``placed`` (operations placed by stream order) and the longest
    ``gaps`` [span, ms] (outside every span: ``NO_SPAN`` and the
    innermost host event at the gap's middle)."""
    window = [(e.start, e.end) for e in events
              if e.kind == "host" and e.name == SUBWINDOW]
    if not window:
        raise RuntimeError("the trace has no spans sub-window")
    lo, hi = window[0]
    spans = [(e.start, e.end, e.name) for e in events
             if e.kind == "host" and e.name.startswith(PREFIX)]
    launched = {e.corr: e.start for e in events if e.kind == "launch"}
    ops = sorted((e for e in events
                  if e.kind == "device" and e.start < hi and e.end > lo
                  and not e.name.startswith(PREFIX)
                  and e.name != SUBWINDOW),
                 key=lambda e: (e.stream, e.start))
    at = [launched.get(e.corr) for e in ops]
    linked = [i for i, t in enumerate(at) if t is not None]
    names = [None] * len(ops)
    for i, name in zip(linked, innermost(spans, [at[i] for i in linked])):
        names[i] = name
    placed = 0
    for i, op in enumerate(ops):
        if at[i] is not None:
            continue
        placed += 1
        j = i - 1
        while j >= 0 and (at[j] is None or ops[j].stream != op.stream):
            j -= 1
        k = i + 1
        while k < len(ops) and (at[k] is None or ops[k].stream != op.stream):
            k += 1
        names[i] = between(spans, at[j] if j >= 0 else lo,
                           at[k] if k < len(ops) else hi)
    by_op = {}
    for name in names:
        by_op[name or NO_SPAN] = by_op.get(name or NO_SPAN, 0) + 1
    intervals = [(e.start, e.end) for e in ops]
    gaps = harness.idle_gaps(intervals, lo, hi)
    gap_names = innermost(spans, [0.5 * (a + b) for a, b in gaps])
    others = [(e.start, e.end, e.name) for e in events
              if e.kind == "host" and not e.name.startswith(PREFIX)
              and e.name != SUBWINDOW]
    idle, labelled = {}, []
    for (a, b), name in zip(gaps, gap_names):
        key = name or NO_SPAN
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-3
        if name is None:
            mid = 0.5 * (a + b)
            around = [(e - s, n) for s, e, n in others if s <= mid <= e]
            key = f"{NO_SPAN} {min(around)[1][:60] if around else ''}"
        labelled.append([key.strip(), (b - a) * 1e-3])
    labelled.sort(key=lambda g: -g[1])
    return {"window_ms": (hi - lo) * 1e-3,
            "busy_ms": harness.union_s(intervals, lo, hi) * 1e-3,
            "n_ops": len(ops), "ops": by_op, "idle_ms": idle,
            "placed": placed, "gaps": labelled[:10]}


def trace_events(prof) -> list:
    """``attribute``'s events from a finished ``torch.profiler`` run, read
    from its Kineto events, which keep the correlation ids."""
    out = []
    for k in prof.profiler.kineto_results.events():
        if k.device_type().name == "CUDA":
            kind = "device"
        elif k.linked_correlation_id() > 0:
            kind = "launch"
        else:
            kind = "host"
        out.append(Event(k.name(), kind, 1e-3 * k.start_ns(),
                         1e-3 * k.end_ns(), k.correlation_id(),
                         k.device_resource_id()))
    return out


# --- the sub-windows --------------------------------------------------------

def measure(readings):
    """Sub-windows B and C, in a process of their own; (None, None) where
    the program has no spans, where there is no plan, on the CPU unless
    ``ON_THE_CPU``, and where the process fails (its error in the log)."""
    plan = readings.plan
    cpu = readings.device_name == "cpu"
    if plan is None or program_profiling() is None or (cpu and not ON_THE_CPU):
        return None, None
    job = json.dumps({"plan": dataclasses.asdict(plan),
                      "device": "cpu" if cpu else "cuda"})
    try:
        r = subprocess.run([sys.executable, "-m", "portbench.program_spans"],
                           input=job, stdout=subprocess.PIPE, text=True,
                           cwd=plans.ROOT, timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        r = None
    if r is None or r.returncode != 0:
        print("portbench: spans: the sub-windows' process failed "
              f"({'timed out' if r is None else f'exit {r.returncode}'}); "
              "no span metrics", file=sys.stderr, flush=True)
        return None, None
    out = json.loads(r.stdout.strip().splitlines()[-1])
    return out["program"], out["program_profile"]


def sub_windows(plan, dev):
    """Set-up, then sub-windows B and C of ``plan``'s cell on ``dev``:
    ``(program, program_profile)``."""
    from mcmctoffitting_tpu_torch import sampler
    from mcmctoffitting_tpu_torch.utils import profiling
    from torch.profiler import ProfilerActivity, profile, record_function
    t = plan.traffic
    steps, move = int(t["segment_steps"]), t["move"]
    n = int(t["profile_segments"])
    ref = plans.reference_of(t)
    camp = ref.campaign(plan.config, t)
    observed = harness.observed_spectra(ref, camp, plan.config["truth"], SEED)
    p0 = torch.as_tensor(harness.starting_walkers(plan, camp, SEED),
                         device=dev)
    logp = harness.build_program(plan, dev).make_log_prob_fn(observed)
    state = sampler.init_state(
        p0, logp,
        generator=torch.Generator(dev).manual_seed(harness.derive(SEED, 5)),
        eval_generator=torch.Generator().manual_seed(
            harness.derive(SEED, 6)))
    state = harness.run_segments(state, logp, steps, move,
                                 n_segments=int(t["warmup_segments"])).state
    # a new process's first segments run slower on the host than those
    # of a window: WARMUP_S more seconds of segments first
    state = harness.run_segments(state, logp, steps, move,
                                 seconds=WARMUP_S).state

    with profiling.spans() as rec:
        win = harness.run_segments(state, logp, steps, move, n_segments=n)
    program = {"spans": rec.summary(), "steps": steps * n,
               "wall_ms": 1e3 * win.wall_s, "order": _order(rec.records)}

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with profiling.spans() as rec_c:
            with record_function(SUBWINDOW):
                harness.run_segments(win.state, logp, steps, move,
                                     n_segments=n)
    program_profile = attribute(trace_events(prof))
    program_profile["calls"] = {name: s["calls"] for name, s
                                in rec_c.summary().items()}
    program_profile["steps"] = steps * n
    return program, program_profile


def main() -> int:
    job = json.loads(sys.stdin.read())
    plan = plans.Plan(**job["plan"])
    dev = torch.device(job["device"])
    torch.set_num_threads(1)
    if dev.type == "cuda":
        from mcmctoffitting_tpu_torch.ops.cuda_build import load_library
        load_library()
    program, program_profile = sub_windows(plan, dev)
    _log(program, program_profile)
    print(json.dumps({"program": program,
                      "program_profile": program_profile}), flush=True)
    return 0


def _order(records) -> list:
    """Span names by their first start."""
    first = {}
    for r in records:
        first[r.name] = min(first.get(r.name, r.start_ns), r.start_ns)
    return sorted(first, key=first.get)


def _log(program, prof):
    spans, calls_c = program["spans"], prof["calls"]
    lines = [f"{'span':<22} {'calls':>6} {'host ms':>9} {'self ms':>9} "
             f"{'ops':>8} {'idle ms':>9}   (a call; B: host, C: device)"]
    for name in program["order"]:
        s, kc = spans[name], calls_c.get(name, 0)
        ops, idle = prof["ops"].get(name, 0), prof["idle_ms"].get(name, 0.0)
        lines.append(
            f"{name:<22} {s['calls']:>6d} {s['total_ms'] / s['calls']:>9.4f} "
            f"{s['self_ms'] / s['calls']:>9.4f} "
            f"{(ops / kc if kc else 0.0):>8.2f} "
            f"{(idle / kc if kc else 0.0):>9.4f}")
    lines.append(f"{NO_SPAN:<22} {'':>6} {'':>9} {'':>9} "
                 f"{prof['ops'].get(NO_SPAN, 0):>8d} "
                 f"{prof['idle_ms'].get(NO_SPAN, 0.0):>9.3f}   (in all)")
    logp = spans.get(PREFIX + "logp")
    covered = (1.0 - logp["self_ms"] / logp["total_ms"]
               if logp and logp["total_ms"] > 0 else float("nan"))
    inside = 1.0 - prof["ops"].get(NO_SPAN, 0) / max(prof["n_ops"], 1)
    lines.append(
        f"B: {program['steps']} steps in {program['wall_ms']:.3f} ms; the "
        f"stage spans cover {100 * covered:.2f}% of mcmctof.logp's host "
        f"time.  C: {prof['n_ops']} device operations "
        f"({100 * inside:.2f}% inside a span, {prof['placed']} placed by "
        f"stream order), "
        f"busy {prof['busy_ms']:.3f} of {prof['window_ms']:.3f} ms; longest "
        f"idle gaps " + ", ".join(f"{n} {ms:.3f} ms"
                                  for n, ms in prof["gaps"][:5]))
    for line in lines:
        print(f"portbench: spans: {line}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    sys.exit(main())
