"""One run of one cell: set-up, the measured window, the traced
sub-window, the check against the plain reference, and the result line.

The program under test is ``mcmctoffitting_tpu_torch``: its problem
classes, its forward and its DE sampler (``sampler.run_mcmc``), driven as
a physicist's fit drives them: closed-loop segments of ``segment_steps``
steps, each segment's chain copied to pinned host memory asynchronously
by the CLI's ``cli/_driver.py::_Fetch`` and waited for only after the
next segment has been enqueued.  The problem comes from the
configuration's ``programs/<model>.py``.  Everything else here is the
benchmark's own: the observed spectra and the starting walkers are made
from the seed by the plain reference the mix names
(``plan.reference_of``), which imports nothing of the program.

The window is the same in both modes: no synchronize but its last.  An
untraced run then profiles ``DEVICE_SEGMENTS`` segments where its cell
reports ``walker_steps_per_device_s``; a traced run runs
``SPAN_SECONDS`` more with every log-prob call and segment between
synchronizes (the spans), then its profiled sub-window.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import plan as plans
from .plan import Plan
from .reference import de_move

FORBIDDEN = ("jax", "jaxlib", "flax", "mcmctoffitting_tpu")
SUBWINDOW = "portbench.subwindow"
SPAN_SECONDS = 10.0     # a traced run's synchronized window, after the window
DEVICE_SEGMENTS = 10    # segments profiled for walker_steps_per_device_s


def derive(seed: int, stream: int) -> int:
    """A 63-bit seed for one of the run's random streams."""
    state = np.random.SeedSequence([seed % 2 ** 64, stream]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a JAX library or the JAX
    package (whole names: the port's name starts with the JAX
    package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _sync(tensor):
    if tensor.is_cuda:
        torch.cuda.synchronize()


# --- set-up -----------------------------------------------------------------

def build_program(plan: Plan, device):
    """The program's problem for the cell (``programs/<model>.py``)."""
    return plans.program(plan.config["model"])(plan.config, plan.traffic,
                                               device)


def observed_spectra(reference, camp, truth, seed: int):
    """Per-run observed counts: the model spectra of ``reference`` (the
    reference module the mix names) at the campaign's truth, one Poisson
    fluctuation each (numpy), on the CPU."""
    ref = reference.Reference(camp, None, "cpu")
    gen = torch.Generator().manual_seed(derive(seed, 0))
    theta = torch.as_tensor(np.asarray(truth, np.float32))[None]
    spectra = ref.spectra(theta, gen)[0].double().numpy()
    rng = np.random.default_rng(derive(seed, 1))
    return tuple(rng.poisson(np.maximum(spectra[r, :w.n_bins], 0.0))
                 .astype(np.float64) for r, w in enumerate(camp.windows))


def starting_walkers(plan: Plan, camp, seed: int) -> np.ndarray:
    """The truth plus the campaign's agitators times normals, 1e-3 inside
    the prior box (float32, (W, D))."""
    c = plan.config
    rng = np.random.default_rng(derive(seed, 2))
    truth = np.asarray(c["truth"], np.float64)
    p0 = truth + np.asarray(c["agitators"], np.float64) * \
        rng.standard_normal((int(plan.traffic["walkers"]), truth.size))
    return np.clip(p0, camp.param_lo + 1e-3,
                   camp.param_hi - 1e-3).astype(np.float32)


# --- the window -------------------------------------------------------------

class Record(NamedTuple):
    """One recorded log-prob call of the window: the proposals and the
    log-probs as the program made them, the eval generator's state before
    the call (the seed words of the draws), and where the move generator
    stood when the half-update began (its state and the acceptance
    uniforms of the half-update before still to be drawn from it)."""
    segment: int
    k: int                  # the call's index in its segment
    proposal: object
    log_prob: object
    eval_state: torch.Tensor
    move_state: torch.Tensor
    move_skip: int


class Recorder:
    """The log-prob callable handed to ``run_mcmc``.  In the segments it
    records, it keeps a :class:`Record` of each call (the tensors by
    reference: nothing is copied on the device).  In a traced run it
    times each call between two synchronizes."""

    def __init__(self, logp, move_gen, record, traced=False):
        self.logp, self.move_gen = logp, move_gen
        self.record, self.traced = set(record), traced
        self.segment, self.k = -1, 0
        self.records, self.logp_ms = [], []
        self.move_start = (move_gen.get_state(), 0)

    def begin(self, segment: int):
        self.segment, self.k = segment, 0

    def __call__(self, thetas, generator):
        keep = self.segment in self.record
        if keep:
            eval_state = generator.get_state()
        if self.traced:
            _sync(thetas)
            t0 = time.perf_counter()
        out = self.logp(thetas, generator)
        if self.traced:
            _sync(out)
            self.logp_ms.append(1e3 * (time.perf_counter() - t0))
        if keep:
            self.records.append(Record(self.segment, self.k, thetas, out,
                                       eval_state, *self.move_start))
        if keep or self.segment + 1 in self.record:
            # the next half-update draws after this one's acceptances
            self.move_start = (self.move_gen.get_state(), thetas.shape[0])
        self.k += 1
        return out


def _fetch(chain):
    """The CLI's fetch of a segment's chain, and an event (a host time
    on the CPU) just after its copy is enqueued."""
    from mcmctoffitting_tpu_torch.cli._driver import _Fetch
    fetch = _Fetch(chain)
    if fetch.done is None:
        return fetch, time.perf_counter()
    done = torch.cuda.Event(enable_timing=True)
    done.record()
    return fetch, done


@dataclasses.dataclass
class WindowResult:
    state: object
    chains: list            # [(positions (S, W, D), log_probs (S, W))]
    segment_ms: list
    wall_s: float


def run_segments(state, logp, steps, move, *, seconds=None, n_segments=None,
                 recorder=None, sync_each=False):
    """Closed-loop segments until ``seconds`` of host clock have passed
    (or ``n_segments`` are done); ends in a synchronize.  Segment i's
    duration runs from the event after segment i-1's copy to the one
    after its own (host clock on the CPU); with ``sync_each`` every
    segment ends in a synchronize and is timed by the host clock."""
    from mcmctoffitting_tpu_torch import sampler
    cuda = state.positions.is_cuda
    chains, marks, seg_ms = [], [], []
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = last = time.perf_counter()
    pending, i = None, 0
    while True:
        if recorder is not None:
            recorder.begin(i)
        chain = sampler.run_mcmc(state, steps, logp, move=move)
        state = chain.state
        fetch, mark = _fetch(chain)
        if sync_each:
            _sync(state.positions)
            now = time.perf_counter()
            seg_ms.append(1e3 * (now - last))
            last = now
        marks.append(mark)
        if pending is not None:
            chains.append(_kept(pending))
        pending, i = fetch, i + 1
        if seconds is not None and time.perf_counter() - t0 >= seconds:
            break
        if n_segments is not None and i >= n_segments:
            break
    chains.append(_kept(pending))
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not sync_each:
        if cuda:
            marks = [start] + marks
            seg_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            marks = [t0] + marks
            seg_ms = [1e3 * (b - a) for a, b in zip(marks, marks[1:])]
    return WindowResult(state, chains, seg_ms, wall)


def _kept(fetch):
    """A fetched segment's (positions, log-probs), copied out of the
    pinned buffer so that the buffer goes back to the allocator."""
    positions, log_probs, _ = fetch.result()
    return positions.copy(), log_probs.copy()


def p95(values) -> float:
    """The 95th percentile, Python's ``statistics.quantiles`` (n = 100,
    'exclusive'), of at least two values."""
    import statistics
    return float(statistics.quantiles(values, n=100)[94])


def host_clocks():
    """(this process's CPU seconds, the machine's stolen CPU seconds):
    where the host's time went in a window."""
    import os
    cpu = sum(os.times()[:4])
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        steal = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        steal = float("nan")
    return cpu, steal


# --- the traced sub-window --------------------------------------------------

def union_s(intervals, lo, hi) -> float:
    """Length of the union of (start, end) intervals, clipped to
    [lo, hi]."""
    busy, cur = 0.0, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def idle_gaps(intervals, lo, hi):
    """The gaps in [lo, hi] that no interval covers, edges included."""
    gaps, reach = [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > reach:
            gaps.append((reach, a))
        reach = max(reach, b)
    if hi > reach:
        gaps.append((reach, hi))
    return gaps


def reduce_trace(events, steps: int) -> dict:
    """Device time, operations, busy union, top operations and the
    longest idle gaps (labelled by the innermost host operation running
    at their middle) of a profiled sub-window.  ``events``: (name, kind,
    start_us, end_us), kind 'device' or 'host'; the host event named
    ``SUBWINDOW`` spans the sub-window (its device-side twin, which the
    profiler also records, is no operation)."""
    span = [(a, b) for name, kind, a, b in events
            if kind == "host" and name == SUBWINDOW]
    if not span:
        raise RuntimeError("the trace has no sub-window span")
    lo, hi = span[0]
    dev = [(a, b, name) for name, kind, a, b in events
           if kind == "device" and name != SUBWINDOW]
    host = [(a, b, name) for name, kind, a, b in events
            if kind == "host" and name != SUBWINDOW]
    intervals = [(a, b) for a, b, _ in dev]
    busy_us = union_s(intervals, lo, hi)
    by_name, kernel_s = {}, {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        kernel_s.setdefault(name, []).append((b - a) * 1e-6)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle_gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])
    labelled = []
    for a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        around = [(e - s, name) for s, e, name in host if s <= mid <= e]
        label = min(around)[1] if around else "host: nothing traced"
        labelled.append([label[:120], (b - a) * 1e-6])
    return {"window_s": (hi - lo) * 1e-6, "busy_s": busy_us * 1e-6,
            "n_ops": len(dev), "steps": steps, "kernel_s": kernel_s,
            "breakdown": {"device_ops": [[n[:120], s] for n, s in top],
                          "idle_gaps": labelled}}


def profiled_segments(state, logp, steps, move, n_segments):
    """``n_segments`` closed-loop segments under ``torch.profiler``, with
    no span synchronizes; the reduced trace."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(SUBWINDOW):
            run_segments(state, logp, steps, move, n_segments=n_segments)
    events = [(e.name, "device" if e.device_type.name == "CUDA" else "host",
               e.time_range.start, e.time_range.end) for e in prof.events()]
    return reduce_trace(events, steps * n_segments)


# --- the check --------------------------------------------------------------

def logp_gaps(candidate: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """|candidate - reference| per walker; 0 where both are -inf, inf
    where one is and the other is not."""
    a, b = candidate.astype(np.float64), reference.astype(np.float64)
    same = (a == b) | (np.isneginf(a) & np.isneginf(b))
    with np.errstate(invalid="ignore"):
        gap = np.abs(a - b)
    return np.where(same, 0.0, np.where(np.isnan(gap), np.inf, gap))


def judge(records, chains, before0, reference, *, candidate=None) -> dict:
    """The numbers the check compares, over the sampled evaluations.

    ``proposal_mismatch``: walkers whose proposal is not the DE move's
    (``reference/de_move.py``), with its partners, factor and uniforms
    drawn again from where the move generator stood when the half-update
    began.  ``logp_gap_p90``: the 90th percentile (an element of the set)
    over every walker of every sampled evaluation of the gap between the
    candidate's log-prob and the reference's, at the same proposal and
    seed words.  ``accept_mismatch``: walkers whose DE acceptance differs
    from the reference's decision on the same uniforms, plus walkers whose
    new state is neither their old one nor their proposal.  The candidate
    is the program (its log-probs and the chain it kept), or with
    ``candidate`` another reference put in its place (the control)."""
    gaps, mismatch, accepted, proposals = [], 0, 0, 0
    dev = reference.device
    for r in records:
        step, parity = divmod(r.k, 2)
        pos, lps = chains[r.segment]
        if step > 0:
            prev_pos, prev_lp = pos[step - 1], lps[step - 1]
        elif r.segment > 0:
            prev_pos, prev_lp = (chains[r.segment - 1][0][-1],
                                 chains[r.segment - 1][1][-1])
        else:
            prev_pos, prev_lp = before0
        before, lp_before = prev_pos[parity::2], prev_lp[parity::2]
        # the complementary half as this half-update saw it: for the odd
        # walkers, the even ones after this step's first half-update
        passive = (prev_pos if parity == 0 else pos[step])[1 - parity::2]
        after = pos[step][parity::2]
        mgen = torch.Generator(device=r.move_state_device)
        mgen.set_state(r.move_state)
        j1, j2, g, u = de_move.draws(mgen, len(before), before.shape[1],
                                     r.move_skip)
        proposals += de_move.proposal_mismatches(r.proposal, before,
                                                 passive, j1, j2, g)
        prop_t = torch.as_tensor(r.proposal, device=dev)
        gen = torch.Generator().manual_seed(0)
        gen.set_state(r.eval_state)
        lp_ref = reference.log_prob(prop_t, gen)
        u = u.to(dev)
        lp_b = torch.as_tensor(lp_before, device=dev)
        accept_ref = torch.log(u) < lp_ref - lp_b
        if candidate is None:
            lp_c = np.asarray(r.log_prob)
            moved = np.all(after == r.proposal, axis=1)
            stayed = np.all(after == before, axis=1)
            mismatch += int(np.sum(~moved & ~stayed))
            accept_c = moved & ~stayed
        else:
            gen.set_state(r.eval_state)
            lp_ct = candidate.log_prob(prop_t, gen)
            lp_c = lp_ct.cpu().numpy()
            accept_c = (torch.log(u) < lp_ct - lp_b).cpu().numpy()
        accepted += int(accept_ref.sum())
        mismatch += int(np.sum(accept_c != accept_ref.cpu().numpy()))
        gaps.append(logp_gaps(lp_c, lp_ref.cpu().numpy()))
    gaps = np.concatenate(gaps) if gaps else np.array([np.inf])
    return {"proposal_mismatch": proposals,
            "logp_gap_p90": float(np.quantile(gaps, 0.9, method="higher")),
            "accept_mismatch": mismatch,
            "logp_gap_max": float(gaps.max()), "accepted": accepted,
            "evaluations": len(records), "walkers": int(gaps.size)}


class Sampled(NamedTuple):
    """A :class:`Record` on the host, for the check."""
    segment: int
    k: int
    proposal: np.ndarray
    log_prob: np.ndarray
    eval_state: torch.Tensor
    move_state: torch.Tensor
    move_skip: int
    move_state_device: torch.device


def sample_records(records, n: int, seed: int, move_device) -> list:
    """A sample, drawn from the seed, of ``n`` recorded evaluations moved
    to the host (or all of them)."""
    rng = np.random.default_rng(derive(seed, 3))
    pick = sorted(rng.choice(len(records), size=min(n, len(records)),
                             replace=False)) if records else []
    return [Sampled(r.segment, r.k, r.proposal.detach().cpu().numpy(),
                    r.log_prob.detach().cpu().numpy(), r.eval_state,
                    r.move_state, r.move_skip, move_device)
            for r in (records[i] for i in pick)]


# --- one run ----------------------------------------------------------------

def card() -> dict:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not read"
    return {"name": name, "power_limit": limit}


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read: the cell (``plan``), the
    reference's ``campaign`` (from which a roofline works out its
    kernel's shapes), the ensemble's ``walkers``, the synchronized
    window's ``spans``, the profiled sub-window's ``profile`` and the
    window's own numbers (``window``: ``walker_steps_per_s`` and
    ``segment_ms_p95``, read as an untraced run reads them)."""
    plan: Plan | None
    campaign: object
    walkers: int
    spans: dict | None
    profile: dict | None
    device_name: str
    window: dict | None = None


def run(plan: Plan, seed: int, seconds: float, trace: bool, *, t_start,
        device="cuda", log=print, controls=None) -> dict:
    """One run of ``plan``'s cell; returns the result's fields.
    ``controls`` (name -> reference put in the program's place, as
    ``f(campaign, observed, device)``) adds each one's numbers under
    ``out['controls']``: the benchmark's own runs judge the program
    alone."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    t = plan.traffic
    steps, move = int(t["segment_steps"]), t["move"]
    ref = plans.reference_of(t)
    marks = [("interpreter and imports", time.perf_counter())]
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        from mcmctoffitting_tpu_torch.ops.cuda_build import load_library
        load_library()
        marks.append(("kernels", time.perf_counter()))
    # the benchmark's own inputs, made by the reference: not set-up
    own = time.perf_counter()
    camp = ref.campaign(plan.config, t)
    observed = observed_spectra(ref, camp, plan.config["truth"], seed)
    p0 = starting_walkers(plan, camp, seed)
    own = time.perf_counter() - own
    marks.append(("the benchmark's inputs (not set-up)",
                  time.perf_counter()))
    problem = build_program(plan, dev)
    logp = problem.make_log_prob_fn(observed)
    problem.forward                                 # builds the buffers
    marks.append(("program problem", time.perf_counter()))
    move_gen = torch.Generator(dev).manual_seed(derive(seed, 5))
    eval_gen = torch.Generator().manual_seed(derive(seed, 6))
    p0 = torch.as_tensor(p0, device=dev)

    from mcmctoffitting_tpu_torch import sampler
    state = sampler.init_state(p0, logp, generator=move_gen,
                               eval_generator=eval_gen)
    marks.append(("initial log-probs", time.perf_counter()))
    state = run_segments(state, logp, steps, move,
                         n_segments=int(t["warmup_segments"])).state
    marks.append(("warm-up", time.perf_counter()))
    before0 = (state.positions.cpu().numpy(), state.log_probs.cpu().numpy())
    rng = np.random.default_rng(derive(seed, 4))
    record = {0} | set(np.flatnonzero(
        rng.random(100_000) < float(t["record_share"])).tolist())
    recorder = Recorder(logp, move_gen, record)
    setup_s = time.perf_counter() - t_start - own
    prev = t_start
    parts = []
    for name, at in marks:
        parts.append(f"{name} {at - prev:.3f}")
        prev = at
    log("set-up (s): " + ", ".join(parts))

    host0 = host_clocks()
    win = run_segments(state, recorder, steps, move, seconds=seconds,
                       recorder=recorder)
    host1 = host_clocks()
    n_walkers = state.positions.shape[0]
    n_steps = steps * len(win.chains)
    attempted = n_walkers * n_steps
    failed = sum(int(np.sum(~np.all(np.isfinite(pos), axis=-1)
                            | np.isnan(lps))) for pos, lps in win.chains)
    out = {"attempted": attempted, "failed": failed}
    device_name = torch.cuda.get_device_name(0) if cuda else "cpu"
    window = {"walker_steps_per_s": attempted / win.wall_s,
              "segment_ms_p95": (p95(win.segment_ms)
                                 if len(win.segment_ms) > 1 else None)}
    out["window"] = window
    if trace:
        # the spans: every log-prob call and segment between synchronizes
        timed = Recorder(logp, move_gen, (), traced=True)
        swin = run_segments(win.state, timed, steps, move,
                            seconds=min(seconds, SPAN_SECONDS),
                            recorder=timed, sync_each=True)
        spans = {"segment_ms": swin.segment_ms, "logp_ms": timed.logp_ms,
                 "steps": steps * len(swin.chains)}
        profile = (profiled_segments(swin.state, logp, steps, move,
                                     int(t["profile_segments"]))
                   if cuda else None)
        readings = Readings(plan, camp, n_walkers, spans, profile,
                            device_name, window)
        metrics = {}
        for m in plan.per_layer:
            value = plans.metric_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        out["metrics"] = metrics
        if profile is not None:
            out["breakdown"] = profile["breakdown"]
            out["busy_s"], out["window_s"] = (profile["busy_s"],
                                              profile["window_s"])
    else:
        values = dict(window, setup_s=setup_s)
        wanted = {m["name"] for m in plan.end_to_end}
        if "walker_steps_per_device_s" in wanted and cuda:
            # the card's time a step takes, after the window: a profile
            # slows the host that the window's own numbers time
            dev_win = profiled_segments(win.state, logp, steps, move,
                                        DEVICE_SEGMENTS)
            values["walker_steps_per_device_s"] = (
                n_walkers * dev_win["steps"] / dev_win["busy_s"])
        out["metrics"] = {m["name"]: {"value": float(values[m["name"]]),
                                      "unit": m["unit"]}
                          for m in plan.end_to_end
                          if values.get(m["name"]) is not None}
    out["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(dev))
                                if cuda else 0)
    half_n = len(win.segment_ms) // 2
    log(f"window: {len(win.chains)} segments of {steps} steps x "
        f"{n_walkers} walkers in {win.wall_s:.3f} s; set-up "
        f"{setup_s:.3f} s; {len(recorder.records)} evaluations recorded; "
        f"segment ms median {np.median(win.segment_ms):.2f} (first half "
        f"{np.median(win.segment_ms[:half_n] or [0]):.2f}, second "
        f"{np.median(win.segment_ms[half_n:]):.2f}); host in the window: "
        f"process cpu {host1[0] - host0[0]:.2f} s, machine steal "
        f"{host1[1] - host0[1]:.2f} s")

    # the check: the program's state freed, the reference on the device
    chains = win.chains
    sample = sample_records(recorder.records, int(t["check_evaluations"]),
                            seed, move_gen.device)
    del recorder, win, state, logp, problem, p0
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reference = ref.Reference(camp, observed, dev)
    numbers = judge(sample, chains, before0, reference)
    numbers["nonfinite_steps"] = failed
    log(f"check: {numbers['evaluations']} evaluations, "
        f"{numbers['walkers']} walkers, {numbers['proposal_mismatch']} "
        f"proposals not the DE move's, widest gap "
        f"{numbers['logp_gap_max']!r} nats, {numbers['accepted']} moves "
        f"accepted by the reference, in "
        f"{time.perf_counter() - t0:.3f} s")
    out["controls"] = {
        name: judge(sample, chains, before0, reference,
                    candidate=make(camp, observed, dev))
        for name, make in (controls or {}).items()}
    out["numbers"] = numbers
    checks = {name: {"value": numbers[name], "limit": limit}
              for name, limit in plan.limits.items()}
    out["correct"] = bool(numbers["evaluations"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    out["checks"] = checks
    return out


def result_line(plan: Plan, out: dict, info: dict, trace: bool) -> dict:
    """The last line of a run: the result's keys, ``breakdown`` in a
    traced run, and last the numbers compared, each with its limit."""
    device = {"platform": "gpu", "kind": info["name"], "count": plan.chips,
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power_limit": info["power_limit"]}
    if trace and "busy_s" in out:
        device["busy_s"], device["window_s"] = out["busy_s"], out["window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    return result
