"""Device times of small kernels, with the host out of the number.

An event pair around one Python call on an idle card times the host: the
card reaches the first event at once and then waits for the wrapper to
enqueue the kernel, so for a kernel of a few microseconds the interval is
the wrapper's argument checks, its allocation and the launch call.  The
functions here keep the device behind the host instead:

* :func:`graph_ms` captures ``launches`` calls in one CUDA graph and
  replays it back to back; the time per launch is the kernel plus the
  card's own gap between two dependent kernels, which
  :func:`launch_floor_ms` measures with an empty kernel the same way;
* :func:`graphs_in_turns` does the same for several functions, taking them
  in turns, to compare them;
* :func:`queued_ms` enqueues ``launches`` calls behind one more call of
  the same function, for kernels long enough (>= ~0.2 ms) that the host
  runs ahead by itself;
* :func:`enqueue_us` is the host's side: wall clock per call of the
  wrapper, nothing synchronised inside the window;
* :func:`profiler_kernel_ms` reads the kernel durations that
  ``torch.profiler`` (CUPTI) reports, as a cross-check.

Everything here needs a CUDA device; nothing runs at import time.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.cuda_build import check, current_stream_ptr, load_library


def _event_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def graph_ms(fn, launches: int = 100, replays: int = 5,
             rounds: int = 5) -> float:
    """Median device ms per call of ``fn``: one CUDA graph of ``launches``
    calls, replayed ``replays`` times behind an untimed replay that keeps
    the card busy while the host enqueues.  ``fn`` must be capturable: it
    launches on the current stream and does not synchronise."""
    return graphs_in_turns({"fn": fn}, launches, replays, rounds)["fn"]


def graphs_in_turns(fns: dict, launches: int = 100, replays: int = 5,
                    rounds: int = 6) -> dict:
    """name -> median device ms per call, as :func:`graph_ms`: one graph
    per function, captured first, and the graphs then timed in turns
    (forwards and backwards), so that what drifts with the card's clocks
    and temperature falls on all of them alike."""
    graphs = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(launches):
                fn()
        graphs[name].replay()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            graph = graphs[name]

            def run():
                for _ in range(replays):
                    graph.replay()

            graph.replay()
            times[name].append(_event_ms(run) / (replays * launches))
    torch.cuda.synchronize()
    return {name: float(np.median(t)) for name, t in times.items()}


def queued_ms(fn, launches: int = 10, rounds: int = 3) -> float:
    """Median device ms per call of ``fn``, ``launches`` calls enqueued
    behind one untimed call: for kernels that outlast their enqueue."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(launches):
            fn()

    times = []
    for _ in range(rounds):
        fn()
        times.append(_event_ms(run) / launches)
    torch.cuda.synchronize()
    return float(np.median(times))


def enqueue_us(fn, calls: int = 200, rounds: int = 5) -> float:
    """Median host microseconds per call of ``fn`` (wall clock over
    ``calls`` calls, no synchronize inside the window)."""
    fn()
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append(1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return float(np.median(times))


def empty_launch(device: torch.device) -> None:
    """Launch the library's empty kernel (one thread, no work) on the
    current stream of ``device``."""
    check(load_library().lib.mcmctof_empty_kernel(
        device.index, current_stream_ptr(device)), "empty kernel launch")


def launch_floor_ms(device: torch.device, **kw) -> float:
    """Device ms per launch of an empty kernel in a replayed graph: what
    the card takes between two dependent kernels, below which no kernel
    timed by :func:`graph_ms` can fall."""
    return graph_ms(lambda: empty_launch(device), **kw)


def _profiled(fn, calls: int, name_part: str = ""):
    """torch.profiler over ``calls`` eager calls of ``fn`` (after one
    untimed call): (device us of the kernels whose name contains
    ``name_part``, their count, host ms per call in the window)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / calls
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        d_us = getattr(evt, "self_device_time_total", None)
        if d_us is None:
            d_us = getattr(evt, "self_cuda_time_total", 0.0)
        if d_us and evt.device_type.name == "CUDA" and name_part in evt.key:
            total_us += d_us
            count += evt.count
    return total_us, count, host_ms


def profiler_kernel_ms(fn, name_part: str, calls: int = 50) -> float:
    """Mean duration (ms) of the device kernels whose name contains
    ``name_part`` over ``calls`` eager calls of ``fn``, as torch.profiler
    reports them; NaN if it saw none."""
    total_us, count, _ = _profiled(fn, calls, name_part)
    return total_us / 1e3 / count if count else float("nan")


def profiler_call_ms(fn, calls: int = 3) -> tuple:
    """(device ms, host ms) per call of ``fn``: every kernel's duration
    that torch.profiler reports over ``calls`` eager calls, summed (NaN if
    it saw none), and the wall clock of the same window.  The profiler
    slows the host, so the host ms is an upper bound."""
    total_us, count, host_ms = _profiled(fn, calls)
    return (total_us / 1e3 / calls if count else float("nan")), host_ms
