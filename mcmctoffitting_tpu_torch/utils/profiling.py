"""Profiling instrumentation.

Port of ``mcmctoffitting_tpu/utils/profiling.py``, and the port's spans:

* :func:`trace` -- context manager around ``torch.profiler`` (CPU and CUDA
  activities, spans on) writing a Chrome trace into a directory;
* :func:`span` -- a named span around one stage of the hot path (the
  sampler step, the half-update, the log-prob, each forward stage).  Off,
  the default, it is one shared do-nothing context: one global test, no
  allocation, nothing read from the device.  Inside :func:`spans` each
  span records its host interval (``time.perf_counter_ns``) and its
  enclosing span, and under ``torch.profiler`` it also opens a
  ``record_function`` of its name, so that the profiler's device
  operations and idle gaps can be put down to it.  A span never reads a
  tensor and never synchronizes.  Names are fixed strings that start
  with ``mcmctof.``; spans nest on one thread.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block, CPU and CUDA activities, with the port's spans
    on, and write its Chrome trace to ``logdir/trace.json``:
    ``with trace('dir'): run_step()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof, spans():
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


class SpanRecord(NamedTuple):
    """One closed span: its name, the name of the span that enclosed it
    (None at the top), its host interval and its own time (the interval
    less its children's), in ns of ``time.perf_counter_ns``."""

    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int
    self_ns: int


class _Off:
    """The span of spans off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recorder: Optional["SpanRecorder"] = None


def span(name: str):
    """The context of one span named ``name`` (``mcmctof.<stage>``): the
    shared do-nothing context unless :func:`spans` is on."""
    if _recorder is None:
        return _OFF
    return _Span(_recorder, name)


class _Span:
    __slots__ = ("rec", "name", "start", "child", "label")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.label = None
        if torch.autograd._profiler_enabled():
            self.label = torch.profiler.record_function(self.name)
            self.label.__enter__()
        self.child = 0
        self.rec.open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        open_ = self.rec.open
        open_.pop()
        total = end - self.start
        parent = open_[-1] if open_ else None
        if parent is not None:
            parent.child += total
        self.rec.records.append(SpanRecord(
            self.name, None if parent is None else parent.name, self.start,
            end, total - self.child))
        if self.label is not None:
            self.label.__exit__(*exc)
        return False


class SpanRecorder:
    """The spans closed while :func:`spans` was on, in closing order."""

    def __init__(self):
        self.records: list[SpanRecord] = []
        self.open: list[_Span] = []

    def summary(self) -> dict:
        """Per span name: ``calls``, ``total_ms`` (host) and ``self_ms``
        (the total less the spans directly inside), summed over its
        calls, and ``parent`` (the enclosing span of its first call)."""
        out = {}
        for r in self.records:
            s = out.setdefault(r.name, {"calls": 0, "total_ms": 0.0,
                                        "self_ms": 0.0, "parent": r.parent})
            s["calls"] += 1
            s["total_ms"] += 1e-6 * (r.end_ns - r.start_ns)
            s["self_ms"] += 1e-6 * r.self_ns
        return out


@contextlib.contextmanager
def spans():
    """Turn the spans on for the block: ``with spans() as rec: ...``,
    then ``rec.records`` and ``rec.summary()``.  Nested, the inner block
    records apart and the outer one resumes after it."""
    global _recorder
    rec, outer = SpanRecorder(), _recorder
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = outer
