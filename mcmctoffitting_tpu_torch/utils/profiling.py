"""Profiling and throughput instrumentation.

Port of ``mcmctoffitting_tpu/utils/profiling.py``:

* :func:`trace` -- context manager around ``torch.profiler`` (CPU and CUDA
  activities) writing a Chrome trace into a directory;
* :class:`Throughput` -- running walker-steps/sec meter for sampler loops;
* :func:`time_fn` -- first call vs steady state of a callable (the JAX
  package's ``time_jitted``: there the first call compiles, here it builds
  the kernels a path launches and warms the caches).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block, CPU and CUDA activities, and write its Chrome
    trace to ``logdir/trace.json``: ``with trace('dir'): run_step()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@dataclasses.dataclass
class Throughput:
    """Walker-steps/sec meter, reported incrementally like the drivers'
    per-step progress prints (``tests/simultFit.py:736,780``)."""

    n_walkers: int
    t0: float = dataclasses.field(default_factory=time.perf_counter)
    steps: int = 0

    def update(self, n_steps: int) -> float:
        self.steps += n_steps
        return self.rate

    @property
    def rate(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.steps * self.n_walkers / dt if dt > 0 else 0.0


def _synchronize(out) -> None:
    """Wait for the CUDA devices that hold a tensor of ``out`` (a tensor,
    or tuples, lists and dicts of them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _synchronize(v)


def time_fn(fn: Callable, *args, n_iters: int = 3) -> dict:
    """Time a callable: the first call vs the mean of ``n_iters`` more,
    each timed to the end of the device work its CUDA outputs wait for."""
    t0 = time.perf_counter()
    out = fn(*args)
    _synchronize(out)
    first_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(n_iters):
        out = fn(*args)
    _synchronize(out)
    steady_s = (time.perf_counter() - t0) / n_iters
    return {"first_s": first_s, "steady_s": steady_s}
