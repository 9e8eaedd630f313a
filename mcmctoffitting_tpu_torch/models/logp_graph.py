"""The counts log-prob as one CUDA graph replay.

On the card a counts evaluation of ``JointFitProblem.log_prob`` enqueues
about a hundred operations from Python: the prior, the rate kernel, K1
on the cells (and on oneBD the background), the moments, the A
contraction, the lattice, K2, the shape, the likelihood and its NaN
guard, each a few microseconds of device time.  The host then sets the
pace of a fit.  Here each evaluation is one replay of a CUDA graph of
the whole log-prob.

Which evaluations (:func:`graphable`): counts, on a CUDA tensor that
needs no gradient.  The rest runs eagerly: mc (its per-evaluation device
generator, ``ops/pdfs.py::device_generator``, has no seed a replay could
refill), 'expected', the CPU and gradient calls.

One graph per key (:func:`graph_key`): the thetas' shape, dtype and
device, ``walker_offset`` and ``walker_blocks`` (K1's counters depend on
them) and the observed tensors, at most ``MAX_GRAPHS`` a problem, the
least recently used dropped first.  The first call of a key runs
eagerly with the host generator; it also builds what the forward builds
at its first call (K2's tables).  The second call captures -- one
warm-up and the capture on a side stream, with K1 reading its seed words
from a :class:`~..ops.poisson.DeviceSeeds` of the graph's own, so that
neither draws from the host generator -- and replays; every later call
replays.  A shape evaluated once (an ensemble's initial log-probs) is
never captured.  A capture that fails raises.

A replay copies the thetas into the graph's input, refills its seed
words from the host generator (``seed_words``, as many as the eager
evaluation draws, in its order, by stream-ordered ``fill_``), replays,
and returns a clone of the graph's output: a later replay overwrites
the output, and the sampler keeps the log-probs it was given.  The host
generator then stands where the eager path leaves it after any sequence
of calls, and the bits are the eager path's.

``log_prob_graph.captures`` and ``log_prob_graph.replays`` count
captures and replays; each replay runs in the span ``mcmctof.logp_graph``
(inside ``mcmctof.logp``).
"""
from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from ..ops.poisson import DeviceSeeds
from ..utils.profiling import span

MAX_GRAPHS = 4


def graphable(spec, thetas) -> bool:
    """Whether an evaluation of ``thetas`` under ``spec`` is replayed from
    a graph: counts, on a CUDA tensor that needs no gradient."""
    return (spec.sampling == "counts" and thetas.is_cuda
            and not thetas.requires_grad)


def graph_key(thetas, walker_offset, walker_blocks, observed) -> tuple:
    """What a graph is captured for: the thetas' shape, dtype and device,
    K1's counter layout, and the observed tensors (by identity; the graph
    holds them)."""
    return (tuple(thetas.shape), thetas.dtype, thetas.device, walker_offset,
            None if walker_blocks is None else tuple(walker_blocks),
            id(observed.counts), id(observed.mask))


class Captured(NamedTuple):
    """One captured evaluation: its graph, its input and output tensors,
    its seed words and how many rows it reads, and the observed runs it
    reads."""
    graph: object
    thetas: torch.Tensor
    out: torch.Tensor
    seeds: DeviceSeeds
    n_seeds: int
    observed: object

    def replay(self, thetas, generator) -> torch.Tensor:
        with span("mcmctof.logp_graph"):
            self.thetas.copy_(thetas)
            self.seeds.refill(generator, self.n_seeds)
            self.graph.replay()
            log_prob_graph.replays += 1
            return self.out.clone()


class GraphCache:
    """A problem's graphs by key, at most ``MAX_GRAPHS``, the least
    recently used dropped first: a key seen once maps to None, a captured
    one to its :class:`Captured`."""

    def __init__(self):
        self.entries: collections.OrderedDict = collections.OrderedDict()

    def put(self, key, value) -> None:
        self.entries[key] = value
        self.entries.move_to_end(key)
        while len(self.entries) > MAX_GRAPHS:
            self.entries.popitem(last=False)


def capture(eager, thetas, observed, rows: dict) -> Captured:
    """Capture ``eager(thetas, seeds, observed, **rows)`` in a CUDA graph:
    one warm-up, then the capture, both on a side stream and drawing their
    seed words from the graph's :class:`DeviceSeeds`."""
    dev = thetas.device
    with torch.cuda.device(dev):
        static = torch.empty_like(thetas,
                                  memory_format=torch.contiguous_format)
        static.copy_(thetas)
        seeds = DeviceSeeds(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            eager(static, seeds, observed, **rows)
        torch.cuda.current_stream(dev).wait_stream(side)
        seeds.taken = 0
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            out = eager(static, seeds, observed, **rows)
    log_prob_graph.captures += 1
    return Captured(graph, static, out, seeds, seeds.taken, observed)


def log_prob_graph(problem, thetas, generator, observed, *,
                   walker_offset: int = 0, walker_blocks=None):
    """``problem``'s log-prob of ``thetas`` from its graph for the key:
    eager at the key's first call, captured at its second, replayed from
    then on (the module's docstring)."""
    cache = problem.logp_graphs
    rows = {"walker_offset": walker_offset, "walker_blocks": walker_blocks}
    key = graph_key(thetas, walker_offset, walker_blocks, observed)
    if key not in cache.entries:
        cache.put(key, None)
        return problem.log_prob_eager(thetas, generator, observed, **rows)
    entry = cache.entries[key]
    if entry is None:
        entry = capture(problem.log_prob_eager, thetas, observed, rows)
    cache.put(key, entry)
    return entry.replay(thetas, generator)


log_prob_graph.captures = 0
log_prob_graph.replays = 0
