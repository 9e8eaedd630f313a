"""Multi-GPU execution: walker-axis sharding over torch.distributed ranks.

Port of ``mcmctoffitting_tpu/parallel/mesh.py``, which replaces the
reference's process pools (emcee ``threads=N``, ``emcee.utils.MPIPool``;
``tests/simultFit.py:688-718``, ``tests/mpiTOFmodel.py:187-201``) with a
device mesh.  Here every rank is one process with one device.  Every rank
holds the whole ensemble, replicated, and runs the same moves; only the
batched log-probability evaluation is split: rank r evaluates rows
[r n/N, (r + 1) n/N) of the n walkers of a half-ensemble, and one
all-gather of the (n/N,) log-probs gives every rank all n.  That gather is
the one collective per half-step.

The contract sharding keeps:

A. **Bit for bit against the unsharded run** where the log-prob is
   deterministic ('expected', the analytic shifting Gaussian) or draws all
   its random numbers from kernel K1 ('counts', and oneBD's Poisson
   background): every rank draws the same seed words from the replicated
   host ``eval_generator``, and K1 numbers each draw by its element's
   index in the unsharded batch (``walker_offset``; a shard of every rung
   of a tempered ensemble with ``walker_blocks``), so a shard draws exactly
   the unsharded run's rows.  The forward's matrix products (the A
   contraction, the timing convolutions) run in products of a fixed row
   count (``ops/rowwise``): cuBLAS picks its algorithm by the row count,
   and ``rint`` turned a grid's last-bit differences into whole draws
   (``perf/shard_bits.py``).  So the sharded and unsharded chains are
   equal bit for bit on the CPU and, as measured on an H100, on the card;
   the card's check holds the log-probs of the same thetas and a short
   chain to the JAX package's own tolerances (``tests/test_sharding.py``:
   positions rtol 2e-5, log-probs rtol 2e-4) and reports whether they came
   out bitwise.
B. **Per-shard streams** for log-probs that draw from a device generator
   (mc on the table or on the ODE transport, the beam draw): each
   evaluation, every rank draws the N shard seeds from the replicated
   ``eval_generator`` (so the host generators stay equal on every rank)
   and evaluates its shard with a host generator seeded by its own seed
   (:func:`shard_seeds`).  Such a chain equals bit for bit one process that
   evaluates the same N shards in turn with the same seeds; against the
   unsharded run it agrees in distribution only, the relaxation the JAX
   package documents for its per-tile TPU draws
   (``mcmctoffitting_tpu/ops/poisson.py:50-55``).
C. **The moves stay replicated**: each rank's move generator is seeded the
   same on its own device and sees the same gathered log-probs, so every
   rank holds the same positions at every step.

Within a shard, ``chunk`` evaluates the rows in chunks (a memory cap, as
``-chunkWalkers``): under A each chunk starts from the same generator state
at its own rows, so chunking changes no number; under B the chunks draw
their seeds from the shard's generator in turn.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.forward import resolve_device

WALKER_AXIS = "walkers"

DeviceSpec = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class WalkerMesh:
    """The ranks the walker axis is sharded over: the process group (None
    when torch.distributed is not initialised: this process alone), its
    size, this process's rank and this rank's device."""

    group: Optional[dist.ProcessGroup]
    size: int
    rank: int
    device: torch.device
    axis_name: str = WALKER_AXIS


def make_mesh(devices: Union[None, DeviceSpec, Sequence[DeviceSpec]] = None,
              axis_name: str = WALKER_AXIS) -> WalkerMesh:
    """The 1-D walker mesh over the ranks of the default process group,
    or this process alone when torch.distributed is not initialised.
    ``devices``: one device per rank, indexed by rank; one device that
    every rank takes (``'cpu'``, or ``'cuda:0'`` for ranks sharing one
    card); or None, ``cuda:(rank mod the local GPU count)``.  A CUDA
    device without a GPU raises."""
    group, size, rank = None, 1, 0
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        size, rank = dist.get_world_size(group), dist.get_rank(group)
    if devices is None:
        device = resolve_device(torch.device(
            "cuda", rank % max(1, torch.cuda.device_count())))
    elif isinstance(devices, (str, torch.device)):
        device = resolve_device(devices)
    else:
        devices = list(devices)
        if len(devices) != size:
            raise ValueError(f"make_mesh: {len(devices)} devices for "
                             f"{size} ranks")
        device = resolve_device(devices[rank])
    return WalkerMesh(group, size, rank, device, axis_name)


def all_gather_rows(x: torch.Tensor, mesh: WalkerMesh) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated along axis
    0 in rank order, on every rank."""
    if mesh.group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def shard_seeds(generator: torch.Generator, n_shards: int) -> list[int]:
    """Contract B's seeds of one evaluation: ``n_shards`` 62-bit seeds
    drawn from the replicated host ``generator`` (every rank draws all of
    them, so the generators stay equal); shard r is evaluated with
    ``torch.Generator().manual_seed(seeds[r])``."""
    return torch.randint(0, 1 << 62, (n_shards,), generator=generator,
                         dtype=torch.int64).tolist()


def shard_size(n: int, mesh: WalkerMesh, what: str) -> int:
    """n / N, the rows of one rank; ``ValueError`` unless N divides n."""
    if n % mesh.size:
        raise ValueError(
            f"{what} {n} not divisible by mesh size {mesh.size}; choose "
            f"walkers as a multiple of 2*{mesh.size}")
    return n // mesh.size


def _shard_generator(generator: torch.Generator, mesh: WalkerMesh):
    return torch.Generator().manual_seed(
        shard_seeds(generator, mesh.size)[mesh.rank])


def make_sharded_logp_batch(log_prob_fn: Callable, mesh: WalkerMesh, *,
                            stochastic: bool = True,
                            chunk: Optional[int] = None,
                            by_row: bool = False):
    """Batched log-prob evaluator with the walker axis sharded over the
    mesh: ``(thetas (n, D) replicated, eval_generator) -> (n,)`` on every
    rank, the signature ``sampler.run_mcmc`` takes, so sharding drops in
    unchanged.

    ``log_prob_fn``: ``(thetas, generator) -> (rows,)`` (``stochastic``),
    or ``thetas -> (rows,)``.  ``by_row``: every draw of ``log_prob_fn`` is
    K1's and it takes ``walker_offset`` (the flagship problems'
    ``make_log_prob_fn``, ``JointFitProblem.draws_by_row``): contract A.
    Otherwise a stochastic ``log_prob_fn`` gets its shard's stream:
    contract B.  ``chunk``: evaluate the shard in chunks of this many
    walkers.  Raises ``ValueError`` when the mesh size does not divide n.
    """

    def chunks(rows):
        step = chunk or rows.shape[0]
        return [(i, rows[i:i + step]) for i in range(0, rows.shape[0], step)]

    def local(rows, generator, first):
        if not stochastic:
            return torch.cat([log_prob_fn(c) for _, c in chunks(rows)])
        if by_row:
            state = generator.get_state()
            out = []
            for i, c in chunks(rows):
                generator.set_state(state)
                out.append(log_prob_fn(c, generator, walker_offset=first + i))
            return torch.cat(out)
        gen = _shard_generator(generator, mesh)
        return torch.cat([log_prob_fn(c, gen) for _, c in chunks(rows)])

    def sharded(thetas: torch.Tensor, generator: torch.Generator):
        m = shard_size(thetas.shape[0], mesh, "walker half-ensemble")
        first = mesh.rank * m
        out = local(thetas[first:first + m], generator, first)
        return all_gather_rows(out.to(torch.float32), mesh)

    return sharded


def make_sharded_pt_batch(fn: Callable, mesh: WalkerMesh, *, n_temps: int,
                          stochastic: bool = True, by_row: bool = False):
    """(T x n)-batched evaluator for the PT sampler, the walker axis of
    every rung sharded over the mesh: ``sample_pt``'s ``loglike_batch=`` /
    ``logprior_batch=`` hooks, which take the (T, n) walkers flattened
    rung-major, ``(thetas (T n, D), eval_generator) -> (T n,)``.

    The temperature ladder stays replicated (every rung takes part in
    each exchange sweep); rank r evaluates walkers [r n/N, (r + 1) n/N) of
    every rung in one call, ``fn`` of (T n/N, D), and one all-gather
    returns every rung's n values.  ``fn`` as ``log_prob_fn`` of
    :func:`make_sharded_logp_batch`; with ``by_row`` it also takes
    ``walker_blocks`` (n/N walkers of each n), so K1 draws the unsharded
    rows: contract A.
    """

    def sharded(thetas: torch.Tensor, generator: torch.Generator):
        if thetas.shape[0] % n_temps:
            raise ValueError(f"{thetas.shape[0]} walkers are not {n_temps} "
                             "rungs")
        n = thetas.shape[0] // n_temps
        m = shard_size(n, mesh, "per-rung walker half-ensemble")
        first = mesh.rank * m
        rows = thetas.reshape(n_temps, n, -1)[:, first:first + m]
        rows = rows.reshape(n_temps * m, -1)
        if not stochastic:
            out = fn(rows)
        elif by_row:
            out = fn(rows, generator, walker_offset=first,
                     walker_blocks=(m, n))
        else:
            out = fn(rows, _shard_generator(generator, mesh))
        gathered = all_gather_rows(
            out.to(torch.float32).reshape(1, n_temps, m), mesh)
        return gathered.permute(1, 0, 2).reshape(n_temps * n)

    return sharded


def map_arrays(fn: Callable, tree):
    """``fn`` applied to every tensor and numpy array of a (nested) tuple,
    NamedTuple, list or dict; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_arrays(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_arrays(fn, v) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def replicate(tree, mesh: WalkerMesh):
    """Tensors and arrays of a (nested) tuple, list or dict, copied to this
    rank's device with rank 0's values on every rank (one broadcast each):
    fully replicated."""
    def leaf(x):
        x = torch.as_tensor(x).to(mesh.device, copy=True).contiguous()
        if mesh.group is not None:
            dist.broadcast(x, 0, group=mesh.group)
        return x

    return map_arrays(leaf, tree)
