"""N local ranks, each a process of its own, joined by torch.distributed.

The counterpart of how the JAX package provisions its processes
(``__graft_entry__.py:34-146``: fresh processes, a free loopback port for
the coordinator, the MCMCTOF_* variables, every rank polled together).
:func:`launch` starts the ranks with ``torch.multiprocessing`` (spawn: a
fresh interpreter each, so the function is sent by its import path and its
arguments and result by pickle), initialises the default process group in
each over ``tcp://127.0.0.1:<free port>`` and returns each rank's result.
If any rank raises or dies, or the deadline passes, every rank still
running is killed and :func:`launch` raises: no rank waits forever in a
collective for a peer that is gone.  A rank whose launcher is gone (killed
without its ``finally``) exits within a second.
"""
from __future__ import annotations

import math
import os
import pickle
import queue as queue_mod
import socket
import threading
import time
import traceback
from typing import Callable, Optional, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp

from . import distributed


def free_port() -> int:
    """A TCP port free on the loopback interface (the rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _exit_with_parent(parent: int) -> None:
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


def _rank_main(fn, args, rank, n_ranks, address, backend, timeout_s,
               parent, results):
    threading.Thread(target=_exit_with_parent, args=(parent,),
                     daemon=True).start()
    os.environ.update({distributed.ENV_COORDINATOR: address,
                       distributed.ENV_NUM_PROCESSES: str(n_ranks),
                       distributed.ENV_PROCESS_ID: str(rank)})
    try:
        distributed.initialize(
            backend=backend,
            **({} if timeout_s is None else {"timeout_s": timeout_s}))
        out = fn(*args)
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, n_ranks: int, args: Sequence = (), *,
           backend: str, timeout_s: Optional[float] = 600.0) -> list:
    """``fn(*args)`` in ``n_ranks`` fresh processes on this machine, rank r
    with torch.distributed initialised (``backend``: 'nccl' for one GPU
    per rank, 'gloo' for the CPU or for ranks sharing a GPU) and the
    MCMCTOF_* variables set; returns the ranks' results in rank order.
    ``fn`` must be importable (a module-level function), its arguments and
    result picklable.  Raises ``RuntimeError`` when a rank fails or the
    ``timeout_s`` deadline passes (None: no deadline; a collective still
    waits at most ``distributed.initialize``'s timeout for its peers),
    after killing every rank."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, tuple(args), rank, n_ranks, address,
                               backend, timeout_s, os.getpid(), results))
             for rank in range(n_ranks)]
    deadline = time.monotonic() + (math.inf if timeout_s is None
                                   else timeout_s)
    out = {}
    try:
        for p in procs:
            p.start()
        # read the queue before joining: a rank blocks on exit until its
        # result has left the pipe
        while len(out) < n_ranks:
            try:
                rank, ok, payload = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)}
                if dead:
                    try:            # a failed rank's traceback, if it sent one
                        rank, ok, payload = results.get(timeout=2.0)
                    except queue_mod.Empty:
                        raise RuntimeError(
                            f"launch: ranks {dead} died (exit codes) before "
                            "returning") from None
                else:
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"launch: the {timeout_s} s deadline passed; "
                            f"ranks returned: {sorted(out)}")
                    continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} failed:\n{payload}")
            out[rank] = pickle.loads(payload)
        for p in procs:
            p.join(min(60.0, max(0.0, deadline - time.monotonic())))
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"launch: rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(n_ranks)]


def dryrun(n_ranks: int = 2, n_walkers: int = 16,
           timeout_s: float = 120.0) -> list:
    """The multi-process path without a GPU: ``n_ranks`` gloo ranks on the
    CPU, each building a small simultFit counts problem and taking one
    sharded DE step (the counterpart of
    ``__graft_entry__.dryrun_multihost``).  Returns each rank's final
    positions and log-probs (numpy), which must be equal."""
    return launch(_dryrun_rank, n_ranks, (n_walkers,), backend="gloo",
                  timeout_s=timeout_s)


def _dryrun_rank(n_walkers: int):
    import numpy as np
    import torch

    from ..models import simult
    from ..sampler import init_state, run_mcmc
    from ..utils import data_io
    from .mesh import make_mesh, make_sharded_logp_batch

    torch.set_num_threads(1)
    mesh = make_mesh("cpu")
    spec = simult.default_spec(n_samples=2048, fine_grid=128,
                               sampling="counts")
    problem = simult.SimultFitProblem(spec, n_runs=2, likelihood="poisson",
                                      device="cpu")
    truth = np.concatenate([simult.GUESS_SHARED, np.full(2, 5.0e4)])
    observed = data_io.synthesize_observed(0, problem, truth)
    logp = make_sharded_logp_batch(problem.make_log_prob_fn(observed), mesh,
                                   by_row=problem.draws_by_row)
    p0 = problem.initial_walkers_from_observed(
        torch.Generator().manual_seed(1), n_walkers, observed)
    state = init_state(p0, logp, generator=torch.Generator().manual_seed(2),
                       eval_generator=torch.Generator().manual_seed(3))
    chain = run_mcmc(state, 1, logp, move="de")
    return (chain.state.positions.numpy(), chain.state.log_probs.numpy())
