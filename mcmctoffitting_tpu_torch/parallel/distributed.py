"""Multi-process and multi-host execution: torch.distributed in place of
the reference's MPI pool.

Port of ``mcmctoffitting_tpu/parallel/distributed.py``.  The reference
scales past one node with ``emcee.utils.MPIPool``, a master/worker task
farm (``tests/mpiTOFmodel.py:187-201``, ``tests/simultFit.py:688-706``).
Here every process runs the same program on its own device: the walkers
are replicated, each rank evaluates its shard of every half-ensemble, and
one all-gather of log-probs per half-step is the only traffic
(``parallel/mesh.py``).

Environment variables (arguments take priority), the JAX package's names:

  MCMCTOF_COORDINATOR   host:port of rank 0 (the TCP rendezvous)
  MCMCTOF_NUM_PROCESSES total process count
  MCMCTOF_PROCESS_ID    this process's rank

torch.distributed discovers none of them: on several hosts set all three
on every process (``parallel/launch.py`` sets them for local ranks).  The
backend is NCCL for CUDA devices and gloo for the CPU; NCCL takes one GPU
per rank.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import (WALKER_AXIS, WalkerMesh, make_mesh, map_arrays,
                   shard_size)

ENV_COORDINATOR = "MCMCTOF_COORDINATOR"
ENV_NUM_PROCESSES = "MCMCTOF_NUM_PROCESSES"
ENV_PROCESS_ID = "MCMCTOF_PROCESS_ID"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda",
               backend: Optional[str] = None,
               timeout_s: float = 1800.0) -> None:
    """Join this process into the multi-process runtime: the default
    process group over ``tcp://<coordinator_address>``.

    Arguments default to the MCMCTOF_* variables; all three are required.
    ``backend`` defaults by ``device``: 'nccl' for a CUDA device, 'gloo'
    for the CPU; a failure of either raises, with no retry on the other.
    (Ranks that share one GPU must pass ``backend='gloo'``: NCCL refuses
    two ranks on one device.)  ``timeout_s`` bounds the rendezvous and
    every collective.
    """
    env = os.environ
    coordinator_address = coordinator_address or env.get(ENV_COORDINATOR)
    if num_processes is None and ENV_NUM_PROCESSES in env:
        num_processes = int(env[ENV_NUM_PROCESSES])
    if process_id is None and ENV_PROCESS_ID in env:
        process_id = int(env[ENV_PROCESS_ID])
    missing = [name for name, v in ((ENV_COORDINATOR, coordinator_address),
                                    (ENV_NUM_PROCESSES, num_processes),
                                    (ENV_PROCESS_ID, process_id))
               if v is None]
    if missing:
        raise ValueError(f"initialize: set {', '.join(missing)} (or pass "
                         "the arguments): torch.distributed discovers none")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def global_mesh(axis_name: str = WALKER_AXIS, devices=None) -> WalkerMesh:
    """The walker mesh over every process of the runtime (this process
    alone before :func:`initialize`); ``devices`` as for
    :func:`mesh.make_mesh`."""
    return make_mesh(devices, axis_name)


def make_global_array(x, mesh: WalkerMesh, spec: Optional[str] = None):
    """Host data, the same on every process, as this rank's tensor on its
    device: all of it (``spec`` None: replicated), or with ``spec`` the
    mesh's axis name this rank's rows of axis 0, [r n/N, (r + 1) n/N)."""
    x = torch.as_tensor(x)
    if spec is None:
        return x.to(mesh.device)
    if spec != mesh.axis_name:
        raise ValueError(f"make_global_array: unknown axis {spec!r} (the "
                         f"mesh's is {mesh.axis_name!r})")
    m = shard_size(x.shape[0], mesh, "rows")
    return x[mesh.rank * m:(mesh.rank + 1) * m].to(mesh.device)


def replicate_global(tree, mesh: WalkerMesh):
    """Tensors and arrays of a (nested) tuple, list or dict, the same on
    every process, placed on this rank's device (no communication)."""
    return map_arrays(lambda x: make_global_array(x, mesh), tree)


def shard_walkers(x, mesh: WalkerMesh, axis_name: str = WALKER_AXIS):
    """This rank's shard of axis 0 (walkers) of host data."""
    return make_global_array(x, mesh, axis_name)
