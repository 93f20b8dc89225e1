"""Multi-host fleet bootstrap, ported from ``repro/launch/fleet.py``:
``torch.distributed`` + topology-derived configs.

Every process runs the same command:

  python -m repro_torch.launch.train --arch ... --fleet

and this module turns scheduler-provided environment variables into the
process group plus the host-sharded ``DataConfig``.  Env contract (the
reference's; SLURM variables are mapped):

  REPRO_COORDINATOR   host:port of process 0   (or SLURM_LAUNCH_NODE_IPADDR)
  REPRO_NUM_PROCESSES total process count      (or SLURM_NTASKS)
  REPRO_PROCESS_ID    this process's index     (or SLURM_PROCID)

Each process drives one card: NCCL is the backend and the process binds
``cuda:<local index>`` (``LOCAL_RANK`` or ``SLURM_LOCALID``, else the
process id, modulo the cards it sees).  Gloo runs only where the caller asks
for it (``backend="gloo"``): a CPU job, or several processes sharing one
card, which NCCL refuses.  A process that finds no card does not fall back
to it.

Elastic restarts re-enter through the same path: every process
re-initialises with the new topology and the trainer resumes from the latest
committed checkpoint with a re-derived ``DataConfig`` (see
``core.faults.elastic_plan``) — the checkpoint holds full arrays, so no
conversion step exists.
"""
from __future__ import annotations

import dataclasses
import os

from ..data.pipeline import DataConfig


@dataclasses.dataclass(frozen=True)
class FleetTopology:
    coordinator: str
    num_processes: int
    process_id: int

    @property
    def is_multihost(self) -> bool:
        return self.num_processes > 1


def topology_from_env(env: dict | None = None) -> FleetTopology:
    """Read the fleet topology from the scheduler environment."""
    e = env if env is not None else os.environ
    coord = e.get("REPRO_COORDINATOR") or e.get("SLURM_LAUNCH_NODE_IPADDR", "localhost:12355")
    if ":" not in coord:
        coord = f"{coord}:12355"
    n = int(e.get("REPRO_NUM_PROCESSES") or e.get("SLURM_NTASKS") or 1)
    pid = int(e.get("REPRO_PROCESS_ID") or e.get("SLURM_PROCID") or 0)
    if not (0 <= pid < n):
        raise ValueError(f"process id {pid} out of range for {n} processes")
    return FleetTopology(coord, n, pid)


def local_device_index(topo: FleetTopology, env: dict | None = None) -> int:
    """The card this process drives: its local rank on the host, modulo the cards it sees."""
    import torch

    e = env if env is not None else os.environ
    local = int(e.get("LOCAL_RANK") or e.get("SLURM_LOCALID") or topo.process_id)
    return local % max(torch.cuda.device_count(), 1)


_ROUTED: dict = {}  # dispatch key -> the torch.library registration that routes its all-gather


def route_all_gather_through_c10d(dispatch_key: str = "CUDA") -> None:
    """Run the functional all-gather (``_c10d_functional::all_gather_into_tensor``,
    what DTensor's redistributions issue) through ``dist.all_gather_into_tensor``
    for tensors of ``dispatch_key`` (``"CPU"``: the CPU tests' gloo jobs run
    the same route).

    On torch 2.11 a gloo group's functional all-gather of CUDA tensors kills the
    process (SIGSEGV) while the c10d call, its other functional collectives and
    DeviceMesh all work on them: gloo stages CUDA tensors through host memory
    either way, so this changes the transport's entry point, not what is
    computed or where.  The call is synchronous (gloo's are), so the op's
    ``wait_tensor`` finds nothing to wait for.
    """
    if dispatch_key in _ROUTED:
        return
    import torch
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather(input, group_size, group_name):
        out = input.new_empty((input.shape[0] * group_size, *input.shape[1:]))
        dist.all_gather_into_tensor(out, input.contiguous(), group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather, dispatch_key)
    _ROUTED[dispatch_key] = lib


def initialize(topology: FleetTopology | None = None, *, backend: str = "nccl") -> FleetTopology:
    """Initialise the default process group for a multi-process job (no-op
    with one process, as the reference's).

    ``backend="nccl"`` (the default) binds ``cuda:<local index>`` first and
    raises where torch finds no card; ``"gloo"`` is the caller's choice for a
    CPU job or for processes that share one card (CUDA tensors then take
    :func:`route_all_gather_through_c10d`).
    """
    topo = topology or topology_from_env()
    if not topo.is_multihost:
        return topo
    import torch
    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device and torch finds none; pass backend='gloo' (--device cpu) "
                               "to run the group on the CPU")
        torch.cuda.set_device(local_device_index(topo))
    elif torch.cuda.is_available():
        route_all_gather_through_c10d("CUDA")
    dist.init_process_group(backend, init_method=f"tcp://{topo.coordinator}", world_size=topo.num_processes,
                            rank=topo.process_id)
    return topo


def fleet_data_config(base: DataConfig, topo: FleetTopology) -> DataConfig:
    """Host-shard the data pipeline to this process (stateless resume/elastic)."""
    if base.global_batch % topo.num_processes != 0:
        raise ValueError(
            f"global_batch={base.global_batch} not divisible by "
            f"{topo.num_processes} hosts (see core.faults.elastic_plan)"
        )
    return dataclasses.replace(base, host_index=topo.process_id, host_count=topo.num_processes)
