"""Multi-process orchestration: the process-group bring-up and failure policy.

Counterpart of zigz_tpu/parallel/multihost.py.  JAX drives N devices from
one process and lets its partitioner insert the collectives;
``torch.distributed`` runs one process per device and every collective is
written out (parallel/dist.py).  The design that makes the two fit:

* every rank calls :func:`initialize` with its rank, the world size and one
  rendezvous (a file every rank can reach, or a store), and gets the same
  :class:`TraceGroup` over all ranks;
* host-side control flow (VM execution, transcript, challenge schedule) is
  pure and deterministic given (program, input, seed), so every rank repeats
  it and holds every host array whole: a shard is never scattered, each rank
  cuts its own slice out of the array it already has, and only reductions
  cross ranks.  Every rank ends with the same proof; rank 0 is the
  coordinator and the one that writes it out;
* failure policy is fail-fast + deterministic restart: a lost rank aborts the
  job (parallel/launch.py kills the survivors by their PIDs) and the whole
  job is relaunched; same seed, same proof bytes (parallel/recovery.py).

A group is an explicit object handed down as ``group=``: no module reads a
global default group, and ``group=None`` is the unsharded path.  The
transport is chosen by name, never probed: ``"nccl"`` hands device tensors
to the collectives as they are; ``"gloo"`` carries CPU tensors as they are
and stages tensors that lie on a card through the host, which is how
several ranks can share one card.  A backend that cannot initialise raises.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional

import torch

from ..device import resolve_device

__all__ = [
    "TraceGroup",
    "initialize",
    "shutdown",
    "single_process_group",
    "global_trace_group",
    "is_coordinator",
    "sync_hosts",
    "BACKENDS",
]

BACKENDS = ("gloo", "nccl")

# gloo's own default lets the survivor of a dead peer wait for half an hour.
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class TraceGroup:
    """The ranks that share one hypercube ("trace") axis.

    ``pg`` is the ``torch.distributed`` process group, or None for a group
    of one that a caller built without :func:`initialize` (its collectives
    are identities)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    pg: object = None

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}: use one of {BACKENDS}")
        if self.world_size < 1 or self.world_size & (self.world_size - 1):
            raise ValueError(f"world size {self.world_size} is not a power of two")
        if not 0 <= self.rank < self.world_size:
            raise ValueError(f"rank {self.rank} outside a world of {self.world_size}")
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not {self.device}")
        if self.pg is None and self.world_size != 1:
            raise ValueError("a group of more than one rank needs a process group: call initialize()")


_GROUP: Optional[TraceGroup] = None


def initialize(backend: str, rank: int, world_size: int, *, device,
               rendezvous_file: Optional[str] = None, store=None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> TraceGroup:
    """``torch.distributed`` bring-up (idempotent): every rank of the job
    calls this once and gets the group over all of them.

    The rendezvous is a file (``FileStore``; parallel workers on one host
    cannot race for a TCP port) or a ``torch.distributed`` store.  A second
    call returns the group of the first when its arguments agree, and raises
    when they do not."""
    global _GROUP
    import torch.distributed as dist

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: use one of {BACKENDS}")
    dev = resolve_device(device)
    if _GROUP is not None:
        asked = (backend, rank, world_size, dev)
        have = (_GROUP.backend, _GROUP.rank, _GROUP.world_size, _GROUP.device)
        if asked != have:
            raise RuntimeError(f"already initialised as {have}, asked for {asked}")
        return _GROUP
    if (rendezvous_file is None) == (store is None):
        raise ValueError("give exactly one of rendezvous_file and store")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    if store is None:
        store = dist.FileStore(rendezvous_file, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _GROUP = TraceGroup(rank=rank, world_size=world_size, device=dev, backend=backend,
                        pg=dist.group.WORLD)
    return _GROUP


def shutdown() -> None:
    """Leave the process group (a no-op before :func:`initialize`)."""
    global _GROUP
    import torch.distributed as dist

    if _GROUP is not None:
        dist.destroy_process_group()
        _GROUP = None


def single_process_group(device, backend: str = "gloo") -> TraceGroup:
    """A group of one without ``torch.distributed``: what a single process
    passes where it wants the group paths and has no peers."""
    return TraceGroup(rank=0, world_size=1, device=resolve_device(device), backend=backend)


def global_trace_group() -> TraceGroup:
    """The group :func:`initialize` made, over ALL ranks of the job."""
    if _GROUP is None:
        raise RuntimeError("initialize() has not been called in this process")
    return _GROUP


def is_coordinator(group: Optional[TraceGroup] = None) -> bool:
    group = group if group is not None else _GROUP
    return group is None or group.rank == 0


def sync_hosts(group: TraceGroup) -> None:
    """Barrier over the group's ranks."""
    import torch.distributed as dist

    if group.pg is None:
        return
    # An all_reduce of one value: gloo's barrier() would pick a device by
    # the default group's rank, which is wrong where ranks share a card.
    token = torch.zeros(1, dtype=torch.int64,
                        device=group.device if group.backend == "nccl" else "cpu")
    dist.all_reduce(token, group=group.pg)
    if token.device.type == "cuda":
        torch.cuda.synchronize(token.device)
