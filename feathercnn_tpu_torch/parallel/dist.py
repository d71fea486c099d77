"""Multi-process bring-up and the collectives the sharded engines use.

Counterpart of ``feathercnn_tpu/parallel/dist.py``.  The reference is
single-controller: one process drives every device and GSPMD inserts the
collectives.  The port runs one process per rank on ``torch.distributed``
and calls each collective itself, through the helpers below.

``maybe_initialize_distributed`` reads the same env triple as the
reference, so the serve CLI and the spawner of ``parallel/launch.py`` start
single- or multi-process alike:

    FEATHERCNN_COORDINATOR=tcp://host:port   enables distributed init
    FEATHERCNN_NUM_PROCESSES=N
    FEATHERCNN_PROCESS_ID=i

The backend is explicit: NCCL when each rank owns a GPU, gloo on the CPU
and for ranks that share one GPU (NCCL refuses two ranks on one device).
Nothing switches backend after a failure.  Under gloo a CUDA tensor goes
through host memory, in :func:`_staged` alone.  Every process group gets a
``timeout``, so a collective that one rank skips fails instead of hanging.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["maybe_initialize_distributed", "world", "DEFAULT_TIMEOUT",
           "group_timeout", "all_gather", "all_reduce", "reduce_scatter",
           "broadcast", "start_exchange"]

# A collective that does not complete within this fails (gloo and NCCL
# both honour the process group's timeout).
DEFAULT_TIMEOUT = datetime.timedelta(seconds=120)
# the timeout the default group was given here; the mesh's groups take it
_timeout = DEFAULT_TIMEOUT


def coordinator_url(address: str) -> str:
    """``host:port`` or ``tcp://host:port`` as an ``init_method`` URL."""
    return address if "://" in address else f"tcp://{address}"


def maybe_initialize_distributed(backend: Optional[str] = None,
                                 timeout: Optional[datetime.timedelta] = None
                                 ) -> bool:
    """Join the process group the FEATHERCNN_* env triple names.  Returns
    True when running distributed, False when the triple is not set.
    Idempotent.  ``backend`` defaults to NCCL where CUDA is available, else
    gloo (ranks that share one GPU must ask for gloo); under NCCL the rank
    takes CUDA device ``rank % count``."""
    coord = os.environ.get("FEATHERCNN_COORDINATOR")
    if not coord:
        return False
    if dist.is_initialized():
        return True
    world_size = int(os.environ["FEATHERCNN_NUM_PROCESSES"])
    rank = int(os.environ["FEATHERCNN_PROCESS_ID"])
    global _timeout
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    _timeout = timeout or DEFAULT_TIMEOUT
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device(
            "cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(backend, init_method=coordinator_url(coord),
                            world_size=world_size, rank=rank,
                            timeout=_timeout, **kw)
    return True


def group_timeout() -> datetime.timedelta:
    """The timeout ``maybe_initialize_distributed`` gave the default group
    (``DEFAULT_TIMEOUT`` where it made none), for the groups made after
    it: a collective skipped in any group fails within the same time."""
    return _timeout


def world() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _staged(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` on the device the group's backend takes: the host for gloo,
    the current CUDA device for NCCL; contiguous."""
    if dist.get_backend(group) == "gloo":
        return t.detach().cpu().contiguous()
    if t.device.type != "cuda":
        return t.detach().to(torch.device("cuda",
                                          torch.cuda.current_device()))
    return t.detach().contiguous()


def all_gather(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated along ``dim`` in
    group-rank order, on ``t``'s device."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    s = _staged(t, group)
    parts = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(parts, s, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t``, on ``t``'s device."""
    if dist.get_world_size(group) == 1:
        return t
    s = _staged(t, group).clone()
    dist.all_reduce(s, group=group)
    return s.to(t.device)


def reduce_scatter(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's chunk (along ``dim``, in group-rank order) of the sum of
    every rank's ``t``."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    s = _staged(t.movedim(dim, 0), group)
    out = torch.empty((s.shape[0] // n,) + tuple(s.shape[1:]),
                      dtype=s.dtype, device=s.device)
    dist.reduce_scatter_tensor(out, s, group=group)
    return out.movedim(0, dim).to(t.device)


def broadcast(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank of the world, on ``t``'s device."""
    if dist.get_world_size() == 1:
        return t
    s = _staged(t, None).clone()
    dist.broadcast(s, src=0)
    return s.to(t.device)


class _Exchange:
    """Point-to-point transfers in flight; ``wait`` returns the received
    tensors on the device they are wanted on."""

    def __init__(self, reqs, sent, bufs: List[torch.Tensor], devices):
        # the staged sends stay referenced until the transfers complete
        self._reqs, self._sent = reqs, sent
        self._bufs, self._devices = bufs, devices

    def wait(self) -> List[torch.Tensor]:
        for r in self._reqs:
            r.wait()
        return [b.to(d) for b, d in zip(self._bufs, self._devices)]


def start_exchange(sends: Sequence[Tuple[torch.Tensor, int]],
                   recvs: Sequence[Tuple[torch.Size, torch.dtype,
                                         torch.device, int]],
                   group=None) -> _Exchange:
    """Post sends of ``(tensor, group rank)`` and receives of ``(shape,
    dtype, device, group rank)`` at once (``batch_isend_irecv``); the
    transfers run while the caller computes, until ``wait()``."""
    def peer(r):
        return dist.get_global_rank(group, r) if group is not None else r
    ops, sent, bufs, devices = [], [], [], []
    for t, r in sends:
        sent.append(_staged(t, group))
        ops.append(dist.P2POp(dist.isend, sent[-1], peer(r), group))
    for shape, dtype, device, r in recvs:
        probe = torch.empty(0, dtype=dtype, device=device)
        buf = torch.empty(shape, dtype=dtype,
                          device=_staged(probe, group).device)
        ops.append(dist.P2POp(dist.irecv, buf, peer(r), group))
        bufs.append(buf)
        devices.append(device)
    reqs = dist.batch_isend_irecv(ops) if ops else []
    return _Exchange(reqs, sent, bufs, devices)
