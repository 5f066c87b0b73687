"""The process-group view of the JAX package's ``diloco`` mesh axis
(``nanodiloco_tpu/parallel/mesh.py``): one process per group of DiLoCo
workers over ``torch.distributed``, the reference NanoDiloco's own form
(launched by torchrun, one ``broadcast`` at init, one all-reduce per
parameter per outer step).

``WorkerMesh`` says which of the W workers this rank holds: a contiguous
slice of ``W / world`` rows, rank r holding rows ``[r * W_local, (r + 1)
* W_local)``. W must be a multiple of the world size: the JAX loop fails
loudly on a mesh that does not cover every process (a partial mesh there
is a hang), and here it is a ``ValueError``.

Its collectives are the only cross-rank traffic of the port. On gloo a
CUDA tensor goes through the host (a copy out, the collective, a copy
back): gloo's CUDA support differs by collective, and its transport is
the host's either way. On NCCL a host tensor (an offloaded snapshot, the
optimizer's step counts) goes through the card the same way. Under ``record_collectives()`` every collective
appends ``{"op", "dtype", "numel", "bytes", "tag"}`` (what this rank put
on the wire), so a test or the chip smoke can hold the wire against
``Diloco.sync_wire_bytes``.

Without an initialized process group, ``WorkerMesh.current`` is the
single-process mesh (``distributed`` false) and no path calls a
collective: every module keeps its one-process code and bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from datetime import timedelta

import torch
import torch.distributed as dist

# every collective of the current record_collectives() block, in order
_RECORD: list[dict] | None = None
# a CUDA tensor's piece through the host on gloo (64 MB of float32)
_STAGE_ELEMS = 1 << 24


@contextlib.contextmanager
def record_collectives():
    """Collect what this rank hands to each collective inside the block:
    yields the list the records are appended to."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _note(op: str, t: torch.Tensor, tag: str) -> None:
    if _RECORD is not None:
        _RECORD.append({"op": op, "dtype": str(t.dtype).removeprefix("torch."),
                        "numel": int(t.numel()), "bytes": int(t.numel() * t.element_size()),
                        "tag": tag})


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """This rank's place among the W DiLoCo workers. ``distributed`` is
    true when a process group is initialized (a world of one included:
    then every collective runs, on one rank)."""

    num_workers: int = 1
    rank: int = 0
    world: int = 1
    distributed: bool = False
    backend: str | None = None

    def __post_init__(self):
        if self.num_workers % self.world:
            raise ValueError(
                f"num_workers={self.num_workers} is not a multiple of the world size "
                f"{self.world}: every rank holds the same number of workers (a mesh "
                "that does not cover every process is a hang in the JAX package)"
            )

    @classmethod
    def current(cls, num_workers: int) -> "WorkerMesh":
        """The mesh of the initialized process group, else the
        single-process one."""
        if not (dist.is_available() and dist.is_initialized()):
            return cls(num_workers)
        return cls(num_workers, dist.get_rank(), dist.get_world_size(), True,
                   dist.get_backend())

    @property
    def local_workers(self) -> int:
        return self.num_workers // self.world

    @property
    def lo(self) -> int:
        return self.rank * self.local_workers

    @property
    def hi(self) -> int:
        return self.lo + self.local_workers

    def owns(self, worker: int) -> bool:
        return self.lo <= worker < self.hi

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    # -- collectives ---------------------------------------------------------

    def _wire_device(self) -> torch.device:
        """Where the backend takes its tensors: the host for gloo, this
        rank's card for NCCL."""
        if self.backend == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def _in_place(self, t: torch.Tensor, collective) -> torch.Tensor:
        """``collective(x)`` in place on ``t``. A tensor elsewhere than the
        backend takes it (a CUDA one on gloo, an offloaded host one on
        NCCL) is staged there in pieces of ``_STAGE_ELEMS`` elements (gloo
        moves a large buffer slower than the same bytes in pieces)."""
        wire = self._wire_device()
        if t.device == wire:
            collective(t)
            return t
        if not t.is_contiguous():
            h = t.to(wire)
            collective(h)
            return t.copy_(h)
        flat = t.view(-1)
        for lo in range(0, flat.numel(), _STAGE_ELEMS):
            piece = flat[lo:lo + _STAGE_ELEMS]
            h = piece.to(wire)
            collective(h)
            piece.copy_(h)
        return t

    def all_reduce_(self, t: torch.Tensor, op: str = "sum", tag: str = "") -> torch.Tensor:
        """In place: ``op`` ("sum" or "max") over the ranks."""
        _note(f"all_reduce_{op}", t, tag)
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return self._in_place(t, lambda x: dist.all_reduce(x, rop))

    def broadcast_(self, t: torch.Tensor, tag: str = "") -> torch.Tensor:
        """In place: rank 0's ``t`` on every rank."""
        _note("broadcast", t, tag)
        return self._in_place(t, lambda x: dist.broadcast(x, 0))

    def all_gather(self, t: torch.Tensor, dim: int = 0, tag: str = "") -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order (this
        rank's worker rows -> all W), on ``t``'s device."""
        _note("all_gather", t, tag)
        src = t.contiguous().to(self._wire_device())
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src)
        return torch.cat(parts, dim=dim).to(t.device)

    def gather_to_root(self, t: torch.Tensor, tag: str = "") -> list[torch.Tensor] | None:
        """Every rank's ``t`` on rank 0 (on the host, in rank order); None
        on the other ranks."""
        _note("gather", t, tag)
        src = t.detach().contiguous().to(self._wire_device())
        parts = [torch.empty_like(src) for _ in range(self.world)] if self.is_root else None
        dist.gather(src, parts, dst=0)
        return None if parts is None else [p.cpu() for p in parts]

    def reduce_values(self, values: list, op: str, dtype: torch.dtype = torch.float64,
                      tag: str = "") -> list:
        """``op`` over the ranks of a few host numbers."""
        t = torch.tensor(values, dtype=dtype, device=self._wire_device())
        return self.all_reduce_(t, op, tag=tag).tolist()


def init_from_env(device: str | torch.device = "cuda",
                  timeout_s: float | None = None) -> torch.device:
    """Initialize the process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) and
    return the device this rank runs on: ``cuda:LOCAL_RANK`` over NCCL
    for a CUDA device, the CPU over gloo for ``cpu``. NCCL cannot put two
    ranks on one card, so a rank whose card is missing raises; the card
    never falls back to gloo."""
    device = torch.device(device)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    kw = {} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run "
                               "the ranks on the CPU over gloo")
        count = torch.cuda.device_count()
        if local_rank >= count:
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} has no card: {count} visible. NCCL cannot put "
                "two ranks on one card; start at most one rank per card"
            )
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=device, **kw)
    elif device.type == "cpu":
        dist.init_process_group("gloo", rank=rank, world_size=world, **kw)
    else:
        raise ValueError(f"no process-group backend for device {device}")
    return device
