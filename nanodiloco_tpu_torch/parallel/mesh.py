"""The process-group view of the JAX package's mesh
(``nanodiloco_tpu/parallel/mesh.py``) over its ``diloco``, ``fsdp`` and
``tp`` axes: one process per rank over ``torch.distributed``, the
reference NanoDiloco's own form (launched by torchrun, one ``broadcast``
at init, one all-reduce per parameter per outer step).

A world of ``G * fsdp * tp`` ranks holds G worker groups. Ranks are laid
out in the JAX axis order, diloco outermost: rank ``(g * fsdp + f) * tp +
t`` is fsdp index f and tp index t of worker group g. Group g holds the
contiguous workers ``[g * W / G, (g + 1) * W / G)``; its ``fsdp * tp``
ranks hold slices of those workers' weights (``parallel/sharding.py``):
the model's tensor-parallel products run over the tp ranks, the worker's
batch rows are split over the fsdp ranks. W must be a multiple of G and
the world of ``fsdp * tp``: the JAX loop fails loudly on a mesh that does
not cover every process (a partial mesh there is a hang), and here it is
a ``ValueError``.

Every collective names its group:
- ``"all"``: every rank of the mesh (the stop latch, the integer wire's
  shared scale, the run name);
- ``"diloco"``: the ranks at one ``(f, t)`` across the worker groups, the
  only group the outer merge crosses;
- ``"shard"``: the ``fsdp * tp`` ranks of one worker group (the clip's
  global norm, the quarantine's finiteness, the dynamics readout);
- ``"fsdp"`` and ``"tp"``: one worker group's ranks at one t, and at one
  f (the layer gathers and gradient scatters; the tensor-parallel sums).
With ``fsdp = tp = 1`` the mesh builds no group: ``"all"`` and
``"diloco"`` are the default group, as before the inner axes existed.
Otherwise every rank builds every group, in one fixed order, when the
mesh is made (``torch.distributed.new_group`` is collective over the
world).

On gloo a CUDA tensor goes through the host (a copy out, the collective,
a copy back): gloo's CUDA support differs by collective, and its
transport is the host's either way. On NCCL a host tensor (an offloaded
snapshot, the optimizer's step counts) goes through the card the same
way. Under ``record_collectives()`` every collective appends ``{"op",
"dtype", "numel", "bytes", "tag"}`` (what this rank put on the wire), and
on a mesh with groups (sharded, or over part of the world) its
``"group"``, so a test or the chip smoke can hold the wire against
``Diloco.sync_wire_bytes`` and against what the sharding predicts.

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
# the groups of each sharded mesh, by (default group, ranks, fsdp, tp)
_GROUPS: dict[tuple, dict] = {}
GROUPS = ("all", "diloco", "shard", "fsdp", "tp")


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


def _note(op: str, t: torch.Tensor, tag: str, group: str | None) -> None:
    if _RECORD is not None:
        _RECORD.append({"op": op, "dtype": str(t.dtype).removeprefix("torch."),
                        "numel": int(t.numel()), "bytes": int(t.numel() * t.element_size()),
                        "tag": tag, **({} if group is None else {"group": group})})


def mesh_groups(world: int, fsdp: int, tp: int) -> dict[str, list[list[int]]]:
    """Every group of each kind, as lists of mesh ranks, in the order the
    groups are built: the rank of ``(g, f, t)`` is ``(g * fsdp + f) * tp +
    t``."""
    G = world // (fsdp * tp)

    def rank(g, f, t):
        return (g * fsdp + f) * tp + t

    return {
        "tp": [[rank(g, f, t) for t in range(tp)] for g in range(G) for f in range(fsdp)],
        "fsdp": [[rank(g, f, t) for f in range(fsdp)] for g in range(G) for t in range(tp)],
        "shard": [[rank(g, f, t) for f in range(fsdp) for t in range(tp)] for g in range(G)],
        "diloco": [[rank(g, f, t) for g in range(G)] for f in range(fsdp) for t in range(tp)],
    }


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """This rank's place among the W DiLoCo workers and inside its
    worker group. ``rank`` and ``world`` count the mesh's ranks;
    ``distributed`` is true when a process group is initialized (a world
    of one included: then every collective runs, on one rank). ``ranks``
    names the global ranks of a mesh over part of the world (None: the
    whole world)."""

    num_workers: int = 1
    rank: int = 0
    world: int = 1
    distributed: bool = False
    backend: str | None = None
    fsdp: int = 1
    tp: int = 1
    ranks: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.fsdp < 1 or self.tp < 1:
            raise ValueError(f"fsdp={self.fsdp} and tp={self.tp} must be at least 1")
        if self.world % self.shard_size:
            raise ValueError(
                f"the world size {self.world} is not a multiple of fsdp * tp = "
                f"{self.fsdp} * {self.tp}: every worker group holds fsdp * tp ranks"
            )
        if self.num_workers % self.worker_groups:
            if self.shard_size == 1:
                raise ValueError(
                    f"num_workers={self.num_workers} is not a multiple of the world size "
                    f"{self.world}: every rank holds the same number of workers (a mesh "
                    "that does not cover every process is a hang in the JAX package)"
                )
            raise ValueError(
                f"num_workers={self.num_workers} is not a multiple of the "
                f"{self.worker_groups} worker groups (world {self.world} / (fsdp * tp "
                f"= {self.shard_size})): every group holds the same number of workers"
            )

    @classmethod
    def current(cls, num_workers: int, fsdp: int = 1, tp: int = 1) -> "WorkerMesh":
        """The mesh of the initialized process group over the whole world
        (its subgroups built), else the single-process one."""
        if not (dist.is_available() and dist.is_initialized()):
            return cls(num_workers, fsdp=fsdp, tp=tp)
        return cls.build(num_workers, fsdp, tp)

    @classmethod
    def build(cls, num_workers: int, fsdp: int = 1, tp: int = 1,
              ranks: tuple[int, ...] | None = None) -> "WorkerMesh | None":
        """The mesh over the global ``ranks`` (None: the whole world), its
        groups built. Every rank of the world calls it with the same
        arguments (building a group is collective over the world); a rank
        outside ``ranks`` gets None."""
        world_size = dist.get_world_size()
        ranks = None if ranks is None or list(ranks) == list(range(world_size)) else tuple(ranks)
        members = list(range(world_size)) if ranks is None else list(ranks)
        me = dist.get_rank()
        mesh_rank = members.index(me) if me in members else None
        mesh = cls(num_workers, 0 if mesh_rank is None else mesh_rank, len(members), True,
                   dist.get_backend(), fsdp, tp, ranks)
        if mesh.shard_size > 1 or ranks is not None:
            mesh._build_groups(members, mesh_rank)
        return None if mesh_rank is None else mesh

    def _key(self) -> tuple:
        # the default group itself, not its id: a later group's could repeat it
        return (dist.group.WORLD, self.ranks, self.fsdp, self.tp)

    def _build_groups(self, members: list[int], mesh_rank: int | None) -> None:
        """Every group of the mesh, built by every rank of the world in one
        order; this rank keeps the handles of its own (none outside)."""
        key = self._key()
        if key in _GROUPS:
            return
        mine = {"all": None if self.ranks is None else dist.new_group(members)}
        for kind, groups in mesh_groups(self.world, self.fsdp, self.tp).items():
            if len(groups[0]) == 1 and kind != "diloco":
                continue  # an axis of one: no collective runs over it
            for ranks in groups:
                handle = dist.new_group([members[r] for r in ranks])
                if mesh_rank in ranks:
                    mine[kind] = handle
        _GROUPS[key] = mine

    # -- coordinates -----------------------------------------------------------

    @property
    def shard_size(self) -> int:
        """Ranks a worker group spans: fsdp * tp."""
        return self.fsdp * self.tp

    @property
    def sharded(self) -> bool:
        return self.shard_size > 1

    @property
    def worker_groups(self) -> int:
        """G, the size of the diloco axis."""
        return self.world // self.shard_size

    @property
    def group_index(self) -> int:
        """g: this rank's worker group."""
        return self.rank // self.shard_size

    @property
    def fsdp_index(self) -> int:
        return (self.rank // self.tp) % self.fsdp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def coords(self) -> dict[str, int]:
        return {"diloco": self.group_index, "fsdp": self.fsdp_index, "tp": self.tp_index}

    def size(self, group: str) -> int:
        return {"all": self.world, "diloco": self.worker_groups, "shard": self.shard_size,
                "fsdp": self.fsdp, "tp": self.tp}[group]

    @property
    def local_workers(self) -> int:
        return self.num_workers // self.worker_groups

    @property
    def lo(self) -> int:
        return self.group_index * self.local_workers

    @property
    def hi(self) -> int:
        return self.lo + self.local_workers

    def owns(self, worker: int) -> bool:
        return self.lo <= worker < self.hi

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def check_batch(self, per_device_batch_size: int) -> None:
        """A worker's microbatch rows split over its fsdp ranks (JAX
        ``batch_spec``: the per-worker batch axis over ``fsdp``)."""
        if per_device_batch_size % self.fsdp:
            raise ValueError(
                f"per_device_batch_size={per_device_batch_size} is not a multiple of "
                f"fsdp={self.fsdp}: a worker's microbatch rows split evenly over its "
                "fsdp ranks"
            )

    # -- collectives ---------------------------------------------------------

    def _group(self, group: str):
        """The process group handle (None: the default group)."""
        if group not in GROUPS:
            raise ValueError(f"unknown group {group!r}; one of {GROUPS}")
        if self.ranks is None and (group == "all" or (group == "diloco"
                                                      and not self.sharded)):
            return None
        return _GROUPS[self._key()][group]

    def _global(self, group: str, index: int) -> int:
        """The global rank of ``group``'s member ``index``."""
        g = self._group(group)
        return index if g is None else dist.get_global_rank(g, index)

    def _named(self, group: str) -> str | None:
        """The group a record names: None on a mesh without groups, where
        every collective spans the world."""
        return group if self.sharded or self.ranks is not None else None

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

    def all_reduce_(self, t: torch.Tensor, op: str = "sum", tag: str = "",
                    group: str = "all") -> torch.Tensor:
        """In place: ``op`` ("sum" or "max") over ``group``'s ranks."""
        _note(f"all_reduce_{op}", t, tag, self._named(group))
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        g = self._group(group)
        return self._in_place(t, lambda x: dist.all_reduce(x, rop, group=g))

    def broadcast_(self, t: torch.Tensor, tag: str = "", group: str = "all") -> torch.Tensor:
        """In place: the ``t`` of ``group``'s first rank on every rank of it."""
        _note("broadcast", t, tag, self._named(group))
        g, src = self._group(group), self._global(group, 0)
        return self._in_place(t, lambda x: dist.broadcast(x, src, group=g))

    def all_gather(self, t: torch.Tensor, dim: int = 0, tag: str = "",
                   group: str = "all") -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in ``group``'s rank
        order (this rank's worker rows -> all W over "diloco"; a shard ->
        the whole over "fsdp" or "tp"), on ``t``'s device."""
        _note("all_gather", t, tag, self._named(group))
        src = t.contiguous().to(self._wire_device())
        parts = [torch.empty_like(src) for _ in range(self.size(group))]
        dist.all_gather(parts, src, group=self._group(group))
        return torch.cat(parts, dim=dim).to(t.device)

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0, tag: str = "",
                       group: str = "all", dtype: torch.dtype | None = None
                       ) -> torch.Tensor:
        """The sum over ``group``'s ranks of ``t`` (cast to ``dtype`` where
        the backend takes it: on gloo, on the host), of which this rank
        keeps its piece along ``dim`` (``t.shape[dim]`` split evenly in the
        group's rank order), on ``t``'s device."""
        src = t.to(self._wire_device())
        if dtype is not None:
            src = src.to(dtype)
        _note("reduce_scatter", src, tag, self._named(group))
        n = self.size(group)
        pieces = [p.contiguous() for p in src.chunk(n, dim=dim)]
        out = torch.empty_like(pieces[0])
        dist.reduce_scatter(out, pieces, group=self._group(group))
        return out.to(t.device)

    def gather_to_root(self, t: torch.Tensor, tag: str = "",
                       group: str = "all") -> list[torch.Tensor] | None:
        """Every rank's ``t`` on ``group``'s first rank (on the host, in the
        group's rank order); None on the other ranks."""
        _note("gather", t, tag, self._named(group))
        src = t.detach().contiguous().to(self._wire_device())
        root = self._global(group, 0) == dist.get_rank()
        parts = [torch.empty_like(src) for _ in range(self.size(group))] if root else None
        dist.gather(src, parts, dst=self._global(group, 0), group=self._group(group))
        return None if parts is None else [p.cpu() for p in parts]

    def reduce_values(self, values: list, op: str, dtype: torch.dtype = torch.float64,
                      tag: str = "", group: str = "all") -> list:
        """``op`` over ``group``'s ranks of a few host numbers."""
        t = torch.tensor(values, dtype=dtype, device=self._wire_device())
        return self.all_reduce_(t, op, tag=tag, group=group).tolist()


def check_node_layout(world: int, fsdp: int, tp: int, dcn_slices: int) -> None:
    """``--dcn-slices`` (JAX ``build_hybrid_mesh``: the diloco axis across
    slices, fsdp and tp inside one) on torchrun's nodes: a node
    (``LOCAL_WORLD_SIZE`` ranks) holds whole worker groups, so the fsdp and
    tp traffic never leaves it and only the outer merge crosses nodes, and
    the job spans ``dcn_slices`` nodes. Anything else raises. Without
    torchrun's ``LOCAL_WORLD_SIZE`` the world is one node."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is None:
        if dcn_slices != 1:
            raise ValueError(
                f"--dcn-slices {dcn_slices} needs torchrun's LOCAL_WORLD_SIZE (the ranks "
                "a node holds): without it the job is one node"
            )
        return
    local = int(local)
    if dcn_slices < 1 or world % local or world // local != dcn_slices:
        raise ValueError(
            f"--dcn-slices {dcn_slices} does not match the job: world {world} over nodes "
            f"of LOCAL_WORLD_SIZE {local} ranks is {world / local:g} node(s); one slice "
            "is one node"
        )
    if local % (fsdp * tp):
        raise ValueError(
            f"a node of {local} ranks does not hold whole worker groups of fsdp * tp = "
            f"{fsdp * tp} ranks: fsdp and tp traffic would cross nodes"
        )


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
