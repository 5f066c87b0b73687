"""DiLoCo: port of ``nanodiloco_tpu/parallel/diloco.py``, its classic
rounds and every option of its ``DilocoConfig`` but the pipeline
schedule (pipeline parallelism is ROADMAP item 7).

One process and one device hold all W workers, or, under a
``torch.distributed`` process group (``parallel/mesh.py``), each rank
holds a contiguous slice of ``W / world`` of them. Every worker's
parameters live in one tensor per weight with a leading worker axis
(the JAX package's stacked pytree, which it ``vmap``s): the model runs
the rank's workers in one batched pass, so each op, the attention
kernels included, launches once for them. Workers stay independent
under autograd because the summed per-worker losses touch disjoint
slices (the backward of a sum is ones whatever the values, so one
worker's NaN loss leaves the others' gradients finite).

- Inner step: ``grad_accum`` microbatches, each backpropagating its
  per-worker ``sum_loss`` (plus ``router_aux_coef · n_tokens ·
  router_aux`` in an MoE model) into ``.grad``; dividing worker w's slice
  by its token total gives the exact token-weighted mean of the JAX
  package.
  Then a per-worker global-norm clip and AdamW under warmup-cosine, each
  worker at its own step count (``training/optim.py::StackedAdamW``).
- Outer step: pseudo-gradient ``snapshot - mean_w(params_w)``, one
  functional Nesterov step on the snapshot, every worker reset to it.
  The inner AdamW state is not reset, as in the JAX package. The outer
  step runs leaf by leaf, so its temporaries are one tensor's size.

Under a process group the merge is this rank's partial sum over its
rows, then one all-reduce per leaf (SUM): each worker's delta ``s - p_w``
is quantized locally on a float wire and the weighted sum taken in
float32, as on one process. The integer wire's shared scale is one MAX
all-reduce of an f32 ``[n_leaves]`` vector of the ranks' absmaxes (the one
float shape JAX's wire audit allows); its integers are summed on the
collective in the accumulator dtype, which for int16 (no 16-bit integer
exists on NCCL or gloo) travels as two offset lanes packed into one int32
word (``_packed_int16_sum``: exact, 2 bytes a parameter). The quarantine
mask, the heterogeneous-H budgets and the dynamics readout's replicas are
gathered, so every rank computes the same coefficients and readout; the
snapshot is broadcast from rank 0 at init. On one rank all of this runs
too (a world of one), with every collective the identity.

A worker group may span ``fsdp * tp`` ranks (``WorkerMesh``'s inner axes):
each rank then holds its slices of the group's workers' weights, moments
and snapshot (``parallel/sharding.py``) and its ``B / fsdp`` rows of each
microbatch. The inner step sums ``sum_loss`` and ``n_tokens`` over the
fsdp ranks before the loss and the ``1/n`` gradient scale, so the loss is
the worker's; whole leaves' gradients (the norm scales) are summed over
the fsdp ranks (a sharded leaf's are reduce-scattered inside the
backward); the clip's squared norms are summed over the worker group's
ranks, a whole leaf counted once; AdamW runs on the shards unchanged. The
outer step runs per shard: the merge's collectives cross only the
``"diloco"`` group (the ranks at one ``(f, t)``), the integer wire's
per-leaf absmax is taken over every rank (so its scale is JAX's
whole-leaf one), a replica is finite only if every shard is, and the
dynamics readout's sums add over the group's ranks.

The options, as in the JAX package: a quantized outer wire (a float cast
or a per-worker absmax integer quantizer), the integer wire whose sum
carries the quantized payload under one shared scale, divergence
quarantine (a worker with a non-finite replica leaves the mean, its
moments are zeroed, and it resets with the rest), the dynamics readout,
heterogeneous per-worker H (a worker freezes past its budget and enters
the merge weighted by its realized steps), the async delayed-apply
outer step, and the snapshot parked in pinned host memory between syncs.

Updates happen in place (PyTorch idiom; the JAX state is immutable and
donated): the step functions return the same state object they were
given.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import (
    Params,
    causal_lm_loss,
    init_params,
    layer_keys,
    resolve_device,
    tree_leaves,
    tree_map,
)
from nanodiloco_tpu_torch.parallel.mesh import WorkerMesh
from nanodiloco_tpu_torch.parallel.sharding import (
    check_layout,
    counted,
    named_leaves,
    shard,
    shard_leaf,
    spec_of,
)
from nanodiloco_tpu_torch.training.optim import (
    StackedAdamW,
    clip_per_worker_,
    inner_optimizer,
    nesterov_direction,
    warmup_cosine_schedule,
)

# outer-wire dtypes by the JAX package's names: a float wire is a cast; a
# signed-int wire quantizes with q_max (int4 has no torch dtype: its
# values ride in int8 storage) and counts its element bytes as JAX does
FLOAT_WIRES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
               "float32": torch.float32}
INT_WIRES = {  # name: (q_max, storage dtype, bytes per element)
    "int4": (7, torch.int8, 1),
    "int8": (127, torch.int8, 1),
    "int16": (32767, torch.int16, 2),
    "int32": (2**31 - 1, torch.int32, 4),
}
_TINY = torch.finfo(torch.float32).tiny
# the dynamics readout gathers replicas in slices of this many elements a
# worker (256 MB of float32), not a whole embedding at a time
_GATHER_ELEMS = 1 << 26
_INT32_MAX = 2**31 - 1


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a correctly rounded division on every device. CUDA
    divides by a host scalar as a multiply by its reciprocal, which can
    land one ulp off (a scale one ulp off moves integers a bin); a scalar
    on the device keeps the division, so the card's quantizer gives the
    CPU's (and JAX's) integers and scales."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _packed_int16_sum(mesh: WorkerMesh, part: torch.Tensor, bound: int) -> torch.Tensor:
    """The exact sum over the diloco group of the integer tensors ``part`` whose
    total is an int16 (``|total| <= bound = W * q_max <= 32767``) on 2
    bytes an element, in int32 words: NCCL has no 16-bit integer type and
    gloo refuses one. The flat tensor is cut in halves ``a | b`` (one zero
    pads an odd length); each rank sends ``b * 2**16 + (a + off)`` with
    ``off = W_local * q_max``, so its low lane is in ``[0, 2 * off]``. Over
    any set of ranks the low lanes sum into ``[0, 2 * bound] < 2**16`` (no
    carry into the high lane) and the high lanes into ``[-bound, bound]``,
    so no partial sum leaves int32 in any reduction order. Returns the
    int32 total in ``part``'s shape."""
    n = part.numel()
    half = (n + 1) // 2
    flat = part.reshape(-1).to(torch.int64)
    a, b = flat[:half], torch.zeros(half, dtype=torch.int64, device=flat.device)
    b[: n - half] = flat[half:]
    groups = mesh.worker_groups
    off = bound // groups
    word = (b * 65536 + (a + off)).to(torch.int32)
    mesh.all_reduce_(word, "sum", tag="pseudograd", group="diloco")
    total = word.to(torch.int64)
    low = total & 0xFFFF
    out = torch.cat([low - off * groups, (total - low) // 65536])
    return out[:n].to(torch.int32).reshape(part.shape)


def _wire_accumulator_dtype(num_workers: int, q_max: float) -> torch.dtype:
    """Narrowest signed integer the worst-case sum W*q_max fits: the dtype
    the integer wire's sum is taken in (int4 payloads stay one byte up to
    W=18). One source of truth for the wire and the byte count."""
    if num_workers * q_max <= 127:
        return torch.int8
    if num_workers * q_max <= 32767:
        return torch.int16
    return torch.int32


@dataclasses.dataclass(frozen=True)
class DilocoConfig:
    """The JAX ``DilocoConfig``'s fields and defaults (``pp_schedule`` aside:
    pipeline parallelism is not ported). The option combinations the JAX
    ``Diloco`` refuses are refused by the port's ``Diloco`` too."""

    num_workers: int = 1
    inner_steps: int = 100          # H: inner steps between outer syncs
    warmup_steps: int = 100
    total_steps: int = 10_000
    lr: float = 4e-4                # inner AdamW lr
    outer_lr: float = 0.7           # outer SGD lr
    outer_momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 0.01
    clip_norm: float | None = 1.0
    grad_accum: int = 1             # microbatches per inner step
    # park the snapshot in pinned host memory between outer steps (the
    # identity on the CPU, where it already lives on the host)
    offload_snapshot: bool = False
    # the pseudo-gradient's wire: a float dtype name (a cast) or a
    # signed-int one (absmax quantization, per worker and tensor)
    outer_comm_dtype: str | None = None
    # quantize against one scale shared by the survivors and sum the
    # integers (needs a signed-int outer_comm_dtype of at most 2 bytes)
    outer_wire_collective: bool = False
    # mask a worker whose replica (or round loss) is non-finite out of
    # the outer mean, zero its moments, reset it with the rest
    quarantine_nonfinite: bool = False
    # per-sync readout: pg_norm [W], drift_max, drift_mean,
    # outer_momentum_norm, outer_update_cos
    dynamics_metrics: bool = False
    # launch each round's outer update and apply it outer_delay round
    # boundaries later
    async_outer: bool = False
    outer_delay: int = 1
    # per-worker inner-step budgets (heterogeneous H)
    inner_steps_per_worker: tuple[int, ...] | None = None


@dataclasses.dataclass
class DilocoState:
    params: Params                     # [W, ...] leaf tensors, requires_grad
    inner_opt: StackedAdamW            # the [W, ...] moments and [W] step counts
    snapshot: Params                   # unstacked: params at the last sync
    outer_opt_state: Params            # unstacked: the Nesterov momentum
    inner_step_count: int = 0          # completed inner steps


@dataclasses.dataclass
class AsyncDilocoState(DilocoState):
    """Classic state plus the in-flight merges of the async outer path.

    ``snapshot`` is the base every worker started the current round from,
    the last applied merge. ``pending`` is the FIFO of launched but not
    yet applied merged models, oldest first (``max(outer_delay, 1)``
    slots; with delay 0 the one slot mirrors the applied merge, so a
    checkpoint's shape does not depend on the delay). ``pending_round``
    is each slot's launch round (0: an init copy); ``launched_round`` the
    newest round whose boundary has run, which tells a resume whether a
    boundary is still owed."""

    pending: list[Params] = dataclasses.field(default_factory=list)
    pending_round: list[int] = dataclasses.field(default_factory=list)
    launched_round: int = 0


class _Dynamics:
    """The dynamics readout (JAX ``_sync_dynamics``), accumulated leaf by
    leaf in float32 from values the outer step holds anyway, in one-pass
    reductions (``vector_norm``, ``dot``). Drift is the RMS and max of the
    pairwise replica distances, each pair's squared distance summed from
    its own difference: the JAX package gets the same numbers from the
    deviation gram ``G_ij = <p_i - mean, p_j - mean>``; both avoid the
    cancellation of a raw-params gram, and the difference needs no GEMM
    whose inner dimension is a whole tensor."""

    def __init__(self, num_workers: int, device: torch.device):
        f32 = dict(dtype=torch.float32, device=device)
        self.W = num_workers
        self.pairs = [(i, j) for i in range(num_workers) for j in range(i + 1, num_workers)]
        self.pg_sq = torch.zeros(num_workers, **f32)
        self.pair_sq = torch.zeros(len(self.pairs), **f32)
        self.snap_sq = torch.zeros((), **f32)
        self.dot = torch.zeros((), **f32)
        self.d_sq = torch.zeros((), **f32)
        self.dir_sq = torch.zeros((), **f32)
        self.mom_sq = torch.zeros((), **f32)

    def add_replicas(self, s: torch.Tensor, p: torch.Tensor) -> None:
        """The old snapshot leaf and the replicas ``p`` [W, ...], one
        worker's (or pair's) difference at a time."""
        s = s.float()
        for w in range(self.W):
            self.pg_sq[w] += torch.linalg.vector_norm(s - p[w].float()).square()
        for k, (i, j) in enumerate(self.pairs):
            self.pair_sq[k] += torch.linalg.vector_norm(p[j].float() - p[i].float()).square()
        self.snap_sq += torch.linalg.vector_norm(s).square()

    def add_update(self, delta: torch.Tensor, direction: torch.Tensor,
                   buf: torch.Tensor) -> None:
        """The pseudo-gradient, the Nesterov direction (the update is
        ``-lr`` times it) and the new momentum."""
        d, u = delta.float().reshape(-1), direction.float().reshape(-1)
        self.dot += torch.dot(d, u)
        self.d_sq += torch.linalg.vector_norm(d).square()
        self.dir_sq += torch.linalg.vector_norm(u).square()
        self.mom_sq += torch.linalg.vector_norm(buf.float()).square()

    @torch.no_grad()
    def sum_over(self, mesh: WorkerMesh, group: str) -> None:
        """Add every sum over ``group``'s ranks (a sharded readout: each
        rank accumulated its own slices, a whole leaf on one rank)."""
        w, n = self.pg_sq.numel(), self.pair_sq.numel()
        flat = torch.cat([self.pg_sq, self.pair_sq, torch.stack(
            [self.snap_sq, self.dot, self.d_sq, self.dir_sq, self.mom_sq])])
        mesh.all_reduce_(flat, "sum", tag="dynamics", group=group)
        self.pg_sq, self.pair_sq = flat[:w], flat[w:w + n]
        self.snap_sq, self.dot, self.d_sq, self.dir_sq, self.mom_sq = flat[w + n:]

    def result(self) -> dict[str, torch.Tensor]:
        snap_norm = self.snap_sq.sqrt().clamp_min(_TINY)
        if self.pairs:
            pair = self.pair_sq.sqrt()
            drift_max = pair.max() / snap_norm
            drift_mean = pair.square().mean().sqrt() / snap_norm
        else:
            drift_max = drift_mean = torch.zeros((), device=self.pg_sq.device)
        # the cosine between the pseudo-gradient and the descent
        # direction: the update is -lr * direction, so -cos(delta,
        # update) = cos(delta, direction)
        cos = self.dot / (self.d_sq.sqrt() * self.dir_sq.sqrt()).clamp_min(_TINY)
        return {
            "pg_norm": self.pg_sq.sqrt(),
            "drift_max": drift_max,
            "drift_mean": drift_mean,
            "outer_momentum_norm": self.mom_sq.sqrt(),
            "outer_update_cos": cos,
        }


def host_dynamics(dyn: dict) -> dict:
    """Dynamics tensors -> JSONL-ready host numbers: ``pg_norm`` as a
    per-worker list, the rest floats (JAX ``_host_dynamics``)."""
    return {
        "pg_norm": [float(x) for x in dyn["pg_norm"].tolist()],
        "drift_max": float(dyn["drift_max"]),
        "drift_mean": float(dyn["drift_mean"]),
        "outer_momentum_norm": float(dyn["outer_momentum_norm"]),
        "outer_update_cos": float(dyn["outer_update_cos"]),
    }


class Diloco:
    """Owns the inner and outer steps of DiLoCo on one device."""

    def __init__(self, model_cfg: LlamaConfig, cfg: DilocoConfig,
                 device: str | torch.device = "cuda", mesh: WorkerMesh | None = None):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.device = resolve_device(device)
        W = cfg.num_workers
        # the workers this rank holds (all W without a process group)
        self.mesh = WorkerMesh.current(W) if mesh is None else mesh
        if self.mesh.num_workers != W:
            raise ValueError(f"mesh is for {self.mesh.num_workers} workers, the config {W}")
        # every dim a shard splits must split evenly (MoE: not ported)
        check_layout(model_cfg, self.mesh.fsdp, self.mesh.tp)
        self._float_wire = self._int_wire = None
        if cfg.outer_comm_dtype is not None:
            name = cfg.outer_comm_dtype
            if name in FLOAT_WIRES:
                self._float_wire = FLOAT_WIRES[name]
            elif name in INT_WIRES:
                self._int_wire = INT_WIRES[name]
            else:
                raise ValueError(
                    f"outer_comm_dtype {name!r} must be a float (cast wire: "
                    f"{sorted(FLOAT_WIRES)}) or signed-int (absmax-quantized wire: "
                    f"{sorted(INT_WIRES)}) dtype"
                )
        if cfg.outer_wire_collective:
            if self._int_wire is None:
                raise ValueError(
                    "outer_wire_collective requires a signed-int outer_comm_dtype "
                    f"(got {cfg.outer_comm_dtype!r}): the integer wire carries a "
                    "quantized payload"
                )
            q_max, _, nbytes = self._int_wire
            if nbytes > 2:
                raise ValueError(
                    f"outer_wire_collective wire dtype {cfg.outer_comm_dtype} is not "
                    "narrow: use int4, int8 or int16 (int32 would match f32's width "
                    "and overflow the int32 sum)"
                )
            if W * q_max > _INT32_MAX:
                raise ValueError(
                    f"num_workers={W} with wire {cfg.outer_comm_dtype} overflows the "
                    "int32 sum"
                )
        self._h_budget: list[int] | None = None
        if cfg.inner_steps_per_worker is not None:
            hs = [int(h) for h in cfg.inner_steps_per_worker]
            if len(hs) != W:
                raise ValueError(
                    f"inner_steps_per_worker has {len(hs)} entries but num_workers is {W}"
                )
            if any(h < 1 or h > cfg.inner_steps for h in hs):
                raise ValueError(
                    f"inner_steps_per_worker entries must be in "
                    f"[1, inner_steps={cfg.inner_steps}]; got {tuple(hs)}"
                )
            if cfg.outer_wire_collective:
                raise ValueError(
                    "inner_steps_per_worker is incompatible with outer_wire_collective: "
                    "the integer wire sums unweighted payloads (a shared scale cannot "
                    "express per-worker step-share weights)"
                )
            self._h_budget = hs
        # budgets the most recent inner round ran under: the weights its
        # deferred async boundary merges with
        self._h_budget_prev: list[int] | None = None
        if cfg.async_outer:
            if cfg.outer_delay < 0:
                raise ValueError(f"outer_delay must be >= 0, got {cfg.outer_delay}")
            if cfg.quarantine_nonfinite:
                raise ValueError(
                    "quarantine_nonfinite is synchronous-outer-only: the async boundary "
                    "runs at the top of the NEXT round, after the round's [W] "
                    "loss-finiteness verdict is gone; run the synchronous outer step "
                    "for fault quarantine"
                )
            if cfg.offload_snapshot:
                raise ValueError(
                    "offload_snapshot is synchronous-outer-only: the async path keeps "
                    "the snapshot AND the pending merge(s) live every round; there is "
                    "no between-syncs window to park them in host memory"
                )
        self.schedule = warmup_cosine_schedule(cfg.lr, cfg.warmup_steps, cfg.total_steps)
        # pinned host buffers of the offloaded snapshot, reused every sync
        self._host_snapshot: Params | None = None

    # -- heterogeneous per-worker H ------------------------------------------

    def set_inner_budget(self, budgets) -> None:
        """Retarget the per-worker inner-step budgets for later rounds (the
        straggler policy's lever). Only with ``inner_steps_per_worker``."""
        if self._h_budget is None:
            raise RuntimeError(
                "heterogeneous H is not enabled: build Diloco with "
                "DilocoConfig.inner_steps_per_worker to get a runtime step budget"
            )
        hs = [int(h) for h in budgets]
        if len(hs) != self.cfg.num_workers:
            raise ValueError(
                f"budget must have one entry per worker ({self.cfg.num_workers}); "
                f"got {len(hs)}"
            )
        if any(h < 1 or h > self.cfg.inner_steps for h in hs):
            raise ValueError(
                f"budget entries must be in [1, inner_steps={self.cfg.inner_steps}]; "
                f"got {hs}"
            )
        self._h_budget = hs

    @property
    def inner_budget(self) -> tuple[int, ...] | None:
        """Current per-worker step budgets (None = uniform-H classic)."""
        return None if self._h_budget is None else tuple(self._h_budget)

    # -- init ---------------------------------------------------------------

    def init_state(
        self, generator: torch.Generator | None = None, params: Params | None = None
    ) -> DilocoState:
        """Every worker and the snapshot start from one tree: ``params``
        if given (e.g. converted from the JAX package with
        ``params_from_numpy``), else ``init_params(generator, ...)``. The
        outer momentum starts at zero, as optax's trace does. The tree is
        whole; a sharded mesh keeps this rank's slices (drawn leaf by leaf
        from the generator, one whole leaf at a time)."""
        if params is None:
            if generator is None:
                raise ValueError("init_state needs a generator or params")
            if self.mesh.sharded:
                params = init_params(generator, self.model_cfg, self.device,
                                     leaf=lambda name, t: shard_leaf(name, t, self.mesh))
            else:
                params = init_params(generator, self.model_cfg, self.device)
        else:
            params = shard(params, self.mesh)
        W = self.mesh.local_workers
        snapshot = tree_map(lambda p: p.detach().to(self.device).clone(), params)
        self.broadcast_snapshot(snapshot)
        stacked = tree_map(
            lambda p: p.unsqueeze(0).repeat((W,) + (1,) * p.ndim).requires_grad_(True),
            snapshot,
        )
        base = DilocoState(
            params=stacked,
            inner_opt=inner_optimizer(tree_leaves(stacked), self.cfg.weight_decay),
            snapshot=snapshot,
            outer_opt_state=tree_map(torch.zeros_like, snapshot),
        )
        if self.cfg.async_outer:
            return self._as_async_state(base)
        return self._offload(base)

    @torch.no_grad()
    def broadcast_snapshot(self, snapshot: Params) -> Params:
        """Worker group 0's snapshot into every group, in place (the
        reference's init broadcast; after a restore too), shard by shard
        over the diloco group. The identity without a process group."""
        if self.mesh.distributed:
            for s in tree_leaves(snapshot):
                self.mesh.broadcast_(s, tag="init", group="diloco")
        return snapshot

    def gather_workers(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's per-worker values (its W_local entries along
        ``dim``) gathered to all W, in worker order; ``t`` itself without
        a process group."""
        if not self.mesh.distributed:
            return t
        return self.mesh.all_gather(t, dim=dim, tag="workers", group="diloco")

    def _as_async_state(self, base: DilocoState) -> AsyncDilocoState:
        """Every pending slot starts as a copy of the init snapshot with
        launch round 0, so the warm-up boundaries apply no-ops."""
        slots = max(self.cfg.outer_delay, 1)
        return AsyncDilocoState(
            params=base.params, inner_opt=base.inner_opt, snapshot=base.snapshot,
            outer_opt_state=base.outer_opt_state,
            inner_step_count=base.inner_step_count,
            pending=[tree_map(torch.clone, base.snapshot) for _ in range(slots)],
            pending_round=[0] * slots, launched_round=0,
        )

    # -- inner step (no cross-worker traffic) --------------------------------

    def _as_tokens(self, x) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
        return t.to(device=self.device, dtype=torch.long)

    def inner_step(self, state: DilocoState, tokens, loss_mask):
        """tokens/loss_mask: [W, accum, B, S] (this rank's W_local rows
        under a process group). One AdamW update per worker
        from ``accum`` token-weighted microbatch gradients. Returns
        (state, [W] losses), each the mean of the microbatch mean losses.

        Under heterogeneous H, worker w updates only while its position
        in the round (``inner_step_count % H``) is below its budget; past
        it its replica, moments and step count (so its lr and bias
        correction) stay. Its loss is still the real loss of its frozen
        replica on the step's batch."""
        tokens = self._as_tokens(tokens)
        loss_mask = self._as_tokens(loss_mask)
        W, A = self.mesh.local_workers, self.cfg.grad_accum
        if tokens.ndim != 4:
            raise ValueError(f"tokens must be [W, accum, B, S]; got shape {tuple(tokens.shape)}")
        if tokens.shape[0] != W:
            raise ValueError(f"batch worker axis is {tokens.shape[0]} but this rank holds "
                             f"{W} of num_workers={self.cfg.num_workers}")
        if tokens.shape[1] != A:
            raise ValueError(f"batch accumulation axis is {tokens.shape[1]} but grad_accum is {A}")
        leaves = tree_leaves(state.params)
        mesh = self.mesh if self.mesh.sharded else None
        split_rows = mesh is not None and mesh.fsdp > 1
        loss_sum = torch.zeros(W, device=self.device)
        n_sum = torch.zeros(W, device=self.device)
        for a in range(A):
            loss, aux = causal_lm_loss(
                state.params, tokens[:, a], self.model_cfg, loss_mask[:, a], mesh=mesh
            )
            objective = aux["sum_loss"]
            if self.model_cfg.num_experts:
                # JAX weights each microbatch's gradient of the mean loss
                # by its token count: sum_loss + coef * n * router_aux
                objective = objective + (self.model_cfg.router_aux_coef
                                         * aux["n_tokens"].detach() * aux["router_aux"])
            objective.sum().backward()
            n = aux["n_tokens"].detach()
            if split_rows:
                # the worker's loss is over all its fsdp ranks' rows
                sums = torch.stack([aux["sum_loss"].detach(), n])
                mesh.all_reduce_(sums, "sum", tag="loss", group="fsdp")
                loss, n = sums[0] / sums[1].clamp_min(1.0), sums[1]
            loss_sum += loss.detach()
            n_sum += n
        with torch.no_grad():
            specs = [spec_of(name, worker_axis=True) for name, _ in named_leaves(state.params)
                     ] if mesh is not None else None
            if split_rows:
                # a whole leaf's gradient holds this rank's rows only
                for p, spec in zip(leaves, specs):
                    if "fsdp" not in spec:
                        mesh.all_reduce_(p.grad, "sum", tag="fsdp", group="fsdp")
            inv = 1.0 / n_sum.clamp_min(1e-9)
            for p in leaves:
                p.grad.mul_(inv.view((-1,) + (1,) * (p.ndim - 1)).to(p.grad.dtype))
            if self.cfg.clip_norm is not None:
                grads = [p.grad for p in leaves]
                if mesh is None:
                    clip_per_worker_(grads, self.cfg.clip_norm)
                else:
                    clip_per_worker_(
                        grads, self.cfg.clip_norm, [counted(s, mesh) for s in specs],
                        lambda sq: mesh.all_reduce_(sq, "sum", tag="clip", group="shard"))
        active = None
        if self._h_budget is not None:
            pos = state.inner_step_count % self.cfg.inner_steps
            active = [pos < h for h in self._h_budget[self.mesh.lo:self.mesh.hi]]
        opt = state.inner_opt
        opt.step([self.schedule(c) for c in opt.counts()], active)
        opt.zero_grad()
        state.inner_step_count += 1
        return state, loss_sum / A

    def inner_round(self, state: DilocoState, tokens, loss_mask):
        """``inner_steps`` inner updates, no sync. tokens/loss_mask:
        [H, W, accum, B, S]. Returns (state, [H, W] losses)."""
        H = self.cfg.inner_steps
        if len(tokens) != H or np.ndim(tokens) != 5:
            raise ValueError(
                f"round tokens must be [inner_steps={H}, W, accum, B, S]; "
                f"got {tuple(np.shape(tokens))}"
            )
        if self._h_budget is not None:
            self._h_budget_prev = list(self._h_budget)
        losses = []
        for h in range(H):
            state, loss = self.inner_step(state, tokens[h], loss_mask[h])
            losses.append(loss)
        return state, torch.stack(losses)

    def inner_round_step(self, state: DilocoState, tokens, loss_mask):
        """``round_step`` without the sync: (state, [H, W] losses, an
        all-ones [W] mask), the JAX entry's shape."""
        state, losses = self.inner_round(state, tokens, loss_mask)
        return state, losses, torch.ones(self.cfg.num_workers, dtype=torch.bool)

    # -- the outer-wire arithmetic -------------------------------------------

    def quantize_wire(self, d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-(worker, tensor) absmax quantization of a stacked delta
        [W, ...] on a signed-int wire: (integers in the wire's storage
        dtype, [W, 1, ...] float32 scales). ``q = round(d / scale)``
        (half to even, as ``jnp.round``) in [-q_max, q_max], ``scale =
        max(absmax / q_max, tiny)``."""
        q_max, storage, _ = self._int_wire
        axes = tuple(range(1, d.ndim))
        # the inf-norm is the absmax, without a |d| copy
        scale = torch.linalg.vector_norm(d, ord=float("inf"), dim=axes, keepdim=True)
        scale = _div(scale.float(), q_max).clamp_min(_TINY)
        q = (d.float() / scale).round_().clamp_(-q_max, q_max)
        return q.to(storage), scale

    def _wire_quantize(self, d: torch.Tensor) -> torch.Tensor:
        """Quantize-dequantize a stacked delta to the wire, as float32: a
        cast for a float wire, ``q * scale`` for a signed-int one."""
        if self._float_wire is not None:
            return d.to(self._float_wire).float()
        q, scale = self.quantize_wire(d)
        return q.float() * scale

    def _merge_coefs(self, weights: list[float] | None) -> list[float]:
        """Host [W] coefficients of the merge: each worker's weight over
        the weights' total (clamped to 1, as JAX's denominator), 1/W each
        without weights; 0 for a masked worker, all 0 when none survive.
        Equal weights give the classic 1/W exactly, so uniform budgets and
        an all-true mask are classic DiLoCo bit for bit."""
        w = [1.0] * self.cfg.num_workers if weights is None else weights
        denom = max(sum(w), 1.0)
        return [x / denom for x in w]

    def _pseudograd_of(self, s: torch.Tensor, p: torch.Tensor,
                       weights: list[float] | None,
                       scale: torch.Tensor | None = None) -> torch.Tensor:
        """The pseudo-gradient of one leaf from the old snapshot ``s`` and
        the replicas ``p`` [W, ...], with the coefficients ``c`` of
        ``_merge_coefs``: ``s - sum_w c_w p_w`` (JAX's ``s - mean(p)``
        without weights), or on a wire ``sum_w c_w wire(s - p_w)``, each
        worker's delta quantized first and summed in float32. Only the
        survivors' rows are read, so a dead worker's NaN cannot reach the
        merge through 0 * NaN; all-dead gives a zero pseudo-gradient.

        Under a process group ``p`` holds this rank's rows and the result
        is ``sum_w c_w wire(s - p_w)`` (the identity for wire) summed over
        the ranks: its roundoff is in units of the deltas, not of the
        snapshot. ``scale`` is the integer wire's shared scale, if the
        caller already has it."""
        if self.cfg.outer_wire_collective:
            return self._integer_wire_leaf(s, p, weights, scale)
        if self.mesh.distributed:
            return self._pseudograd_ranks(s, p, weights)
        coefs = self._merge_coefs(weights)
        live = [w for w, c in enumerate(coefs) if c > 0]
        if not live:
            return torch.zeros_like(s)
        if self.cfg.outer_comm_dtype is None:
            merged = torch.sub(s, p[live[0]], alpha=coefs[live[0]])
            for w in live[1:]:
                merged.sub_(p[w], alpha=coefs[w])
            return merged
        d = self._wire_quantize(s.unsqueeze(0) - p)
        merged = d[live[0]] * coefs[live[0]]
        for w in live[1:]:
            merged.add_(d[w], alpha=coefs[w])
        return merged.to(s.dtype)

    def _pseudograd_ranks(self, s: torch.Tensor, p: torch.Tensor,
                          weights: list[float] | None) -> torch.Tensor:
        """The float merge under a process group: this rank's partial sum
        of its live rows' weighted (wire) deltas in float32, then one SUM
        all-reduce. Every rank holds the global coefficients, so all agree
        whether any worker survives."""
        coefs = self._merge_coefs(weights)
        if not any(c > 0 for c in coefs):
            return torch.zeros_like(s)
        lo = self.mesh.lo
        merged = torch.zeros(s.shape, dtype=torch.float32, device=s.device)
        live = [w for w in range(self.mesh.local_workers) if coefs[lo + w] > 0]
        if live:
            if self.cfg.outer_comm_dtype is None:
                for w in live:
                    merged.add_(s.float() - p[w].float(), alpha=coefs[lo + w])
            else:
                d = self._wire_quantize(s.unsqueeze(0) - p)
                for w in live:
                    merged.add_(d[w], alpha=coefs[lo + w])
        self.mesh.all_reduce_(merged, "sum", tag="pseudograd", group="diloco")
        return merged.to(s.dtype)

    def _masked_deltas(self, s: torch.Tensor, p: torch.Tensor,
                       weights: list[float] | None) -> torch.Tensor:
        """``s - p`` [rows, ...] in float32 with masked rows zeroed (a dead
        worker's NaN must poison neither the scale nor the integer cast);
        the rows are this rank's under a process group."""
        d = (s.unsqueeze(0) - p).float()
        if weights is not None:
            lo = self.mesh.lo
            keep = torch.tensor([w > 0 for w in weights[lo:lo + p.shape[0]]], device=p.device)
            d = torch.where(keep.view((-1,) + (1,) * (d.ndim - 1)), d,
                            torch.zeros((), device=p.device))
        return d

    @torch.no_grad()
    def shared_scales(self, snapshot: Params, params_w: Params,
                      weights: list[float] | None) -> list[torch.Tensor]:
        """The integer wire's per-leaf shared scales: the survivors'
        absmax / q_max of every leaf, the absmaxes taken across the ranks
        (every shard of every worker group) by one MAX all-reduce of an
        f32 [n_leaves] vector."""
        q_max = self._int_wire[0]
        amax = torch.stack([
            torch.linalg.vector_norm(self._masked_deltas(s, p.detach(), weights),
                                     ord=float("inf"))
            for s, p in zip(tree_leaves(snapshot), tree_leaves(params_w))
        ]).float()
        if self.mesh.distributed:
            self.mesh.all_reduce_(amax, "max", tag="scale", group="all")
        return [_div(a, q_max).clamp_min(_TINY) for a in amax]

    @torch.no_grad()
    def integer_wire_payload(self, s: torch.Tensor, p: torch.Tensor,
                             weights: list[float] | None,
                             scale: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
        """What every worker puts on the integer wire for one leaf: the
        deltas ``s - p`` [W, ...] with masked rows zeroed first (a dead
        worker's NaN must poison neither the scale nor the integer cast),
        quantized with one scale shared by every worker (the survivors'
        absmax / q_max, over every rank's rows under a process group).
        Returns (integers in the wire's storage dtype, the float32
        scale)."""
        q_max, storage, _ = self._int_wire
        d = self._masked_deltas(s, p, weights)
        if scale is None:
            amax = torch.linalg.vector_norm(d, ord=float("inf")).float()
            if self.mesh.distributed:
                self.mesh.all_reduce_(amax.reshape(1), "max", tag="scale", group="all")
            scale = _div(amax, q_max).clamp_min(_TINY)
        return (d / scale).round_().clamp_(-q_max, q_max).to(storage), scale

    def _integer_wire_leaf(self, s: torch.Tensor, p: torch.Tensor,
                           weights: list[float] | None,
                           scale: torch.Tensor | None = None) -> torch.Tensor:
        """The integer wire (JAX ``_pseudograd_integer_wire``) for one
        leaf: the payload's integers summed in the accumulator dtype
        (exact: ``W * q_max`` fits), across the ranks on the collective
        under a process group, the sum dequantized and divided by the
        survivor count (from the gathered mask, on the host)."""
        W = self.cfg.num_workers
        q_max = self._int_wire[0]
        q, scale = self.integer_wire_payload(s, p, weights, scale)
        acc = _wire_accumulator_dtype(W, q_max)
        total = q.sum(dim=0, dtype=acc)
        if self.mesh.distributed:
            if acc == torch.int16:
                total = _packed_int16_sum(self.mesh, total, int(W * q_max))
            else:
                self.mesh.all_reduce_(total, "sum", tag="pseudograd", group="diloco")
        denom = float(W) if weights is None else max(sum(weights), 1.0)
        return _div(total.float() * scale, denom).to(s.dtype)

    # -- byte accounting -------------------------------------------------------

    def _tree_size(self, snapshot: Params | None) -> tuple[int, int]:
        if snapshot is not None:
            leaves = tree_leaves(snapshot)
            return sum(t.numel() for t in leaves), len(leaves)
        n_leaves = (len(layer_keys(self.model_cfg)) + 2
                    + (0 if self.model_cfg.tie_word_embeddings else 1))
        return self.model_cfg.num_params(), n_leaves

    def sync_payload_report(self) -> dict:
        """What one outer sync moves per worker, by wire mode:
        ``{"bytes_per_sync", "wire", "guaranteed", "f32_bytes"}``. Only the
        integer wire's payload is narrow (``guaranteed``): every other
        mode dequantizes to float32 before the mean."""
        n = self.model_cfg.num_params()
        f32 = 4 * n
        cfg = self.cfg
        if cfg.outer_comm_dtype is None:
            return {"bytes_per_sync": f32, "wire": "f32 (unquantized)",
                    "guaranteed": False, "f32_bytes": f32}
        if not cfg.outer_wire_collective:
            return {"bytes_per_sync": f32,
                    "wire": f"{cfg.outer_comm_dtype} numerics only (f32 mean; set "
                            "outer_wire_collective to narrow the payload)",
                    "guaranteed": False, "f32_bytes": f32}
        acc = _wire_accumulator_dtype(cfg.num_workers, self._int_wire[0]).itemsize
        return {"bytes_per_sync": acc * n,
                "wire": f"{cfg.outer_comm_dtype} payload on an s{acc * 8} sum",
                "guaranteed": True, "f32_bytes": f32}

    def sync_wire_bytes(self, snapshot: Params | None = None) -> dict:
        """Per-worker wire bytes of one outer-sync round (JAX
        ``sync_wire_bytes``): ``wire_bytes_per_sync``,
        ``raw_bytes_per_sync`` (the f32 wire), ``wire_compression`` (raw /
        wire) and ``wire_overhead_bytes`` (the integer wire's per-tensor
        scales and survivor count). ``snapshot`` supplies the synced
        tree's actual sizes (a rank's shards: its share of the sync); else
        the model config's."""
        n, n_leaves = self._tree_size(snapshot)
        raw = 4 * n
        if self.cfg.outer_wire_collective:
            acc = _wire_accumulator_dtype(self.cfg.num_workers, self._int_wire[0]).itemsize
            overhead = 4 * n_leaves + 4
            wire = acc * n + overhead
        else:
            overhead, wire = 0, raw
        return {
            "wire_bytes_per_sync": int(wire),
            "raw_bytes_per_sync": int(raw),
            "wire_compression": round(raw / wire, 4) if wire else 1.0,
            "wire_overhead_bytes": int(overhead),
        }

    # -- quarantine ------------------------------------------------------------

    @torch.no_grad()
    def replica_finite_mask(self, params_w: Params) -> torch.Tensor:
        """[W] bool: worker w's replica holds only finite values (the exact
        quarantine criterion: a loss is computed before the step's update,
        so a blow-up on a round's last update shows only here)."""
        W = self.mesh.local_workers
        flags = [torch.isfinite(p).reshape(W, -1).all(dim=1) for p in tree_leaves(params_w)]
        local = torch.stack(flags).all(dim=0)
        if not self.mesh.distributed:
            return local
        if self.mesh.sharded:  # finite only if every shard is
            bad = (~local).to(torch.int32)
            self.mesh.all_reduce_(bad, "max", tag="mask", group="shard")
            local = bad == 0
        return self.mesh.all_gather(local.to(torch.uint8), tag="mask",
                                    group="diloco").to(torch.bool)

    # -- outer step (the only cross-worker traffic) --------------------------

    def _merge_weights(self, worker_mask, budget) -> list[float] | None:
        """Host [W] weights of the merge: the mask (0/1) times the realized
        step budgets, None when neither is given. Under a process group
        each rank's budgets for its own workers are gathered, so every
        rank merges with the same weights."""
        if budget is not None and self.mesh.distributed:
            mine = torch.tensor(list(budget)[self.mesh.lo:self.mesh.hi], dtype=torch.int32,
                                device=self.device)
            budget = self.mesh.all_gather(mine, tag="budget", group="diloco").tolist()
        weights = None
        if worker_mask is not None:
            weights = [float(bool(m)) for m in torch.as_tensor(worker_mask).tolist()]
        if budget is not None:
            share = [float(h) for h in budget]
            weights = share if weights is None else [a * b for a, b in zip(share, weights)]
        return weights

    @torch.no_grad()
    def _outer_leaves(
        self,
        snapshot: Params,
        params_w: Params,
        momentum: Params,
        weights: list[float] | None,
        apply: Callable[[int, torch.Tensor, float], None],
        dynamics: bool,
    ) -> dict | None:
        """The outer update, one leaf at a time: the workers' merge (the
        pseudo-gradient), the dynamics readout of the replicas and the
        update, the Nesterov step on the leaf's momentum, then ``apply(i,
        direction, -lr)`` adds ``-lr * direction`` where the mode anchors
        it (classic, async and streaming differ). The readout only reads,
        so the update is the same with it on or off."""
        acc = _Dynamics(self.cfg.num_workers, self.device) if dynamics else None
        cfg = self.cfg
        scales = None
        if cfg.outer_wire_collective and self.mesh.distributed:
            scales = self.shared_scales(snapshot, params_w, weights)
        # a sharded readout counts a whole leaf on one rank of the group
        count = [not self.mesh.sharded or counted(spec_of(n), self.mesh)
                 for n, _ in named_leaves(snapshot)]
        for i, (s, p, buf) in enumerate(zip(tree_leaves(snapshot), tree_leaves(params_w),
                                            tree_leaves(momentum))):
            p = p.detach()
            delta = self._pseudograd_of(s, p, weights, None if scales is None else scales[i])
            if acc is not None:
                self._read_replicas(acc, s, p, count[i])
            direction = nesterov_direction(delta, buf, cfg.outer_momentum, cfg.nesterov)
            if acc is not None and count[i]:
                acc.add_update(delta, direction, buf)
            del delta
            apply(i, direction, -cfg.outer_lr)
        if acc is not None and self.mesh.sharded:
            acc.sum_over(self.mesh, "shard")
        return None if acc is None else acc.result()

    def _read_replicas(self, acc: _Dynamics, s: torch.Tensor, p: torch.Tensor,
                       count: bool = True) -> None:
        """The readout of one leaf's replicas. Its pairwise drift needs
        every replica, so under a process group the rows are gathered over
        the diloco group, in slices of at most ``_GATHER_ELEMS`` elements
        a worker (the sums it accumulates split over slices; a smaller
        leaf is the one-process arithmetic on the same values). A leaf
        this rank does not ``count`` is gathered and not added."""
        if not self.mesh.distributed:
            acc.add_replicas(s, p)
            return
        flat_s, flat_p = s.reshape(-1), p.reshape(p.shape[0], -1)
        for lo in range(0, flat_s.numel(), _GATHER_ELEMS):
            hi = lo + _GATHER_ELEMS
            rows = self.mesh.all_gather(flat_p[:, lo:hi], tag="dynamics", group="diloco")
            if count:
                acc.add_replicas(flat_s[lo:hi], rows)

    @torch.no_grad()
    def outer_step(self, state: DilocoState, worker_mask=None):
        """Nesterov SGD on the snapshot with the (masked, weighted, wire)
        pseudo-gradient, then every worker reset to the new snapshot.
        Returns ``(state, effective_mask, dynamics)``: the [W] bool mask of
        the workers that entered the mean (caller's mask AND replica
        finiteness under quarantine; all true otherwise) and the dynamics
        dict (None unless ``dynamics_metrics``). ``worker_mask`` is global
        ([W]) under a process group too."""
        W = self.cfg.num_workers
        if worker_mask is not None:
            worker_mask = torch.as_tensor(worker_mask).to(torch.bool)
        if self.cfg.quarantine_nonfinite:
            pmask = self.replica_finite_mask(state.params).cpu()
            worker_mask = pmask if worker_mask is None else (worker_mask.cpu() & pmask)
            state.inner_opt.reset_moments(worker_mask.tolist()[self.mesh.lo:self.mesh.hi])
        weights = self._merge_weights(worker_mask, self._h_budget)
        eff = (torch.ones(W, dtype=torch.bool) if weights is None
               else torch.tensor([w > 0 for w in weights]))
        self._fetch(state)
        snaps, workers = tree_leaves(state.snapshot), tree_leaves(state.params)

        def reset(i: int, direction: torch.Tensor, alpha: float) -> None:
            snaps[i].add_(direction, alpha=alpha)
            workers[i].copy_(snaps[i].unsqueeze(0).expand_as(workers[i]))

        dyn = self._outer_leaves(state.snapshot, state.params, state.outer_opt_state,
                                 weights, reset, self.cfg.dynamics_metrics)
        self._offload(state)
        return state, eff, dyn

    def round_step(self, state: DilocoState, tokens, loss_mask):
        """One full round: ``inner_round``, then the outer sync. Returns
        (state, [H, W] losses, [W] effective mask), plus the dynamics dict
        as a 4th element under ``dynamics_metrics``. Under quarantine a
        non-finite round loss is one more reason to mask a worker. Under a
        process group the losses are gathered to [H, W]."""
        state, losses = self.inner_round(state, tokens, loss_mask)
        losses = self.gather_workers(losses, dim=1)
        wmask = torch.isfinite(losses).all(dim=0) if self.cfg.quarantine_nonfinite else None
        state, eff, dyn = self.outer_step(state, wmask)
        if self.cfg.dynamics_metrics:
            return state, losses, eff, dyn
        return state, losses, eff

    # -- async delayed-apply outer step --------------------------------------

    @torch.no_grad()
    def _async_boundary(self, state: AsyncDilocoState, budget: list[int] | None):
        """Launch this round's outer update and apply the oldest pending
        merge (JAX ``_async_boundary``). The pseudo-gradient is measured
        from ``snapshot``, the base the round's workers started from; the
        Nesterov update is anchored at the newest pending merge (the head
        of the outer trajectory), so the gradient is ``outer_delay``
        updates stale. Every worker resets to ``pending[0]``, which
        becomes the snapshot. With delay 0 the head is the snapshot and
        the apply is the new merge: the classic outer step, op for op.
        Returns ``(state, aux)`` with ``boundary_round``,
        ``applied_launch_round`` (0: an init slot), ``outer_staleness``
        and, under ``dynamics_metrics``, ``dynamics``."""
        d = self.cfg.outer_delay
        weights = self._merge_weights(None, budget)
        snaps, workers = tree_leaves(state.snapshot), tree_leaves(state.params)
        slot0 = tree_leaves(state.pending[0])
        heads = tree_leaves(state.pending[-1]) if d > 0 else snaps

        def launch_and_apply(i: int, direction: torch.Tensor, alpha: float) -> None:
            s, p = snaps[i], workers[i]
            if d > 0:
                s.copy_(slot0[i])                 # apply the oldest merge
                if heads[i] is not slot0[i]:
                    slot0[i].copy_(heads[i])
                slot0[i].add_(direction, alpha=alpha)  # its slot takes the new one
            else:
                s.add_(direction, alpha=alpha)
                slot0[i].copy_(s)
            p.copy_(s.unsqueeze(0).expand_as(p))

        dyn = self._outer_leaves(state.snapshot, state.params, state.outer_opt_state,
                                 weights, launch_and_apply, self.cfg.dynamics_metrics)
        rnd = state.inner_step_count // self.cfg.inner_steps
        if d > 0:
            applied = state.pending_round[0]
            state.pending = state.pending[1:] + state.pending[:1]
            state.pending_round = state.pending_round[1:] + [rnd]
        else:
            applied = rnd
            state.pending_round = [rnd]
        state.launched_round = rnd
        aux = {"boundary_round": rnd, "applied_launch_round": applied,
               "outer_staleness": rnd - applied}
        if dyn is not None:
            aux["dynamics"] = dyn
        return state, aux

    def async_boundary(self, state: AsyncDilocoState):
        """The round boundary with the current budgets: (state, aux)."""
        return self._async_boundary(state, self._h_budget)

    def async_deferred_boundary(self, state: AsyncDilocoState):
        """The boundary of the round that ran last, its deltas weighted
        with the budgets that round ran under (which a straggler retarget
        may have changed since): (state, aux)."""
        prev = self._h_budget if self._h_budget_prev is None else self._h_budget_prev
        return self._async_boundary(state, prev)

    def async_round_step(self, state: AsyncDilocoState, tokens, loss_mask):
        """One steady-state async round, boundary FIRST: launch the previous
        round's outer update and apply the pending merge
        (``async_deferred_boundary``), then this round's H inner steps,
        which depend only on the applied merge. Returns (state, [H, W]
        losses, aux)."""
        state, aux = self.async_deferred_boundary(state)
        state, losses = self.inner_round(state, tokens, loss_mask)
        return state, losses, aux

    @torch.no_grad()
    def async_drain(self, state: AsyncDilocoState) -> AsyncDilocoState:
        """Apply every remaining pending merge without launching (the newest
        becomes the model); the slots refill with init-marked copies, so
        the drained state is a valid warm-up state for an extended run."""
        if self.cfg.outer_delay == 0:
            return state
        final = tree_leaves(state.pending[-1])
        for s, p, f in zip(tree_leaves(state.snapshot), tree_leaves(state.params), final):
            s.copy_(f)
            p.copy_(s.unsqueeze(0).expand_as(p))
        for slot in state.pending:
            for t, s in zip(tree_leaves(slot), tree_leaves(state.snapshot)):
                t.copy_(s)
        state.pending_round = [0] * len(state.pending)
        return state

    def async_flush(self, state: AsyncDilocoState):
        """The final boundary, then the drain: (state, aux)."""
        state, aux = self.async_boundary(state)
        return self.async_drain(state), aux

    # -- snapshot host offload -------------------------------------------------

    def _offload_on(self) -> bool:
        return self.cfg.offload_snapshot and self.device.type == "cuda"

    @torch.no_grad()
    def _offload(self, state: DilocoState) -> DilocoState:
        """Move the snapshot to pinned host memory (its buffers allocated
        once and reused), freeing its device memory between syncs. A
        failure to pin raises. On the CPU the snapshot already lives on
        the host: the identity."""
        if not self._offload_on() or tree_leaves(state.snapshot)[0].device.type == "cpu":
            return state
        if self._host_snapshot is None:
            self._host_snapshot = tree_map(
                lambda s: torch.empty(s.shape, dtype=s.dtype, pin_memory=True),
                state.snapshot,
            )
        for h, s in zip(tree_leaves(self._host_snapshot), tree_leaves(state.snapshot)):
            h.copy_(s)
        state.snapshot = self._host_snapshot
        return state

    @torch.no_grad()
    def _fetch(self, state: DilocoState) -> DilocoState:
        """Inverse of ``_offload``: the snapshot back on the device."""
        if self._offload_on() and tree_leaves(state.snapshot)[0].device.type == "cpu":
            state.snapshot = tree_map(
                lambda h: h.to(self.device, non_blocking=True), state.snapshot
            )
        return state

    def device_snapshot(self, state: DilocoState) -> Params:
        """The snapshot on the device (a temporary copy when offloaded), for
        an evaluation or any other reader on the card."""
        if self._offload_on():
            return tree_map(lambda h: h.to(self.device, non_blocking=True), state.snapshot)
        return state.snapshot

