"""The DiLoCo training job: port of
``nanodiloco_tpu/training/train_loop.py::train``.

Data (synthetic text, packed or padded, or a pre-tokenized ``.tshrd``
shard) -> a deterministic per-worker batcher -> rounds of ``inner_steps``
inner steps and one outer sync until ``total_steps``. Around the rounds:

- round-ahead prefetch: one worker thread stacks the next round's
  batches into (pinned, on the card) host tensors while this round runs;
- the metrics JSONL (``training/metrics.py``) in the JAX fused path's
  layout: one record per inner step, with the phase budget ``t_*`` of
  the round; the round's last record adds the evaluation and sync keys:
  the wire bytes (``wire_bytes_per_sync``, ``wire_compression``,
  ``wire_bytes_total``), the dynamics readout (``pg_norm``,
  ``drift_max``, ``drift_mean``, ``outer_momentum_norm``,
  ``outer_update_cos``; on by default, as in the JAX package),
  ``quarantined_workers``, ``workers_active``, ``inner_steps_realized``
  and the outer mode (``async_outer`` / ``outer_delay``, or streaming's
  ``outer_staleness``);
- the DiLoCo options of the JAX ``TrainConfig``: quarantine, the
  quantized and integer outer wires, heterogeneous H with the straggler
  policy (``training/elastic.py``; its schedule sidecar on save and
  resume), the async outer step (boundary first in each round, one
  record per boundary, a flush after the last round), streaming DiLoCo
  (``parallel/streaming.py``) and the snapshot offload;
- held-out evaluation of the snapshot every ``eval_every`` syncs, plus a
  final one; in an MoE model, after every sync, the router probe
  (``models/moe.py::make_router_stats_fn``) on the snapshot and one
  microbatch, whose ``moe_dropped_frac`` and ``moe_router_entropy`` go on
  the synced record (both inside the ``eval`` span);
- a checkpoint every ``checkpoint_every`` syncs, plus a final one, and a
  bit-exact resume from the latest (``restore_elastic`` when the worker
  count changed);
- preemption: SIGTERM/SIGINT checkpoint at the next round boundary and
  exit with code 75;
- weights from an HF checkpoint (``init_hf``, streamed tensor by tensor
  by ``models/hf_interop.py``; a resumable checkpoint still wins), an HF
  tokenizer and an HF ``datasets`` directory;
- the training job's resilience and observability, as in the JAX loop:
  the goodput ledger (opened first; a ``goodput`` snapshot per round and
  at teardown, the supervisor's relaunch gap booked as
  ``restart_downtime``), the fault plan (armed at cursor 0 before the
  startup IO; its hooks in the checkpoint manager, the data fetch, the
  prefetch thread and the round), the watchdog (its sentinels fed only
  after the round's losses are on the host; ``watch_action
  checkpoint-exit`` checkpoints at the next boundary and exits 76), the
  per-program device-time ledgers (``devtime``), the one-time
  ``cost_analysis`` record (``obs/costs.py``) and the live telemetry
  endpoint (``metrics_port``).

The straggler policy reads per-worker round seconds as the JAX loop
models them: the shared round wall time scaled by each worker's realized
step share, plus the seconds an injected ``straggler`` fault slept for
that worker inside the round's clock (split out of ``t_inner`` as
``t_straggler`` and booked as ``straggler_wait``). Those extras are the
only per-worker skew one stacked program has, so the policy demotes a
worker only under such a fault.

Returns a summary with the JAX keys (``final_loss``, ``steps``,
``avg_sync_time_s``, ``comm_share``, the wire keys, the async and
heterogeneous-H keys, ``alarms``, ``run_name``, ``state``, the final
eval keys) and per-step [W] losses, throughput, peak device memory and
the flash kernels' launch counts over the run.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from nanodiloco_tpu_torch.data.pipeline import (
    DilocoBatcher,
    ShardBatcher,
    load_hf_dataset_texts,
    pack_corpus,
    pad_corpus,
    synthetic_corpus,
)
from nanodiloco_tpu_torch.data.tokenizer import get_tokenizer
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import Params, resolve_device, tree_leaves, tree_map
from nanodiloco_tpu_torch.models.moe import make_router_stats_fn
from nanodiloco_tpu_torch.obs import flightrec
from nanodiloco_tpu_torch.obs.costs import build_cost_record, microbatch_flops
from nanodiloco_tpu_torch.obs.devtime import DispatchAccountant
from nanodiloco_tpu_torch.obs.goodput import GoodputLedger
from nanodiloco_tpu_torch.obs.tracer import SpanTracer, set_tracer, trace_span
from nanodiloco_tpu_torch.obs.watchdog import Watchdog, WatchdogConfig
from nanodiloco_tpu_torch.ops.cuda.flash_attention import (
    launch_counts,
    shape_counts,
    variant_counts,
)
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig, host_dynamics
from nanodiloco_tpu_torch.parallel.streaming import StreamingConfig, StreamingDiloco
from nanodiloco_tpu_torch.resilience import faults
from nanodiloco_tpu_torch.resilience.retry import RetryPolicy, retry_call
from nanodiloco_tpu_torch.resilience.supervisor import (
    DOWNTIME_ENV,
    PREEMPT_EXIT_CODE,
    RESTART_ENV,
    WATCHDOG_EXIT_CODE,
    WORKERS_TARGET_ENV,
)
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.elastic import (
    StragglerPolicy,
    resume_budgets,
    save_schedule,
)
from nanodiloco_tpu_torch.training.evaluate import Evaluator, holdout_batches
from nanodiloco_tpu_torch.training.metrics import MetricsLogger, SyncTimer
from nanodiloco_tpu_torch.utils import create_run_name, device_memory_stats


class _EmergencyExit(Exception):
    """The graceful-stop paths (preemption, watchdog checkpoint-exit, a
    resize request): raised at a round boundary after the emergency
    checkpoint, caught at the bottom of ``train`` and turned into
    ``SystemExit(code)`` once teardown has run, so the supervisor reads a
    distinct exit class."""

    def __init__(self, code: int, reason: str) -> None:
        super().__init__(f"{reason} (exit code {code})")
        self.code = code
        self.reason = reason


def _stall_escalate_s() -> float:
    """Grace window between a stall alarm (under ``watch_action
    checkpoint-exit``) and the hard ``os._exit``: a wedged loop cannot
    reach its own boundary check, so the watchdog thread pulls the plug
    from outside and the latest cadence checkpoint is the resume point."""
    return float(os.environ.get("NANODILOCO_STALL_ESCALATE_S", "120"))


def _env_number(name: str, kind: type, default):
    try:
        return kind(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclasses.dataclass
class TrainConfig:
    """The subset of the JAX ``TrainConfig`` the port runs (same names and
    defaults)."""

    seed: int = 1337
    batch_size: int = 256           # per-worker batch (microbatches x B)
    per_device_batch_size: int = 8
    seq_length: int = 1024
    warmup_steps: int = 100
    total_steps: int = 10_000
    inner_steps: int = 100
    lr: float = 4e-4
    outer_lr: float = 0.7
    # a pre-tokenized tokenshard file (scripts/torch_prepare_data.py) or
    # an HF datasets.save_to_disk directory; None -> the synthetic corpus
    dataset_path: str | None = None
    # "packed": eos-joined token stream cut into fixed [N, S] rows.
    # "padded": one document per row, pad positions masked out of the
    # loss (and out of attention under dense attention only)
    data_layout: str = "packed"
    num_workers: int = 1
    # fence the device around the outer step, so avg_sync_time_s and
    # comm_share time the sync alone; off, the outer step runs behind the
    # inner steps unfenced and those keys are None
    measure_comm: bool = True
    # streaming DiLoCo (arXiv:2501.18512); 0 = classic
    streaming_fragments: int = 0
    streaming_delay: int = 1
    merge_alpha: float = 1.0
    # the outer pseudo-gradient's wire: a float dtype (a cast, e.g.
    # "bfloat16") or a signed int (absmax quantization, e.g. "int8",
    # "int4"); see parallel/diloco.py
    outer_comm_dtype: str | None = None
    # one shared scale and an integer sum (needs a signed-int wire)
    outer_wire_collective: bool = False
    # mask a worker with a non-finite replica or loss out of the outer
    # mean; the sync's reset heals it
    quarantine_nonfinite: bool = False
    # the DiLoCo dynamics readout in every sync record (classic rounds;
    # ignored, with a notice, under streaming). A pure readout: losses
    # and params are bit-identical on or off
    dynamics_metrics: bool = True
    # the async delayed-apply outer step (classic rounds only)
    async_outer: bool = False
    outer_delay: int = 1
    # heterogeneous per-worker H: initial budgets, one per worker
    inner_steps_per_worker: tuple[int, ...] | None = None
    # straggler policy (training/elastic.py): > 1 turns it on (and
    # heterogeneous H with it); 0 disables. It demotes on the seconds an
    # injected straggler fault sleeps (see the module docstring)
    straggler_factor: float = 0.0
    straggler_min_steps: int = 1
    model: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    # initialize the weights from an HF Llama checkpoint (sharded or
    # single-file safetensors); disables fit_vocab; a resumable
    # checkpoint still wins over it
    init_hf: str | None = None
    tokenizer: str | None = None     # HF name/path (local files); None -> byte level
    # shrink vocab_size to the tokenizer's vocabulary (rounded up to 128)
    fit_vocab: bool = True
    # park the snapshot in pinned host memory between syncs
    offload_snapshot: bool = False
    eval_every: int = 0       # evaluate the snapshot every N outer syncs (0=off)
    eval_batches: int = 8     # held-out batches (never trained on)
    # Chrome trace-event JSON of the host-side round phases
    trace_out: str | None = None
    # live status.json (atomic rewrite) for external pollers
    status_file: str | None = None
    # live telemetry endpoint (/metrics, /healthz, POST /debug/profile);
    # None = no server; 0 = a free port (printed)
    metrics_port: int | None = None
    # log the one-time cost_analysis record (analytic FLOPs/token and the
    # card's peak; obs/costs.py)
    cost_analysis: bool = True
    # watchdog sentinels (obs/watchdog.py): loss-spike z-score over a
    # rolling window, throughput collapse against the rolling median,
    # stalled-round factor over the rolling round time (0 disables the
    # heartbeat thread), the drift_max divergence threshold (0 = off)
    watch_loss_zscore: float = 6.0
    watch_loss_window: int = 32
    watch_tps_collapse: float = 0.4
    watch_stall_factor: float = 5.0
    watch_drift: float = 0.0
    # what a fatal alarm (stall / nan_loss) does: "checkpoint-exit"
    # checkpoints at the next round boundary and exits 76; "none" observes
    watch_action: str = "none"
    # schedule-driven fault injection (resilience/faults.py): a JSON plan
    # of step-keyed faults; None = every hook is one is-None check
    fault_plan: str | None = None
    # SIGTERM/SIGINT checkpoint at the next round boundary and exit 75;
    # main thread only, previous handlers restored at teardown
    preempt_signals: bool = True
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1        # in outer syncs
    resume: bool = True
    log_dir: str | None = "runs"
    quiet: bool = False
    run_name: str | None = None

    @property
    def grad_accum(self) -> int:
        if self.batch_size % self.per_device_batch_size:
            raise ValueError("batch_size must divide evenly by per_device_batch_size")
        return self.batch_size // self.per_device_batch_size


def _fingerprint(tree: Params) -> list[float]:
    """One float64 sum per tensor: cheap evidence that a tensor changed."""
    return [float(p.sum(dtype=torch.float64)) for p in tree_leaves(tree)]


def _fit_model(cfg: TrainConfig, vocab: int, quiet: bool, shard: bool) -> LlamaConfig:
    model_cfg = cfg.model
    if model_cfg.vocab_size < vocab:
        return dataclasses.replace(model_cfg, vocab_size=vocab)
    fitted = ((vocab + 127) // 128) * 128
    # never fit against a .tshrd (its manifest is the vocabulary's
    # authority) nor an HF import (the checkpoint defines the vocabulary)
    if cfg.fit_vocab and not shard and not cfg.init_hf and fitted < model_cfg.vocab_size:
        if not quiet:
            print(f"[nanodiloco] vocab_size {model_cfg.vocab_size} -> {fitted} "
                  f"(tokenizer has {vocab} tokens; fit_vocab=False keeps it)")
        return dataclasses.replace(model_cfg, vocab_size=fitted)
    return model_cfg


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stack_round(batches, inner_steps: int,
                 pin: bool) -> tuple[torch.Tensor, torch.Tensor, float]:
    """Draw one round of batches and stack them into [H, W, accum, B, S]
    host tensors, pinned when they go to a card. The fault plan's stall
    hook runs here, on the prefetch thread, as on the JAX feeder; its
    slept seconds come back third (0.0 without a plan)."""
    stalled = faults.maybe_stall()
    steps = [next(batches) for _ in range(inner_steps)]
    toks = torch.from_numpy(np.stack([t for t, _ in steps]))
    masks = torch.from_numpy(np.stack([m for _, m in steps]))
    if pin:
        toks, masks = toks.pin_memory(), masks.pin_memory()
    return toks, masks, stalled


def _finite_worker_mean(losses: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [H]: the mean over the finite workers (the logged loss
    under quarantine); a row with no finite worker stays NaN."""
    fin = torch.isfinite(losses)
    mean = torch.where(fin, losses, 0.0).sum(-1) / fin.sum(-1).clamp_min(1)
    return torch.where(fin.any(-1), mean, torch.nan)


def train(cfg: TrainConfig, device: str | torch.device = "cuda") -> dict[str, Any]:
    """Run the DiLoCo training job on one device; returns the summary."""
    # the goodput ledger opens first, so every second of this process's
    # lifetime lands in its partition (unspanned setup as `other`); the
    # supervisor's restart ordinal names the lifetime and its measured
    # relaunch gap is booked as restart_downtime
    ledger = GoodputLedger(lifetime=_env_number(RESTART_ENV, int, 0)).start()
    downtime_s = _env_number(DOWNTIME_ENV, float, 0.0)
    if downtime_s > 0:
        ledger.book_external("restart_downtime", downtime_s)
    device = resolve_device(device)
    quiet = cfg.quiet
    if cfg.total_steps % cfg.inner_steps:
        raise ValueError("total_steps must divide evenly by inner_steps")
    if cfg.watch_action not in ("none", "checkpoint-exit"):
        raise ValueError(f"unknown watch_action: {cfg.watch_action!r} "
                         "(use 'none' or 'checkpoint-exit')")
    # the fault plan: validated up front (a typo'd plan fails the launch),
    # then armed at cursor 0 before the startup IO, so step-0 io_error
    # faults hit the dataset fetch and the checkpoint restore; a stale
    # plan of an earlier train() is cleared either way
    faults.clear_plan()
    fault_plan = None
    if cfg.fault_plan:
        fault_plan = faults.FaultPlan.load(cfg.fault_plan)
        for f in fault_plan.faults:
            if f["kind"] in ("nan_params", "straggler") and f["worker"] >= cfg.num_workers:
                raise ValueError(f"fault plan targets worker {f['worker']} but the run "
                                 f"has only {cfg.num_workers} worker(s)")
        fault_plan.advance(0)
        faults.install_plan(fault_plan)
        if not quiet:
            print(f"[nanodiloco] fault plan armed: {len(fault_plan.faults)} fault(s) "
                  f"from {cfg.fault_plan}")
    if cfg.data_layout not in ("packed", "padded"):
        raise ValueError(f"unknown data_layout: {cfg.data_layout!r}")
    if cfg.eval_every and cfg.eval_batches < 1:
        raise ValueError("--eval-every requires --eval-batches >= 1")
    padded = cfg.data_layout == "padded"
    shard = bool(cfg.dataset_path) and cfg.dataset_path.endswith(".tshrd")
    streaming = cfg.streaming_fragments > 0
    # the dynamics are a classic-rounds readout (streaming has no single
    # whole-model sync point)
    dynamics_on = cfg.dynamics_metrics and not streaming
    if cfg.dynamics_metrics and not dynamics_on and not quiet:
        print("[nanodiloco] dynamics metrics disabled: streaming DiLoCo has no "
              "single sync point to read whole-model drift at")
    async_on = cfg.async_outer and not streaming
    if cfg.async_outer and not async_on:
        raise ValueError(
            "--async-outer is classic-rounds-only: streaming DiLoCo is already the "
            "fragment-granularity async outer step (its launch/apply split is "
            "--streaming-delay inner steps); a second round-granularity delay would "
            "double-defer the same merges"
        )
    # heterogeneous per-worker H: an explicit schedule, or the straggler
    # policy's budget lever; classic rounds only
    hetero_on = cfg.inner_steps_per_worker is not None or cfg.straggler_factor > 0
    if hetero_on and streaming:
        raise ValueError(
            "--inner-steps-per-worker / --straggler-factor are classic-rounds-only: "
            "streaming's fragment cadence assumes the uniform inner-step index"
        )
    hetero_budgets = (
        list(cfg.inner_steps_per_worker) if cfg.inner_steps_per_worker is not None
        else [cfg.inner_steps] * cfg.num_workers
    ) if hetero_on else None
    if padded and cfg.model.attention_impl != "dense" and not quiet:
        print(
            "[nanodiloco] warning: --data-layout padded with attention "
            f"{cfg.model.attention_impl}: the attention padding mask is ignored by "
            "this kernel (loss is unaffected for tail padding; dense attention "
            "honors the mask)"
        )
    tokenizer = get_tokenizer(cfg.tokenizer)
    model_cfg = _fit_model(cfg, tokenizer.vocab_size, quiet, shard)

    eval_needed = cfg.eval_batches * cfg.per_device_batch_size if cfg.eval_every else 0
    eval_rows, eval_mask_rows = None, None
    sidecar_tokenizer = cfg.tokenizer  # a .tshrd manifest overrides it below
    if shard:
        if padded:
            raise ValueError(
                "--data-layout padded cannot be used with a .tshrd dataset "
                "(tokenshards are pre-packed)"
            )
        batcher = ShardBatcher(
            cfg.dataset_path, num_workers=cfg.num_workers, grad_accum=cfg.grad_accum,
            per_device_batch=cfg.per_device_batch_size, seed=cfg.seed,
            holdout_rows=eval_needed,
        )
        if eval_needed:
            eval_rows = batcher.holdout_data()
        if batcher.seq_len != cfg.seq_length:
            raise ValueError(
                f"--seq-length {cfg.seq_length} does not match the shard's "
                f"sequence length {batcher.seq_len} ({cfg.dataset_path}); shards "
                "are pre-packed — re-run scripts/torch_prepare_data.py to change it"
            )
        # the shard was tokenized at prepare time: its manifest sizes the
        # vocabulary and names the tokenizer the checkpoint sidecar records
        manifest_path = cfg.dataset_path + ".manifest.json"
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                manifest = json.load(f)
            shard_vocab = int(manifest["vocab_size"])
            if model_cfg.vocab_size < shard_vocab:
                model_cfg = dataclasses.replace(model_cfg, vocab_size=shard_vocab)
            mt = manifest.get("tokenizer")
            sidecar_tokenizer = None if mt in (None, "byte-level") else mt
    else:
        if cfg.dataset_path:
            def _fetch_texts():
                faults.check_io("fetch")  # injection hook (io_error op=fetch)
                return load_hf_dataset_texts(cfg.dataset_path)

            # a transient read failure retries with backoff
            texts = retry_call(
                _fetch_texts, op="dataset_fetch",
                policy=RetryPolicy(max_attempts=3, base_delay_s=0.5, max_delay_s=4.0,
                                   deadline_s=60.0),
            )
        else:
            texts = synthetic_corpus(seed=cfg.seed)
        if padded:
            rows, row_mask = pad_corpus(texts, tokenizer, cfg.seq_length)
        else:
            rows, row_mask = pack_corpus(texts, tokenizer, cfg.seq_length), None
        if eval_needed:
            if eval_needed >= len(rows):
                raise ValueError(
                    f"eval holdout of {eval_needed} rows leaves no training "
                    f"data ({len(rows)} rows total)"
                )
            eval_rows, rows = rows[-eval_needed:], rows[:-eval_needed]
            if row_mask is not None:
                eval_mask_rows, row_mask = row_mask[-eval_needed:], row_mask[:-eval_needed]
        batcher = DilocoBatcher(
            rows, num_workers=cfg.num_workers, grad_accum=cfg.grad_accum,
            per_device_batch=cfg.per_device_batch_size, seed=cfg.seed, mask=row_mask,
        )

    dcfg = DilocoConfig(
        num_workers=cfg.num_workers, inner_steps=cfg.inner_steps,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps, lr=cfg.lr,
        outer_lr=cfg.outer_lr, grad_accum=cfg.grad_accum,
        offload_snapshot=cfg.offload_snapshot, outer_comm_dtype=cfg.outer_comm_dtype,
        outer_wire_collective=cfg.outer_wire_collective,
        quarantine_nonfinite=cfg.quarantine_nonfinite, dynamics_metrics=dynamics_on,
        async_outer=cfg.async_outer, outer_delay=cfg.outer_delay,
        inner_steps_per_worker=tuple(hetero_budgets) if hetero_on else None,
    )
    if streaming:
        dl = StreamingDiloco(model_cfg, dcfg, StreamingConfig(
            num_fragments=cfg.streaming_fragments, delay=cfg.streaming_delay,
            merge_alpha=cfg.merge_alpha,
        ), device)
    else:
        dl = Diloco(model_cfg, dcfg, device)
    if cfg.num_workers > 1 and not quiet:
        rep = dl.sync_payload_report()
        print(f"[nanodiloco] outer-sync payload: {rep['bytes_per_sync'] / 1e6:.1f} "
              f"MB/worker ({rep['wire']}; f32 would be {rep['f32_bytes'] / 1e6:.1f} MB)")
    if cfg.init_hf:
        from nanodiloco_tpu_torch.models.hf_interop import from_hf_pretrained

        if not quiet:
            print(f"[nanodiloco] initializing weights from {cfg.init_hf}")
        state = dl.init_state(params=from_hf_pretrained(cfg.init_hf, model_cfg, device))
    else:
        state = dl.init_state(torch.Generator(device=device).manual_seed(cfg.seed))
    on_cuda = device.type == "cuda"

    ckpt = None
    logger: MetricsLogger | None = None
    resume_rec: dict | None = None
    # elastic records decided before the logger exists (a width change
    # at resume, an H-schedule reset), logged once it does
    elastic_pending: list[dict] = []
    # retry records of the startup restore, logged once the logger exists
    pre_logger_events: list[dict] = []

    def _ckpt_event(rec: dict) -> None:
        if logger is not None:
            logger.log(rec)
        else:
            pre_logger_events.append(rec)

    if cfg.checkpoint_dir:
        ckpt = CheckpointManager(
            cfg.checkpoint_dir,
            retry=RetryPolicy(max_attempts=4, base_delay_s=0.25, max_delay_s=4.0,
                              deadline_s=60.0),
            on_event=_ckpt_event,
        )
        # self-describing checkpoints: the model is rebuilt from this
        # sidecar alone, without the training flags
        with open(os.path.join(cfg.checkpoint_dir, "model_config.json"), "w") as f:
            json.dump({"model": dataclasses.asdict(model_cfg),
                       "num_workers": cfg.num_workers,
                       "tokenizer": sidecar_tokenizer}, f, indent=1)
        if cfg.resume and ckpt.latest_step is not None:
            t_restore0 = time.perf_counter()
            saved_w = ckpt.saved_worker_count()
            if saved_w == cfg.num_workers:
                ckpt.restore(state)
            else:
                if not quiet:
                    print(f"[nanodiloco] elastic resume: checkpoint has {saved_w} "
                          f"workers, run has {cfg.num_workers}; snapshot/outer state "
                          "restored exactly, inner moments reset (LR schedule continues)")
                ckpt.restore_elastic(state)
                elastic_pending.append({
                    "elastic": "resize_widen" if cfg.num_workers > saved_w else "resize_shrink",
                    "workers_from": saved_w, "workers_to": cfg.num_workers,
                })
            _fence(device)
            t_restore = time.perf_counter() - t_restore0
            ledger.note("resume_restore", t_restore)
            resume_rec = {
                "resume": ckpt.latest_step,
                "elastic": saved_w != cfg.num_workers,
                "restart_count": _env_number(RESTART_ENV, int, 0),
                "t_restore": round(t_restore, 6),
            }
    # the heterogeneous-H schedule: the sidecar's budgets at unchanged
    # width (a bit-exact resume keeps its schedule too); a width change
    # resets to the configured schedule
    straggler_policy: StragglerPolicy | None = None
    if hetero_on:
        budgets, demotions0, sched_reset = resume_budgets(
            cfg.checkpoint_dir, cfg.num_workers,
            cfg.inner_steps, hetero_budgets,
        )
        if sched_reset:
            elastic_pending.append({"elastic": "h_schedule_reset",
                                    "workers_to": cfg.num_workers,
                                    "inner_steps_per_worker": list(budgets)})
        dl.set_inner_budget(budgets)
        if cfg.straggler_factor > 0:
            straggler_policy = StragglerPolicy(
                cfg.inner_steps, cfg.num_workers, cfg.straggler_factor,
                cfg.straggler_min_steps, initial=budgets,
            )
            straggler_policy.demotions_total = demotions0
    if on_cuda:
        _fence(device)
        torch.cuda.reset_peak_memory_stats(device)

    run_name = cfg.run_name or create_run_name("nanodiloco-torch", {"nodes": cfg.num_workers})
    logger = MetricsLogger(run_name, out_dir=cfg.log_dir, quiet=quiet)
    for rec in pre_logger_events:
        logger.log(rec)
    if resume_rec is not None:
        logger.log(resume_rec, step=resume_rec["resume"])
    for rec in elastic_pending:
        logger.log({**rec, "t_unix": round(time.time(), 3)},
                   step=resume_rec["resume"] if resume_rec else 0)
    sync_timer = SyncTimer()
    # the per-phase t_* totals flow into the JSONL either way; the event
    # list is kept only when --trace-out will export it
    tracer = SpanTracer(max_events=500_000 if cfg.trace_out else 0)
    # per-program device-time ledgers: the loop's own fenced round and
    # outer-step times, recorded (the first of each books as compile)
    devtime_acct = DispatchAccountant()
    devtime_layout = f"w{cfg.num_workers}"
    recorder = flightrec.FlightRecorder(
        dump_path=os.path.join(cfg.log_dir, f"{run_name}-blackbox.json")
        if cfg.log_dir else None
    )

    # ONE latch for every graceful-stop source (a signal, a fatal watchdog
    # alarm under checkpoint-exit, a resize fault), polled at round
    # boundaries; the first request wins
    stop_latch: dict[str, Any] = {"reason": None, "code": None}

    def _request_stop(reason: str, code: int) -> None:
        if stop_latch["reason"] is None:
            stop_latch["reason"], stop_latch["code"] = reason, code

    # the stall escalation timer must never fire after train() returned
    # (an embedding process would be os._exit'd out from under itself)
    run_alive = {"v": True}
    stall_timers: list[threading.Timer] = []
    on_fatal = None
    if cfg.watch_action == "checkpoint-exit":
        def on_fatal(kind: str, step: int) -> None:
            _request_stop(f"watchdog:{kind}", WATCHDOG_EXIT_CODE)
            if kind == "stall":
                # a stalled loop may never reach its own boundary check:
                # after a grace window the watchdog thread pulls the plug
                t = threading.Timer(
                    _stall_escalate_s(),
                    lambda: os._exit(WATCHDOG_EXIT_CODE) if run_alive["v"] else None,
                )
                t.daemon = True
                t.start()
                stall_timers.append(t)

    watchdog = Watchdog(
        WatchdogConfig(
            loss_zscore=cfg.watch_loss_zscore, loss_window=cfg.watch_loss_window,
            tps_collapse_frac=cfg.watch_tps_collapse, stall_factor=cfg.watch_stall_factor,
            drift_threshold=cfg.watch_drift,
        ),
        emit=logger.log, status_path=cfg.status_file, on_fatal=on_fatal,
    )
    prev_sig: dict[int, Any] = {}

    def _on_signal(signum, frame):
        if stop_latch["reason"] is not None:
            # a SECOND signal means now: restore the previous disposition
            # and re-deliver
            signal.signal(signum, prev_sig.get(signum, signal.SIG_DFL))
            os.kill(os.getpid(), signum)
            return
        _request_stop("preempt", PREEMPT_EXIT_CODE)
        if not quiet:
            print(f"[nanodiloco] signal {signum}: checkpointing at the next round "
                  f"boundary, then exiting {PREEMPT_EXIT_CODE} (signal again to "
                  "abort immediately)", flush=True)

    def _save_schedule(step: int) -> None:
        """The live H schedule next to the checkpoints (a sidecar blip must
        not fail a good save)."""
        try:
            save_schedule(cfg.checkpoint_dir, step, cfg.num_workers,
                          list(dl.inner_budget),
                          straggler_policy.demotions_total if straggler_policy else 0)
        except OSError:
            pass

    def _guarded_save(step: int) -> None:
        """A save that degrades instead of aborting: retries happen inside
        the manager; a persistently failing save raises a watchdog alarm
        and training continues (the next cadence retries)."""
        try:
            with trace_span("ckpt"):
                ckpt.save(step, state)
            if hetero_on:
                _save_schedule(step)
        except Exception as e:
            watchdog.alarm("ckpt_save_failed", step,
                           error=f"{type(e).__name__}: {e}"[:300])

    def _maybe_graceful_exit(real_step: int) -> None:
        """Poll the stop latch at a round boundary: checkpoint (unless this
        boundary already saved), log the preempt record, leave with the
        latched code."""
        if stop_latch["reason"] is None:
            return
        reason, code = stop_latch["reason"], stop_latch["code"]
        if ckpt is not None and ckpt.latest_step != real_step:
            _guarded_save(real_step)
        step = ckpt.latest_step if ckpt else None
        logger.log({"preempt": reason, "exit_code": code, "checkpoint_step": step},
                   step=real_step)
        if not quiet:
            print(f"[nanodiloco] {reason}: checkpoint at step {step}, exiting {code}",
                  flush=True)
        raise _EmergencyExit(code, reason)

    def _pump_faults(cursor_step: int) -> None:
        """The fault plan's hook at the top of each round: advance the
        cursor, poison due nan_params replicas, turn a due resize into the
        supervisor's control file and a stop request, log every fired
        fault, and fire a due crash last so its own record lands first."""
        if fault_plan is None:
            return
        fault_plan.advance(cursor_step)
        for f in fault_plan.take_due("nan_params"):
            faults.poison_worker_params(state, f["worker"])
        for f in fault_plan.take_due("resize"):
            target_path = f.get("file") or os.environ.get(WORKERS_TARGET_ENV, "")
            if target_path:
                tmp = target_path + ".tmp"
                with open(tmp, "w") as fh:
                    fh.write(str(f["workers"]))
                os.replace(tmp, target_path)
            _request_stop("resize", PREEMPT_EXIT_CODE)
        crash = fault_plan.take_due("crash")
        for rec in fault_plan.drain_fired():
            # the record keeps the fault's scheduled step; fired_at_step
            # is the round boundary it hit
            logger.log({"fault": rec.pop("kind"), **rec, "fired_at_step": cursor_step})
        if crash:
            faults.fire_crash(crash[0])

    eval_launches = {name: dict.fromkeys(v, 0) for name, v in variant_counts().items()}

    # MoE observability: once per outer sync, the snapshot's router on one
    # microbatch; the dropped fraction and the router entropy go on the
    # synced record (a collapsed router looks healthy in the loss for long)
    moe_stats_fn = make_router_stats_fn(model_cfg) if model_cfg.num_experts else None

    def _evaluate(snapshot) -> dict[str, float]:
        """The held-out loss of ``snapshot`` (on the card)."""
        before = variant_counts()
        out = evaluator(snapshot, eval_set)
        for name, counts in variant_counts().items():
            for variant, n in counts.items():
                eval_launches[name][variant] += n - before[name][variant]
        return out

    @contextlib.contextmanager
    def _sync_phase():
        """An outer step's phase: with measure_comm its own span, timed by
        the sync timer and fenced, so it is timed alone; without, part of
        the inner phase. Its seconds go to the device-time ledger."""
        t = time.perf_counter()
        if cfg.measure_comm:
            with trace_span("sync"), sync_timer:
                yield
                _fence(device)
        else:
            with trace_span("inner"):
                yield
                _fence(device)
        devtime_acct.record("train_boundary", cfg.inner_steps, devtime_layout,
                            time.perf_counter() - t)

    # the wire ledger of one sync, from the synced tree's own sizes
    wire_rec = dl.sync_wire_bytes(state.snapshot)
    wire_metrics = {"wire_bytes_per_sync": wire_rec["wire_bytes_per_sync"],
                    "wire_compression": wire_rec["wire_compression"]}
    wire_bytes_total = 0
    # the outer mode in every sync record: async and its delay, or the
    # staleness streaming's applies run at (delay inner steps)
    if async_on:
        mode_extras: dict[str, Any] = {"async_outer": True, "outer_delay": cfg.outer_delay}
    elif streaming:
        mode_extras = {"outer_staleness": cfg.streaming_delay / cfg.inner_steps}
    else:
        mode_extras = {}

    def _log_async_boundary(aux: dict) -> None:
        """One record per async boundary at its own step: how many rounds
        late the applied merge landed (omitted for the warm-up applies of
        init copies) and the dynamics readout, which also feeds the
        drift sentinel."""
        b = int(aux["boundary_round"])
        if b < 1:
            return
        rec: dict[str, Any] = {**mode_extras}
        if int(aux["applied_launch_round"]) >= 1:
            rec["outer_staleness"] = int(aux["outer_staleness"])
        step = b * cfg.inner_steps
        if "dynamics" in aux:
            dynm = host_dynamics(aux["dynamics"])
            rec.update(dynm)
            watchdog.observe_drift(step, dynm["drift_max"])
        logger.log(rec, step=step)

    def _straggle() -> dict[int, float]:
        """The straggler hook on the round's clock, after the round's
        losses are on the host (a fence first, so the sleep never overlaps
        queued device work): the slept seconds per worker."""
        if faults.active_plan() is not None:
            _fence(device)
        return faults.maybe_straggle()

    def _absorb_straggle(round_budget: dict, round_wall_s: float,
                         straggle_extras: dict[int, float],
                         real_step: int) -> list[int] | None:
        """The straggler epilogue of a round: the injected wait split out
        of the inner span (``t_straggler``, the ledger's
        ``straggler_wait``), per-worker seconds as the JAX loop models
        them (the shared round wall time scaled by each worker's realized
        step share, plus the injected extras), the policy's decisions
        logged and applied to later rounds, the post-decision sidecar.
        Returns the budgets the round realized (None without
        heterogeneous H)."""
        straggler_s = sum(straggle_extras.values())
        if straggler_s > 0:
            round_budget["t_straggler"] = round(straggler_s, 6)
            if "t_inner" in round_budget:
                round_budget["t_inner"] = round(
                    max(0.0, round_budget["t_inner"] - straggler_s), 6)
        realized = (list(straggler_policy.budgets) if straggler_policy
                    else (list(dl.inner_budget) if hetero_on else None))
        if straggler_policy is not None:
            shared_s = max(0.0, round_wall_s - straggler_s)
            decisions = straggler_policy.observe(
                [shared_s * realized[w] / cfg.inner_steps + straggle_extras.get(w, 0.0)
                 for w in range(cfg.num_workers)]
            )
            for d in decisions:
                logger.log({**d, "t_unix": round(time.time(), 3)}, step=real_step)
            if decisions:
                dl.set_inner_budget(straggler_policy.budgets)
                if ckpt is not None:
                    _save_schedule(real_step)
        return realized

    def _log_cost(start_step: int, row_len: int) -> None:
        """The one-time cost_analysis record: one microbatch's forward and
        backward counted on the meta device, the hand formula at the same
        shapes and the card's peak (obs/costs.py)."""
        with torch.no_grad():
            one_worker = tree_map(lambda p: p[0], state.params)
        tokens = cfg.per_device_batch_size * row_len
        flops = microbatch_flops(one_worker, model_cfg, (cfg.per_device_batch_size, row_len))
        logger.log({"cost_analysis": build_cost_record(
            program="async_round" if async_on else "round", probe={"flops": flops},
            probe_tokens=tokens, num_devices=1, model_cfg=model_cfg, seq=row_len,
            moe_tokens=tokens, device=device,
        )}, step=start_step)

    emergency: _EmergencyExit | None = None
    completed = False
    prefetcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="prefetch")
    pending = None
    telemetry = None
    launches0, variants0, shapes0 = launch_counts(), variant_counts(), shape_counts()
    losses_out: list[list[float]] = []
    round_seconds: list[float] = []
    snapshot_changed: list[bool] = []
    compute_time = 0.0
    last_loss = float("nan")
    last_eval_step, last_eval = None, {}
    H = cfg.inner_steps
    # install the process-global tracer, recorder, watchdog thread and
    # signal handlers IMMEDIATELY before the try whose finally undoes them
    prev_tracer = set_tracer(tracer)
    prev_recorder = flightrec.install(recorder)
    watchdog.start()
    if cfg.preempt_signals and threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_sig[sig] = signal.signal(sig, _on_signal)
        if recorder.dump_path:
            flightrec.arm_fatal_signals()
    try:
        if cfg.metrics_port is not None:
            from nanodiloco_tpu_torch.obs.telemetry import TelemetryServer

            try:
                telemetry = TelemetryServer(
                    port=cfg.metrics_port, health_fn=watchdog.status_doc,
                    profile_dir=(os.path.join(cfg.log_dir, f"{run_name}-live-profile")
                                 if cfg.log_dir else None),
                ).start()
                logger.telemetry = telemetry
                if not quiet:
                    print(f"[nanodiloco] telemetry: port {telemetry.port} "
                          "(/metrics, /healthz, POST /debug/profile)", flush=True)
            except OSError as e:
                telemetry = None
                if not quiet:
                    print(f"[nanodiloco] warning: telemetry server failed to bind port "
                          f"{cfg.metrics_port}: {e}; continuing without the endpoint")
        evaluator = eval_set = None
        if cfg.eval_every:
            evaluator = Evaluator(model_cfg, device)
            eval_set = holdout_batches(eval_rows, cfg.per_device_batch_size,
                                       mask_rows=eval_mask_rows)
        start_step = state.inner_step_count
        if start_step % H:
            raise ValueError(f"checkpoint step {start_step} is not a round boundary")
        row_len = batcher.seq_len if hasattr(batcher, "seq_len") else batcher.data.shape[1]
        tokens_per_step = cfg.num_workers * cfg.grad_accum * cfg.per_device_batch_size * row_len
        # deterministic O(1) resume positioning (no replayed gathers)
        batches = batcher.iter_from(start_step)
        # an async checkpoint lands before its round's boundary (the last
        # round's excepted: it is flushed): launched_round says whether
        # the boundary is still owed
        boundary_owed = (async_on and start_step > 0
                         and state.launched_round < start_step // H)
        first_round, last_round = start_step // H + 1, cfg.total_steps // H
        if first_round <= last_round:
            pending = prefetcher.submit(_stack_round, batches, H, on_cuda)
        for rnd in range(first_round, last_round + 1):
            # the fault hook at the round's top: a fault scheduled for any
            # step the round covers fires here, before the round runs
            _pump_faults(rnd * H)
            with trace_span("data"):
                toks, masks, stalled_s = pending.result()
            pending = (prefetcher.submit(_stack_round, batches, H, on_cuda)
                       if rnd < last_round else None)
            if cfg.cost_analysis and rnd == first_round:
                with trace_span("cost_analysis"):
                    _log_cost(start_step, row_len)
            before = _fingerprint(state.snapshot)
            boundary_auxes: list[dict] = []
            round_dyn, eff_mask = None, None
            t0 = time.perf_counter()
            if async_on and boundary_owed:
                # the previous round's launch and apply, at the top of
                # this round
                with _sync_phase():
                    state, baux = dl.async_deferred_boundary(state)
                boundary_auxes.append(baux)
            # no sync phase after: streaming's launches run inside the
            # inner steps; an async round's boundary runs at the next
            sync_follows = not streaming and (not async_on or rnd == last_round)
            t_inner0 = time.perf_counter()
            with trace_span("inner", round=rnd):
                if streaming:
                    state, losses, _ = dl.round_step(state, toks, masks)
                else:
                    state, losses = dl.inner_round(state, toks, masks)
                if cfg.measure_comm or not sync_follows:
                    _fence(device)
                straggle_extras = _straggle()
            devtime_acct.record("train_round", H, devtime_layout,
                                time.perf_counter() - t_inner0)
            if async_on:
                boundary_owed = True
                if rnd == last_round:
                    # the final boundary and the drain before the last
                    # checkpoint and eval, which must see every update
                    with _sync_phase():
                        state, baux = dl.async_flush(state)
                    boundary_auxes.append(baux)
            elif not streaming:
                wmask = (torch.isfinite(losses).all(dim=0)
                         if cfg.quarantine_nonfinite else None)
                with _sync_phase():
                    _, eff_mask, round_dyn = (dl.outer_step(state) if wmask is None
                                              else dl.outer_step(state, wmask))
            round_s = time.perf_counter() - t0
            compute_time += round_s
            round_seconds.append(round_s)
            snapshot_changed.append(_fingerprint(state.snapshot) != before)
            losses = losses.cpu()
            losses_out.extend(losses.tolist())
            quarantine_metrics = {}
            if cfg.quarantine_nonfinite:
                # a healed worker's NaN must not reach the logged loss
                losses_h = _finite_worker_mean(losses).tolist()
                quarantine_metrics = {
                    "quarantined_workers": int(cfg.num_workers - int(eff_mask.sum()))
                }
            else:
                losses_h = losses.mean(dim=1).tolist()  # [H]
            real_step = rnd * H
            if ckpt and rnd % cfg.checkpoint_every == 0:
                _guarded_save(real_step)
            eval_metrics = {}
            eval_due = evaluator is not None and rnd % cfg.eval_every == 0
            if eval_due or moe_stats_fn is not None:
                # one fetch for both readers of an offloaded snapshot
                with trace_span("eval"):
                    snap_dev = dl.device_snapshot(state)
                    if eval_due:
                        eval_metrics = _evaluate(snap_dev)
                        last_eval_step, last_eval = real_step, eval_metrics
                    if moe_stats_fn is not None:
                        probe = toks[-1, 0, 0].to(device, torch.long)  # [B, S]
                        eval_metrics = {**eval_metrics, **moe_stats_fn(snap_dev, probe)}
                    del snap_dev
            eval_metrics = {**eval_metrics, **device_memory_stats(device)}
            # depth-0 span totals since the last round; the log span of
            # this round is still open, its seconds land in the next one
            round_budget = {f"t_{k}": round(v, 6) for k, v in tracer.phase_totals().items()}
            timed_sync = cfg.measure_comm and sync_timer.calls > 0
            sync_metrics = {
                "avg_sync_time_s": sync_timer.avg_sync_time if timed_sync else None,
                "comm_share": sync_timer.total / compute_time if timed_sync else None,
            }
            realized = _absorb_straggle(round_budget, round_s, straggle_extras, real_step)
            # goodput from the same budget the JSONL carries; the first
            # round's compute is compile_warmup (the kernels' first-use
            # build, cuBLAS's first heuristics); an injected stall the
            # round waited on is split out of its data wait
            ledger_budget = dict(round_budget)
            if stalled_s > 0:
                waited = min(stalled_s, ledger_budget.get("t_data", 0.0))
                ledger_budget["t_data"] = ledger_budget.get("t_data", 0.0) - waited
                ledger_budget["t_stall"] = waited
            ledger.observe_phases(ledger_budget, warmup=rnd == first_round)
            ledger.add_tokens(H * tokens_per_step)
            wire_bytes_total += wire_rec["wire_bytes_per_sync"]
            sync_extras: dict[str, Any] = {
                **wire_metrics,
                "wire_bytes_total": wire_bytes_total,
                **quarantine_metrics,
                **mode_extras,
                "workers_active": cfg.num_workers
                - quarantine_metrics.get("quarantined_workers", 0),
            }
            if realized is not None:
                sync_extras["inner_steps_realized"] = realized
            if round_dyn is not None:
                dyn = host_dynamics(round_dyn)
                sync_extras.update(dyn)
                watchdog.observe_drift(real_step, dyn["drift_max"])
            sync_extras["devtime"] = devtime_acct.snapshot()
            for baux in boundary_auxes:
                _log_async_boundary(baux)
            tps = (real_step - start_step) * tokens_per_step / compute_time
            with trace_span("log"):
                for i in range(H):
                    step = real_step - H + 1 + i
                    last = i == H - 1
                    watchdog.observe_loss(step, losses_h[i])
                    logger.log(
                        {
                            **(eval_metrics if last else {}),
                            "loss": losses_h[i],
                            "perplexity": float(np.exp(min(losses_h[i], 50.0))),
                            "lr": float(dl.schedule(step - 1)),
                            "effective_step": step * cfg.num_workers,
                            "total_samples": step * cfg.batch_size * cfg.num_workers,
                            "tokens_per_sec": tps,
                            "outer_synced": int(last),
                            **sync_metrics,
                            **round_budget,
                            **(sync_extras if last else {}),
                        },
                        step=step,
                    )
                # the running ledger of this lifetime (snapshots, not
                # deltas: a crashed lifetime's last one still stands)
                logger.log({"goodput": ledger.snapshot()}, step=real_step)
            # per-round throughput for the collapse sentinel, then the
            # heartbeat: both after the round's losses are on the host
            watchdog.observe_throughput(real_step, H * tokens_per_step / max(round_s, 1e-9))
            watchdog.heartbeat(real_step, loss=losses_h[-1], tokens_per_sec=round(tps, 1))
            last_loss = losses_h[-1]
            _maybe_graceful_exit(real_step)

        if ckpt and ckpt.latest_step != cfg.total_steps:
            _guarded_save(cfg.total_steps)
        if fault_plan is not None:
            # faults fired after the last round top (in its prefetch, or an
            # io_error in the final save) have no later round to drain them
            for rec in fault_plan.drain_fired():
                logger.log({"fault": rec.pop("kind"), **rec})
        final_eval = {}
        if evaluator is not None:
            # reuse the in-loop result when the last sync already evaluated
            # this exact snapshot
            final_eval = (last_eval if last_eval_step == cfg.total_steps
                          else _evaluate(dl.device_snapshot(state)))
        completed = True
    except _EmergencyExit as e:
        emergency = e
    except BaseException as e:
        # an exception escaping train() is a crash: dump the black box
        # before teardown, then let the exception propagate
        try:
            flightrec.dump_current(f"train_exception:{type(e).__name__}")
        except Exception:
            pass
        raise
    finally:
        # teardown on EVERY exit: join the prefetch thread (an orphan
        # would keep drawing batches into whatever the process does next),
        # the final goodput snapshot and the watchdog's final state before
        # the logger closes, then restore the process-global tracer,
        # recorder, fault plan and signal handlers
        if pending is not None:
            pending.cancel()
        prefetcher.shutdown(wait=True)
        try:
            # a watchdog-stall exit books its unattributed tail as stall
            stalled_exit = emergency is not None and emergency.reason == "watchdog:stall"
            logger.log({"goodput": ledger.snapshot(
                final=True, residual_cause="stall" if stalled_exit else "other")})
        except Exception:
            pass
        watchdog.stop("finished" if completed else (
            "preempted" if emergency is not None and emergency.code == PREEMPT_EXIT_CODE
            else "crashed"))
        if telemetry is not None:
            telemetry.stop()
        set_tracer(prev_tracer)
        flightrec.disarm_fatal_signals()
        flightrec.install(prev_recorder)
        if cfg.trace_out:
            try:
                tracer.export_chrome(cfg.trace_out)
                if not quiet:
                    print(f"[nanodiloco] host span trace -> {cfg.trace_out}")
            except OSError:
                pass  # a full disk must not mask the real outcome
        logger.finish()
        run_alive["v"] = False
        for t in stall_timers:
            t.cancel()
        if fault_plan is not None:
            faults.clear_plan()
        for sig, handler in prev_sig.items():
            signal.signal(sig, handler)
    if emergency is not None:
        raise SystemExit(emergency.code)

    after_first = round_seconds[1:]
    n_tokens = tokens_per_step * H * len(round_seconds)
    timed_sync = cfg.measure_comm and sync_timer.calls > 0
    return {
        **final_eval,
        "final_loss": last_loss,
        "steps": cfg.total_steps,
        **({"async_outer": True, "outer_delay": cfg.outer_delay} if async_on else {}),
        **({"inner_steps_per_worker": list(dl.inner_budget),
            "straggler_demotions": (straggler_policy.demotions_total
                                    if straggler_policy is not None else 0)}
           if hetero_on else {}),
        "avg_sync_time_s": sync_timer.avg_sync_time if timed_sync else None,
        "comm_share": (sync_timer.total / compute_time
                       if timed_sync and compute_time else None),
        **wire_metrics,
        "wire_bytes_total": wire_bytes_total,
        "alarms": watchdog.alarm_count,
        "run_name": run_name,
        "state": state,
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if on_cuda else "cpu",
        "model": model_cfg.to_dict(),
        "num_params": model_cfg.num_params(),
        "rounds": len(round_seconds),
        "losses": losses_out,
        "snapshot_changed": snapshot_changed,
        "tokens": n_tokens,
        "seconds": compute_time,
        "round_seconds": round_seconds,
        "tokens_per_sec": n_tokens / compute_time if compute_time else None,
        "tokens_per_sec_after_first_round": (
            tokens_per_step * H * len(after_first) / sum(after_first)
            if after_first else None
        ),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if on_cuda else None,
        "kernel_launches": {k: v - launches0[k] for k, v in launch_counts().items()},
        "kernel_variants": {k: {var: n - variants0[k][var] for var, n in v.items()}
                            for k, v in variant_counts().items()},
        "kernel_shapes": {k: {key: n - shapes0[k].get(key, 0) for key, n in v.items()
                              if n > shapes0[k].get(key, 0)}
                          for k, v in shape_counts().items()},
        "eval_kernel_launches": eval_launches,
    }
