"""The DiLoCo training job: port of the classic path of
``nanodiloco_tpu/training/train_loop.py::train``.

Data (synthetic text, packed or padded, or a pre-tokenized ``.tshrd``
shard) -> a deterministic per-worker batcher -> rounds of ``inner_steps``
inner steps and one outer sync until ``total_steps``. Around the rounds:

- round-ahead prefetch: one worker thread stacks the next round's
  batches into (pinned, on the card) host tensors while this round runs;
- the metrics JSONL (``training/metrics.py``) in the JAX fused path's
  layout: one record per inner step, with the phase budget ``t_*`` of
  the round; the round's last record adds the evaluation and sync keys;
- held-out evaluation of the snapshot every ``eval_every`` syncs, plus a
  final one;
- a checkpoint every ``checkpoint_every`` syncs, plus a final one, and a
  bit-exact resume from the latest (``restore_elastic`` when the worker
  count changed);
- preemption: SIGTERM/SIGINT checkpoint at the next round boundary and
  exit with code 75.

Returns a summary with the JAX keys this port has (``final_loss``,
``steps``, ``avg_sync_time_s``, ``comm_share``, ``run_name``, ``state``,
the final eval keys) and per-step [W] losses, throughput, peak device
memory and the flash kernels' launch counts over the run. The watchdog,
goodput ledger, device-time accounting, DiLoCo dynamics, wire-byte
accounting, cost analysis, fault injection and telemetry are not ported
(ROADMAP.md, Queue A items 2 and 5), and their JSONL keys are not
written.
"""

from __future__ import annotations

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
    pack_corpus,
    pad_corpus,
    synthetic_corpus,
)
from nanodiloco_tpu_torch.data.tokenizer import ByteTokenizer
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import Params, resolve_device, tree_leaves
from nanodiloco_tpu_torch.obs import flightrec
from nanodiloco_tpu_torch.obs.tracer import SpanTracer, set_tracer, trace_span
from nanodiloco_tpu_torch.ops.cuda.flash_attention import launch_counts, variant_counts
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.resilience.retry import RetryPolicy
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.evaluate import Evaluator, holdout_batches
from nanodiloco_tpu_torch.training.metrics import MetricsLogger, SyncTimer
from nanodiloco_tpu_torch.utils import create_run_name, device_memory_stats

# exit code of a graceful preemption stop, as in the JAX package
PREEMPT_EXIT_CODE = 75


class _Preempted(Exception):
    """Raised at a round boundary after the preemption checkpoint, caught
    at the bottom of ``train``, and turned into
    ``SystemExit(PREEMPT_EXIT_CODE)`` once teardown has run."""


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
    # a pre-tokenized tokenshard file (scripts/prepare_data.py); None ->
    # the synthetic corpus
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
    model: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    # shrink vocab_size to the tokenizer's vocabulary (rounded up to 128)
    fit_vocab: bool = True
    eval_every: int = 0       # evaluate the snapshot every N outer syncs (0=off)
    eval_batches: int = 8     # held-out batches (never trained on)
    # Chrome trace-event JSON of the host-side round phases
    trace_out: str | None = None
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
    # never fit against a .tshrd: its manifest is the vocabulary's authority
    if cfg.fit_vocab and not shard and fitted < model_cfg.vocab_size:
        if not quiet:
            print(f"[nanodiloco] vocab_size {model_cfg.vocab_size} -> {fitted} "
                  f"(tokenizer has {vocab} tokens; fit_vocab=False keeps it)")
        return dataclasses.replace(model_cfg, vocab_size=fitted)
    return model_cfg


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stack_round(batches, inner_steps: int, pin: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw one round of batches and stack them into [H, W, accum, B, S]
    host tensors, pinned when they go to a card."""
    steps = [next(batches) for _ in range(inner_steps)]
    toks = torch.from_numpy(np.stack([t for t, _ in steps]))
    masks = torch.from_numpy(np.stack([m for _, m in steps]))
    if pin:
        toks, masks = toks.pin_memory(), masks.pin_memory()
    return toks, masks


def train(cfg: TrainConfig, device: str | torch.device = "cuda") -> dict[str, Any]:
    """Run the DiLoCo training job on one device; returns the summary."""
    device = resolve_device(device)
    quiet = cfg.quiet
    if cfg.total_steps % cfg.inner_steps:
        raise ValueError("total_steps must divide evenly by inner_steps")
    if cfg.data_layout not in ("packed", "padded"):
        raise ValueError(f"unknown data_layout: {cfg.data_layout!r}")
    if cfg.eval_every and cfg.eval_batches < 1:
        raise ValueError("--eval-every requires --eval-batches >= 1")
    padded = cfg.data_layout == "padded"
    shard = bool(cfg.dataset_path) and cfg.dataset_path.endswith(".tshrd")
    if cfg.dataset_path and not shard:
        raise ValueError(
            f"--dataset-path {cfg.dataset_path!r}: the port reads pre-tokenized "
            ".tshrd shards only (loading an HF datasets directory is not ported); "
            "make one with scripts/prepare_data.py"
        )
    if padded and cfg.model.attention_impl != "dense" and not quiet:
        print(
            "[nanodiloco] warning: --data-layout padded with attention "
            f"{cfg.model.attention_impl}: the attention padding mask is ignored by "
            "this kernel (loss is unaffected for tail padding; dense attention "
            "honors the mask)"
        )
    tokenizer = ByteTokenizer()
    model_cfg = _fit_model(cfg, tokenizer.vocab_size, quiet, shard)

    eval_needed = cfg.eval_batches * cfg.per_device_batch_size if cfg.eval_every else 0
    eval_rows, eval_mask_rows = None, None
    sidecar_tokenizer = None
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
                "are pre-packed — re-run scripts/prepare_data.py to change it"
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

    dl = Diloco(model_cfg, DilocoConfig(
        num_workers=cfg.num_workers, inner_steps=cfg.inner_steps,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps, lr=cfg.lr,
        outer_lr=cfg.outer_lr, grad_accum=cfg.grad_accum,
    ), device)
    state = dl.init_state(torch.Generator(device=device).manual_seed(cfg.seed))
    on_cuda = device.type == "cuda"

    ckpt = None
    logger: MetricsLogger | None = None
    resume_rec: dict | None = None
    elastic_rec: dict | None = None
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
                elastic_rec = {
                    "elastic": "resize_widen" if cfg.num_workers > saved_w else "resize_shrink",
                    "workers_from": saved_w, "workers_to": cfg.num_workers,
                }
            _fence(device)
            resume_rec = {
                "resume": ckpt.latest_step,
                "elastic": saved_w != cfg.num_workers,
                "t_restore": round(time.perf_counter() - t_restore0, 6),
            }
    if on_cuda:
        _fence(device)
        torch.cuda.reset_peak_memory_stats(device)

    run_name = cfg.run_name or create_run_name("nanodiloco-torch", {"nodes": cfg.num_workers})
    logger = MetricsLogger(run_name, out_dir=cfg.log_dir, quiet=quiet)
    for rec in pre_logger_events:
        logger.log(rec)
    if resume_rec is not None:
        logger.log(resume_rec, step=resume_rec["resume"])
        if elastic_rec is not None:
            logger.log({**elastic_rec, "t_unix": round(time.time(), 3)},
                       step=resume_rec["resume"])
    sync_timer = SyncTimer()
    # the per-phase t_* totals flow into the JSONL either way; the event
    # list is kept only when --trace-out will export it
    tracer = SpanTracer(max_events=500_000 if cfg.trace_out else 0)
    recorder = flightrec.FlightRecorder(
        dump_path=os.path.join(cfg.log_dir, f"{run_name}-blackbox.json")
        if cfg.log_dir else None
    )

    # the graceful stop, requested by a signal and polled at round boundaries
    preempted = threading.Event()
    prev_sig: dict[int, Any] = {}

    def _on_signal(signum, frame):
        if preempted.is_set():
            # a SECOND signal means now: restore the previous disposition
            # and re-deliver
            signal.signal(signum, prev_sig.get(signum, signal.SIG_DFL))
            os.kill(os.getpid(), signum)
            return
        preempted.set()
        if not quiet:
            print(f"[nanodiloco] signal {signum}: checkpointing at the next round "
                  f"boundary, then exiting {PREEMPT_EXIT_CODE} (signal again to "
                  "abort immediately)", flush=True)

    def _guarded_save(step: int) -> None:
        """A save that degrades instead of aborting: retries happen inside
        the manager; a persistently failing save logs an alarm record and
        training continues (the next cadence retries)."""
        try:
            with trace_span("ckpt"):
                ckpt.save(step, state)
        except Exception as e:
            logger.log({"alarm": "ckpt_save_failed", "step": step,
                        "error": f"{type(e).__name__}: {e}"[:300]})

    def _maybe_graceful_exit(real_step: int) -> None:
        if not preempted.is_set():
            return
        if ckpt is not None and ckpt.latest_step != real_step:
            _guarded_save(real_step)
        step = ckpt.latest_step if ckpt else None
        logger.log({"preempt": "preempt", "exit_code": PREEMPT_EXIT_CODE,
                    "checkpoint_step": step}, step=real_step)
        if not quiet:
            print(f"[nanodiloco] preempt: checkpoint at step {step}, exiting "
                  f"{PREEMPT_EXIT_CODE}", flush=True)
        raise _Preempted

    eval_launches = {name: dict.fromkeys(v, 0) for name, v in variant_counts().items()}

    def _evaluate(snapshot: Params) -> dict[str, float]:
        before = variant_counts()
        out = evaluator(snapshot, eval_set)
        for name, counts in variant_counts().items():
            for variant, n in counts.items():
                eval_launches[name][variant] += n - before[name][variant]
        return out

    preempt_exit = False
    prefetcher = ThreadPoolExecutor(max_workers=1, thread_name_prefix="prefetch")
    pending = None
    launches0 = launch_counts()
    losses_out: list[list[float]] = []
    round_seconds: list[float] = []
    snapshot_changed: list[bool] = []
    compute_time = 0.0
    last_loss = float("nan")
    last_eval_step, last_eval = None, {}
    H = cfg.inner_steps
    # install the process-global tracer, recorder and signal handlers
    # IMMEDIATELY before the try whose finally restores them
    prev_tracer = set_tracer(tracer)
    prev_recorder = flightrec.install(recorder)
    if cfg.preempt_signals and threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_sig[sig] = signal.signal(sig, _on_signal)
        if recorder.dump_path:
            flightrec.arm_fatal_signals()
    try:
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
        first_round, last_round = start_step // H + 1, cfg.total_steps // H
        if first_round <= last_round:
            pending = prefetcher.submit(_stack_round, batches, H, on_cuda)
        for rnd in range(first_round, last_round + 1):
            with trace_span("data"):
                toks, masks = pending.result()
            pending = (prefetcher.submit(_stack_round, batches, H, on_cuda)
                       if rnd < last_round else None)
            before = _fingerprint(state.snapshot)
            t0 = time.perf_counter()
            with trace_span("inner", round=rnd):
                state, losses = dl.inner_round(state, toks, masks)
                if not cfg.measure_comm:
                    dl.outer_step(state)
                _fence(device)
            if cfg.measure_comm:
                with trace_span("sync"), sync_timer:
                    dl.outer_step(state)
                    _fence(device)
            round_s = time.perf_counter() - t0
            compute_time += round_s
            round_seconds.append(round_s)
            snapshot_changed.append(_fingerprint(state.snapshot) != before)
            losses = losses.cpu()
            losses_out.extend(losses.tolist())
            losses_h = losses.mean(dim=1).tolist()  # [H]
            real_step = rnd * H
            if ckpt and rnd % cfg.checkpoint_every == 0:
                _guarded_save(real_step)
            eval_metrics = {}
            if evaluator is not None and rnd % cfg.eval_every == 0:
                with trace_span("eval"):
                    eval_metrics = _evaluate(state.snapshot)
                last_eval_step, last_eval = real_step, eval_metrics
            eval_metrics = {**eval_metrics, **device_memory_stats(device)}
            # depth-0 span totals since the last round; the log span of
            # this round is still open, its seconds land in the next one
            round_budget = {f"t_{k}": round(v, 6) for k, v in tracer.phase_totals().items()}
            sync_metrics = {
                "avg_sync_time_s": sync_timer.avg_sync_time if cfg.measure_comm else None,
                "comm_share": sync_timer.total / compute_time if cfg.measure_comm else None,
            }
            tps = (real_step - start_step) * tokens_per_step / compute_time
            with trace_span("log"):
                for i in range(H):
                    step = real_step - H + 1 + i
                    last = i == H - 1
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
                            **({"workers_active": cfg.num_workers} if last else {}),
                        },
                        step=step,
                    )
            last_loss = losses_h[-1]
            _maybe_graceful_exit(real_step)

        if ckpt and ckpt.latest_step != cfg.total_steps:
            _guarded_save(cfg.total_steps)
        final_eval = {}
        if evaluator is not None:
            # reuse the in-loop result when the last sync already evaluated
            # this exact snapshot
            final_eval = (last_eval if last_eval_step == cfg.total_steps
                          else _evaluate(state.snapshot))
    except _Preempted:
        preempt_exit = True
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
        # restore the process-global tracer, recorder and signal handlers
        if pending is not None:
            pending.cancel()
        prefetcher.shutdown(wait=True)
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
        for sig, handler in prev_sig.items():
            signal.signal(sig, handler)
    if preempt_exit:
        raise SystemExit(PREEMPT_EXIT_CODE)

    after_first = round_seconds[1:]
    n_tokens = tokens_per_step * H * len(round_seconds)
    return {
        **final_eval,
        "final_loss": last_loss,
        "steps": cfg.total_steps,
        "avg_sync_time_s": sync_timer.avg_sync_time if cfg.measure_comm else None,
        "comm_share": (sync_timer.total / compute_time
                       if cfg.measure_comm and compute_time else None),
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
        "eval_kernel_launches": eval_launches,
    }
