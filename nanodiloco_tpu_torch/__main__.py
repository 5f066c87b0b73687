"""``python -m nanodiloco_tpu_torch``: the DiLoCo training job, with the
JAX CLI's flag names for every ``TrainConfig`` field the port has: data
(``--dataset-path`` a ``.tshrd`` or an HF ``datasets`` directory,
``--data-layout``, ``--tokenizer``, ``--fit-vocab``), the model
(``--llama-config-file``, ``--init-hf DIR`` whose ``config.json`` is the
model config unless one is given, ``--dtype``, ``--attention``,
``--loss-chunk``), held-out evaluation (``--eval-every``,
``--eval-batches``), checkpoint and resume (``--checkpoint-dir``,
``--checkpoint-every``, ``--no-resume``), the metrics JSONL (``--log-dir``,
``--run-name``), the reference's wandb surface (``--project``, ``--wandb``,
``--wandb-config-file``), ``--measure-comm``, ``--trace-out``, the DiLoCo options
(``--streaming-fragments``, ``--streaming-delay``, ``--merge-alpha``,
``--async-outer``, ``--outer-delay``, ``--inner-steps-per-worker``,
``--straggler-factor``, ``--straggler-min-steps``, ``--outer-comm-dtype``,
``--outer-wire-collective``, ``--quarantine-nonfinite``,
``--offload-snapshot``, ``--dynamics-metrics/--no-dynamics-metrics``), and
the job's resilience and observability (``--preempt-signals``: SIGTERM or
SIGINT checkpoint at the next round boundary and exit 75;
``--fault-plan``; the ``--watch-*`` sentinels and ``--watch-action
checkpoint-exit``, exit 76; ``--status-file``; ``--metrics-port``;
``--cost-analysis``). Prints the metrics records and the run summary
last. Runs on the CUDA card unless ``--device cpu``. Started by torchrun
(``WORLD_SIZE`` above 1 in the environment) each process is one rank of
a worker group of ``--fsdp`` x ``--tp`` ranks holding ``num_workers / G``
workers (G = ``WORLD_SIZE / (fsdp * tp)``): NCCL, one card a rank, or gloo
with ``--device cpu``; rank 0 alone prints and writes the run's files.
``--dcn-slices`` is the number of nodes, each holding whole worker groups.
A process that already has a process group trains in it.

``supervise [flags] -- <train flags>`` runs training as a supervised
child process (resilience/supervisor.py): preempt exits resume at once,
crashes restart from the latest checkpoint with backoff and a budget.
``export-hf --checkpoint-dir DIR --out OUT`` writes a checkpoint's merged
snapshot as an HF safetensors checkpoint with its ``config.json``.

``report RUN.jsonl`` summarizes a run's JSONL; ``report compare BASELINE
CANDIDATE`` is the regression gate (exit 1 on a regression); ``report
cost|faults|goodput|drift RUN.jsonl`` and ``report blackbox DUMP.json``
print the cost reconciliation, the resilience timeline, the goodput
budget stitched across restarts, the dynamics timeline and a
flight-recorder dump. All give the JAX CLI's output, for a run of either
package. ``report merge-trace|trace`` fold a fleet's trace shards into
one timeline or one request's causal tree and critical path; ``report
timeseries|dashboard`` render an ``obs-watch`` series JSONL.

``fleet --replica URL ...`` runs the fleet router over serve replicas:
least-loaded routing, ejection, hedging, retry budget and breakers,
``--chaos-plan`` wire faults, ``--disagg`` prefill/decode tiers with KV
shipping, ``--autoscale-template`` predictive autoscaling, and with
``--watch-checkpoint-dir`` the canary deploy controller (its held-out
loss on ``--device``). ``obs-watch --target NAME=URL ...`` scrapes
``/metrics`` into series and evaluates multi-window SLO burn rates.

``python -m nanodiloco_tpu_torch generate --checkpoint-dir DIR`` samples
text from a checkpoint's merged snapshot; ``serve --checkpoint-dir DIR``
runs the continuous-batching HTTP server over it (``POST /v1/generate``,
``GET /healthz``, ``GET /metrics``, ``POST /admin/swap`` to hot-swap
another checkpoint's weights in, ``/admin/kv/export`` and
``/admin/kv/import`` to ship a stream's KV rows). Both take the JAX
CLI's flags, plus ``--device`` (the card unless ``--device cpu``), and
decode with the tokenizer the checkpoint was trained on, or refuse:
``--kv-block-size`` serves from a paged block arena, ``--kv-dtype int8``
stores it quantized, ``--spec-k`` turns on prompt-lookup speculative
decoding. ``--tp`` above 1 raises NotImplementedError (tensor-parallel
serving is not ported yet).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.training.metrics import compare_runs, load_comparable, summarize_run
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m nanodiloco_tpu_torch")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--batch-size", type=int, default=256,
                   help="per-worker global batch (microbatches x per-device)")
    p.add_argument("--per-device-batch-size", type=int, default=8)
    p.add_argument("--seq-length", type=int, default=1024)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--total-steps", type=int, default=10_000)
    p.add_argument("--inner-steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--outer-lr", type=float, default=0.7)
    p.add_argument("--project", type=str, default="nano-diloco",
                   help="the wandb project (with --wandb)")
    p.add_argument("--dataset-path", type=str, default=None,
                   help="pre-tokenized .tshrd shard (scripts/torch_prepare_data.py) or "
                        "a datasets.save_to_disk directory (needs the datasets "
                        "package); default: built-in synthetic corpus")
    p.add_argument("--llama-config-file", type=str, default=None,
                   help="HF-style model config JSON (configs/*.json)")
    p.add_argument("--wandb-config-file", type=str, default=None,
                   help="the reference's wandb config JSON (configs/wandb_default.json): "
                        "its keys go into the wandb run's config and the generated run "
                        "name, and its measure_comms is --measure-comm's default")
    p.add_argument("--init-hf", type=str, default=None, metavar="DIR",
                   help="initialize weights from an HF Llama checkpoint directory "
                        "(sharded or single-file safetensors): continued "
                        "pretraining. DIR/config.json supplies the model config "
                        "unless --llama-config-file is given; a resumable "
                        "checkpoint still wins")
    p.add_argument("--dtype", type=str, default=None,
                   help="compute dtype override (e.g. bfloat16)")
    p.add_argument("--attention", type=str, default=None, choices=["dense", "flash"],
                   help="attention override: flash runs the CUDA kernels (packed "
                        "sequences; ignores padding masks), dense honors masks")
    p.add_argument("--loss-chunk", type=int, default=None,
                   help="rows per chunk of the blockwise cross-entropy (0 = the "
                        "full logits)")
    p.add_argument("--tokenizer", type=str, default=None,
                   help="HF tokenizer name/path, read from local files (needs "
                        "transformers); default byte-level")
    p.add_argument("--fit-vocab", action=argparse.BooleanOptionalAction, default=True,
                   help="shrink the model's vocab_size to the tokenizer's "
                        "vocabulary (rounded up to 128) when the config's is larger")
    p.add_argument("--data-layout", type=str, default="packed",
                   choices=["packed", "padded"],
                   help="packed (default): eos-joined stream cut into fixed-length "
                        "rows. padded: one document per row, pad positions masked "
                        "out of the loss")
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=1, help="fsdp mesh axis size per worker")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh axis size")
    p.add_argument("--dcn-slices", type=int, default=1,
                   help="multi-node deployment: spread the worker groups across this "
                        "many nodes (torchrun's nodes; fsdp and tp stay inside one, the "
                        "outer sync crosses them)")
    p.add_argument("--measure-comm", action=argparse.BooleanOptionalAction, default=None,
                   help="fence the card around the outer step so avg_sync_time_s "
                        "and comm_share time the sync alone. Default: the wandb "
                        "config's measure_comms, else on")
    p.add_argument("--streaming-fragments", type=int, default=0,
                   help="streaming DiLoCo: split params into N layer fragments with "
                        "staggered outer syncs (0 = classic all-at-once sync)")
    p.add_argument("--streaming-delay", type=int, default=1,
                   help="inner steps between a fragment's launch and its merge into "
                        "worker params")
    p.add_argument("--merge-alpha", type=float, default=1.0,
                   help="fragment merge blend: 1 = hard reset to global, 0.5 = half "
                        "local/global mix")
    p.add_argument("--async-outer", action="store_true",
                   help="async delayed-apply outer step (classic rounds): launch each "
                        "round boundary's outer update, start the next round from the "
                        "previous merge, apply the pending merge --outer-delay rounds "
                        "late (outer_staleness in the JSONL); --outer-delay 0 is "
                        "bit-identical to the synchronous outer step")
    p.add_argument("--outer-delay", type=int, default=1,
                   help="rounds between an async outer launch and its apply")
    p.add_argument("--inner-steps-per-worker", type=str, default=None,
                   metavar="H0,H1,...",
                   help="per-worker inner-step budgets (one per worker, each in "
                        "[1, --inner-steps]): a worker freezes past its budget each "
                        "round and enters the outer merge weighted by its realized "
                        "steps (classic rounds only)")
    p.add_argument("--straggler-factor", type=float, default=0.0,
                   help="straggler policy (must be > 1; 0 disables): turns on "
                        "heterogeneous H, the `elastic` records and the schedule "
                        "sidecar, and demotes a worker whose per-step round seconds "
                        "exceed this factor x the median of the others, restoring it "
                        "when it recovers. One process runs every worker in one "
                        "batched program, so the only per-worker skew is a "
                        "`straggler` fault's injected seconds (--fault-plan)")
    p.add_argument("--straggler-min-steps", type=int, default=1,
                   help="floor for straggler demotions")
    p.add_argument("--outer-comm-dtype", type=str, default=None,
                   help="the outer pseudo-gradient's wire: a float dtype casts "
                        "(bfloat16), a signed-int dtype uses per-tensor absmax "
                        "quantization (int8, or int4)")
    p.add_argument("--outer-wire-collective", action="store_true",
                   help="quantize against one shared scale and sum the integers, so "
                        "the payload is the narrow integers (requires a signed-int "
                        "--outer-comm-dtype)")
    p.add_argument("--quarantine-nonfinite", action="store_true",
                   help="mask any worker with a non-finite replica or inner loss out "
                        "of the outer sync's mean; the sync's reset heals it (classic "
                        "rounds only)")
    p.add_argument("--offload-snapshot", action="store_true",
                   help="keep the DiLoCo sync snapshot in pinned host memory between "
                        "syncs")
    p.add_argument("--dynamics-metrics", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the DiLoCo dynamics at every sync (per-worker pseudo-gradient "
                        "norms, cross-worker drift, outer-momentum norm, pseudo-"
                        "gradient/update cosine) in the sync JSONL records; no effect "
                        "on training numerics (classic rounds only)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate the global snapshot on held-out data every N "
                        "outer syncs (0 = off)")
    p.add_argument("--eval-batches", type=int, default=8,
                   help="number of held-out eval batches to reserve")
    p.add_argument("--trace-out", type=str, default=None, metavar="JSON",
                   help="write a Chrome trace-event JSON of host-side round "
                        "phases (data/inner/sync/eval/ckpt)")
    p.add_argument("--status-file", type=str, default=None, metavar="JSON",
                   help="maintain a live status.json (atomic rewrite) with "
                        "state/step/loss/throughput/alarms for external pollers")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve live telemetry over HTTP on this port: /metrics "
                        "(OpenMetrics), /healthz (200/503 from the watchdog), POST "
                        "/debug/profile; 0 picks a free port (printed); unset = no "
                        "server")
    p.add_argument("--cost-analysis", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="log the one-time cost_analysis record (FLOPs per token of "
                        "one microbatch, counted on the meta device, and the card's "
                        "peak) for `report cost` and the mfu_analytic gate")
    p.add_argument("--watch-loss-zscore", type=float, default=6.0,
                   help="watchdog: alarm when a loss rises more than this many "
                        "rolling-window std-devs above the window mean (0 disables)")
    p.add_argument("--watch-loss-window", type=int, default=32,
                   help="watchdog: rolling window length for the spike and "
                        "throughput sentinels")
    p.add_argument("--watch-tps-collapse", type=float, default=0.4,
                   help="watchdog: alarm when tokens/sec drops below this fraction "
                        "of the rolling median (0 disables)")
    p.add_argument("--watch-stall-factor", type=float, default=5.0,
                   help="watchdog: alarm when no round heartbeat for this many times "
                        "the rolling round time, floored at $NANODILOCO_WATCH_MIN_"
                        "STALL_S (30 s) (0 disables the heartbeat thread)")
    p.add_argument("--watch-drift", type=float, default=0.0,
                   help="watchdog: alarm when a sync's drift_max exceeds this (0 "
                        "disables; needs the dynamics metrics)")
    p.add_argument("--watch-action", type=str, default="none",
                   choices=["none", "checkpoint-exit"],
                   help="what a fatal watchdog alarm (stall/NaN) does: "
                        "checkpoint-exit checkpoints at the next round boundary and "
                        "exits 76 for the supervisor (a wedged loop is force-exited "
                        "after $NANODILOCO_STALL_ESCALATE_S); none observes")
    p.add_argument("--fault-plan", type=str, default=None, metavar="JSON",
                   help="schedule-driven fault injection: a JSON plan of step-keyed "
                        "faults (nan_params/io_error/stall/crash/straggler/resize) "
                        "fired through the real loop, checkpoint and prefetch hooks")
    p.add_argument("--preempt-signals", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="install SIGTERM/SIGINT handlers that checkpoint at the "
                        "next round boundary and exit with code 75")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="checkpoint cadence in outer syncs")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--wandb", action="store_true",
                   help="also log every record to a wandb run, if wandb is installed "
                        "(the JSONL is written either way)")
    p.add_argument("--log-dir", type=str, default="runs")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--run-name", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_config_from_file(path: str) -> dict:
    """A JSON config file as a dict (the reference's main.py helper)."""
    with open(path) as f:
        return json.load(f)


def config_from_args(a: argparse.Namespace) -> TrainConfig:
    model_file = a.llama_config_file
    if not model_file and a.init_hf:
        # the imported checkpoint's own config describes its architecture
        candidate = os.path.join(a.init_hf, "config.json")
        if os.path.exists(candidate):
            model_file = candidate
    model = LlamaConfig.from_json(model_file) if model_file else LlamaConfig()
    overrides = {}
    if a.dtype:
        overrides["dtype"] = a.dtype
    if a.attention:
        overrides["attention_impl"] = a.attention
    if a.loss_chunk is not None:
        overrides["loss_chunk"] = a.loss_chunk
    if overrides:
        model = dataclasses.replace(model, **overrides)
    wandb_config = load_config_from_file(a.wandb_config_file) if a.wandb_config_file else {}
    measure_comm = (a.measure_comm if a.measure_comm is not None
                    else bool(wandb_config.get("measure_comms", True)))
    return TrainConfig(
        seed=a.seed, batch_size=a.batch_size,
        per_device_batch_size=a.per_device_batch_size, seq_length=a.seq_length,
        warmup_steps=a.warmup_steps, total_steps=a.total_steps,
        inner_steps=a.inner_steps, lr=a.lr, outer_lr=a.outer_lr, project=a.project,
        dataset_path=a.dataset_path, data_layout=a.data_layout,
        num_workers=a.num_workers, fsdp=a.fsdp, tp=a.tp, dcn_slices=a.dcn_slices,
        measure_comm=measure_comm, model=model,
        eval_every=a.eval_every, eval_batches=a.eval_batches, trace_out=a.trace_out,
        preempt_signals=a.preempt_signals, checkpoint_dir=a.checkpoint_dir,
        checkpoint_every=a.checkpoint_every, resume=not a.no_resume,
        use_wandb=a.wandb, log_dir=a.log_dir, quiet=a.quiet, run_name=a.run_name,
        wandb_config=wandb_config,
        streaming_fragments=a.streaming_fragments, streaming_delay=a.streaming_delay,
        merge_alpha=a.merge_alpha, async_outer=a.async_outer, outer_delay=a.outer_delay,
        inner_steps_per_worker=(
            tuple(int(h) for h in a.inner_steps_per_worker.split(","))
            if a.inner_steps_per_worker else None
        ),
        straggler_factor=a.straggler_factor, straggler_min_steps=a.straggler_min_steps,
        outer_comm_dtype=a.outer_comm_dtype, outer_wire_collective=a.outer_wire_collective,
        quarantine_nonfinite=a.quarantine_nonfinite, offload_snapshot=a.offload_snapshot,
        dynamics_metrics=a.dynamics_metrics, init_hf=a.init_hf, tokenizer=a.tokenizer,
        fit_vocab=a.fit_vocab, status_file=a.status_file, metrics_port=a.metrics_port,
        cost_analysis=a.cost_analysis, watch_loss_zscore=a.watch_loss_zscore,
        watch_loss_window=a.watch_loss_window, watch_tps_collapse=a.watch_tps_collapse,
        watch_stall_factor=a.watch_stall_factor, watch_drift=a.watch_drift,
        watch_action=a.watch_action, fault_plan=a.fault_plan,
    )


def report_main(argv: list[str]) -> None:
    """``report RUN.jsonl``: one-screen summary of a run's JSONL.
    ``report compare BASELINE CANDIDATE``: exit 1 when the candidate
    regresses past the thresholds. ``report cost|faults|goodput|drift
    RUN.jsonl`` and ``report blackbox DUMP.json``: the cost
    reconciliation, the resilience timeline, the stitched goodput
    budget, the dynamics timeline and a flight-recorder dump, as the JAX
    CLI prints them. ``report merge-trace SHARD... -o MERGED`` and
    ``report trace NEEDLE SHARD...``: one timeline of a fleet's trace
    shards, and one request's causal tree with its critical path.
    ``report timeseries SERIES.jsonl`` and ``report dashboard
    ARTIFACT.jsonl -o PAGE.html``: the sparkline timeline and the
    offline HTML dashboard of an ``obs-watch --series-jsonl`` artifact
    (or a serve stats JSONL)."""
    verbs = {"compare": report_compare_main, "cost": report_cost_main,
             "faults": report_faults_main, "goodput": report_goodput_main,
             "blackbox": report_blackbox_main, "drift": report_drift_main,
             "merge-trace": report_merge_trace_main, "trace": report_trace_main,
             "timeseries": report_timeseries_main,
             "dashboard": report_dashboard_main}
    if argv[:1] and argv[0] in verbs:
        verbs[argv[0]](argv[1:])
        return
    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch report")
    p.add_argument("jsonl", help="metrics JSONL written by training")
    p.add_argument("--json", action="store_true",
                   help="print the summary as one JSON object")
    args = p.parse_args(argv)

    summary = summarize_run(args.jsonl)
    if args.json:
        print(json.dumps(summary))
        return
    for k, v in summary.items():
        print(f"{k:>24}: {v}")


def report_compare_main(argv: list[str]) -> None:
    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch report compare")
    p.add_argument("baseline",
                   help="reference run: a metrics .jsonl, a `report --json` dump, "
                        "or a BASELINE.json with published numbers")
    p.add_argument("candidate", help="run under test (same formats)")
    p.add_argument("--max-loss-increase", type=float, default=0.02,
                   help="relative final/eval/best-loss increase that counts as a "
                        "regression (default 2%%)")
    p.add_argument("--max-tps-drop", type=float, default=0.2,
                   help="relative tokens/sec drop that counts as a regression "
                        "(default 20%%)")
    p.add_argument("--max-comm-share-increase", type=float, default=0.05,
                   help="ABSOLUTE comm-share increase that counts as a regression "
                        "(default +0.05)")
    p.add_argument("--max-latency-increase", type=float, default=0.5,
                   help="relative serve-latency (TTFT percentile) increase that "
                        "counts as a regression (default 50%%)")
    p.add_argument("--max-slo-burn-increase-s", type=float, default=5.0,
                   help="ABSOLUTE slo_burn_seconds increase that counts as a "
                        "regression (default +5 s)")
    p.add_argument("--json", action="store_true",
                   help="print the full diff as one JSON object")
    args = p.parse_args(argv)

    diff = compare_runs(
        load_comparable(args.baseline),
        load_comparable(args.candidate),
        max_loss_increase=args.max_loss_increase,
        max_tps_drop=args.max_tps_drop,
        max_comm_share_increase=args.max_comm_share_increase,
        max_latency_increase=args.max_latency_increase,
        max_slo_burn_increase_s=args.max_slo_burn_increase_s,
    )
    if args.json:
        print(json.dumps(diff))
    else:
        for k, m in diff["metrics"].items():
            mark = "REGRESSED" if m.get("regressed") else (
                "ok" if m.get("gated") else "ungated"
            )
            print(f"{k:>24}: {m.get('baseline')} -> {m.get('candidate')} [{mark}]")
        print(
            f"{'verdict':>24}: "
            + ("OK" if diff["ok"] else f"REGRESSION in {', '.join(diff['regressions'])}")
        )
    if not diff["ok"]:
        raise SystemExit(1)


def report_cost_main(argv: list[str]) -> None:
    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch report cost")
    p.add_argument("jsonl",
                   help="metrics JSONL from a run with cost capture on "
                        "(the default; --no-cost-analysis disables it)")
    p.add_argument("--json", action="store_true",
                   help="print the reconciliation as one JSON object")
    args = p.parse_args(argv)

    from nanodiloco_tpu_torch.training.metrics import find_cost_record, read_jsonl_records

    recs, _torn = read_jsonl_records(args.jsonl)
    cost = find_cost_record(recs)
    if cost is None:
        raise SystemExit(
            f"{args.jsonl} has no cost_analysis record: the run was "
            "started with --no-cost-analysis or predates cost capture"
        )

    from nanodiloco_tpu_torch.obs.costs import analytic_mfu

    out: dict = {"program": cost.get("program"),
                 "device_kind": cost.get("device_kind"),
                 "num_devices": cost.get("num_devices")}
    fpt = cost.get("flops_per_token")
    hand = cost.get("flops_per_token_hand")
    if fpt:
        out["flops_per_token_analytic"] = round(fpt, 1)
    if hand:
        out["flops_per_token_hand"] = round(hand, 1)
    if fpt and hand:
        out["analytic_vs_hand_ratio"] = round(fpt / hand, 4)
    # the dispatched executable's own (loop-bodies-once) analysis —
    # trend numbers, not per-token truths (obs/costs caveat)
    for k in ("flops_billed", "bytes_accessed_billed"):
        if k in cost:
            out[k] = cost[k]
    tps = [r["tokens_per_sec"] for r in recs
           if r.get("tokens_per_sec") is not None]
    if tps:
        out["tokens_per_sec_last"] = round(tps[-1], 1)
        mfu = analytic_mfu(cost, tps[-1])
        if mfu is not None:
            out["mfu_analytic"] = round(mfu, 5)
            out["peak_tflops"] = cost.get("peak_tflops")
        else:
            out["mfu_analytic"] = None  # no chip peak captured (e.g. CPU)
    # analytic-vs-ledger wire bytes: what sync_wire_bytes SAID a sync
    # moves vs what the per-round ledger actually accumulated
    per_sync = [r["wire_bytes_per_sync"] for r in recs
                if r.get("wire_bytes_per_sync") is not None]
    totals = [r["wire_bytes_total"] for r in recs
              if r.get("wire_bytes_total") is not None]
    syncs = sum(1 for r in recs if r.get("outer_synced"))
    if per_sync:
        out["wire_bytes_per_sync_analytic"] = int(per_sync[-1])
    if totals and syncs:
        ledger = totals[-1] / syncs
        out["wire_bytes_per_sync_ledger"] = int(ledger)
        if per_sync:
            out["wire_match"] = bool(abs(ledger - per_sync[-1]) < 0.5)
    if args.json:
        print(json.dumps(out))
        return
    for k, v in out.items():
        print(f"{k:>28}: {v}")


def report_faults_main(argv: list[str]) -> None:
    """``report faults RUN.jsonl``: one line per resilience event, in
    record order (the JSONL is append-only, so record order IS time
    order — even across restarts, which append to the same file). Of a
    fleet's ``--events-jsonl`` it also lists the deploy verdicts
    (``promote``, ``rollback``, ``rollback_failed``), which the JAX CLI
    leaves to ``report``'s counts, so one timeline shows what the
    canary did to the fleet."""
    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch report faults")
    p.add_argument("jsonl", help="metrics JSONL written by training")
    p.add_argument("--json", action="store_true",
                   help="print the event list as one JSON array")
    args = p.parse_args(argv)

    from nanodiloco_tpu_torch.training.metrics import read_jsonl_records

    recs, _torn = read_jsonl_records(args.jsonl)
    events = []
    for r in recs:
        if r.get("fault"):
            events.append({"event": "fault", "kind": r["fault"],
                           **{k: v for k, v in r.items() if k != "fault"}})
        elif r.get("alarm"):
            events.append({"event": "alarm", "kind": r["alarm"],
                           **{k: v for k, v in r.items() if k != "alarm"}})
        elif r.get("retry"):
            events.append({"event": "retry", "op": r["retry"],
                           **{k: v for k, v in r.items() if k != "retry"}})
        elif "resume" in r:
            events.append({"event": "resume", **r})
        elif r.get("preempt"):
            events.append({"event": "preempt", "reason": r["preempt"],
                           **{k: v for k, v in r.items() if k != "preempt"}})
        elif r.get("elastic"):
            # elastic DiLoCo decisions: straggler demote/restore, a
            # width change absorbed at resume, an H-schedule reset
            events.append({"event": "elastic", "kind": r["elastic"],
                           **{k: v for k, v in r.items() if k != "elastic"}})
        elif r.get("slo_alert"):
            # SLO burn-rate transitions (obs/slo): firing/resolved per
            # rule and target, with the burn seconds on resolve. The
            # record's own "kind" is the rule DIRECTION (ceiling/floor)
            # — renamed so it cannot shadow the rule name in the label
            events.append({"event": "slo_alert", "kind": r["slo_alert"],
                           **{("direction" if k == "kind" else k): v
                              for k, v in r.items()
                              if k != "slo_alert"}})
        elif r.get("deploy_event") in ("slo_burn", "slo_clear", "canary_deferred",
                                       "promote", "rollback", "rollback_failed"):
            # the router's side of the same incident: route-around
            # marks and deferred canaries, from a deploy JSONL passed
            # here directly; and (in the port only: the JAX verb leaves
            # them out) the deploy verdicts, so that a canary's promotion
            # and rollback read in order on the same timeline
            events.append({"event": r["deploy_event"],
                           **{k: v for k, v in r.items()
                              if k != "deploy_event"}})
        elif r.get("event") in ("scale_up", "scale_down"):
            # a supervisor --events-jsonl passed here directly: the
            # symmetric width-change events read like any other
            # resilience event (the other supervisor events keep their
            # own stream semantics)
            events.append(dict(r))
    if args.json:
        print(json.dumps(events))
        return
    if not events:
        print("no resilience events recorded (clean run)")
        return
    for e in events:
        detail = " ".join(
            f"{k}={v}" for k, v in e.items()
            if k not in ("event", "kind", "op", "reason", "step")
        )
        label = e.get("kind") or e.get("op") or e.get("reason") or ""
        print(f"step {e.get('step', '?'):>8}  {e['event']:<8} {label:<18} {detail}")


def report_goodput_main(argv: list[str]) -> None:
    """``report goodput RUN.jsonl``: the cause-ordered wall-clock budget
    table plus the goodput fraction — stitched across process lifetimes
    when the JSONL spans supervised restarts, so a crash-loopy run
    reports ONE honest end-to-end number (restart downtime included)."""
    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch report goodput")
    p.add_argument("jsonl", help="metrics JSONL written by training "
                                 "(goodput records are on by default)")
    p.add_argument("--json", action="store_true",
                   help="print the stitched ledger as one JSON object")
    args = p.parse_args(argv)

    from nanodiloco_tpu_torch.obs.goodput import CAUSES, stitch_goodput_records
    from nanodiloco_tpu_torch.training.metrics import read_jsonl_records

    recs, _torn = read_jsonl_records(args.jsonl)
    stitched = stitch_goodput_records(recs)
    if stitched is None:
        raise SystemExit(
            f"{args.jsonl} has no goodput records: the run predates the "
            "goodput ledger"
        )
    if args.json:
        print(json.dumps(stitched))
        return
    elapsed = stitched["elapsed_s"]
    print(f"{'elapsed':>18}: {elapsed:.3f} s over "
          f"{stitched['lifetimes']} process lifetime(s)")
    # cause-ordered budget: biggest first — the table an operator reads
    # top-down to find where the wall-clock went
    by_cause = sorted(
        ((c, stitched.get(f"{c}_s", 0.0)) for c in CAUSES),
        key=lambda cv: -cv[1],
    )
    for cause, s in by_cause:
        if s <= 0:
            continue
        share = s / elapsed if elapsed else 0.0
        print(f"{cause:>18}: {s:10.3f} s  {share:7.2%}")
    gf = stitched.get("goodput_fraction")
    print(f"{'goodput_fraction':>18}: "
          + (f"{gf:.4f}" if gf is not None else "n/a"))
    if stitched.get("badput_top_cause"):
        print(f"{'badput_top_cause':>18}: {stitched['badput_top_cause']}")
    if stitched.get("tokens_per_wall_s") is not None:
        print(f"{'tokens_per_wall_s':>18}: {stitched['tokens_per_wall_s']}"
              " (restarts included)")


def report_blackbox_main(argv: list[str]) -> None:
    """``report blackbox DUMP.json``: render a crash flight-recorder
    dump (obs/flightrec) as a last-N event timeline — the forensic view
    of a process's final moments."""
    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch report blackbox")
    p.add_argument("dump", help="a <run>-blackbox.json flight-recorder "
                                "dump (the supervisor's crash event "
                                "records its path)")
    p.add_argument("-n", "--last", type=int, default=50,
                   help="how many trailing events to show (default 50)")
    p.add_argument("--json", action="store_true",
                   help="print the raw dump document")
    args = p.parse_args(argv)

    with open(args.dump) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not doc.get("blackbox"):
        raise SystemExit(
            f"{args.dump} is not a flight-recorder dump (no 'blackbox' "
            "marker)"
        )
    if args.json:
        print(json.dumps(doc))
        return
    import datetime as _dt

    def _ts(t) -> str:
        if not isinstance(t, (int, float)):
            return "?"
        return _dt.datetime.fromtimestamp(t).strftime("%H:%M:%S.%f")[:-3]

    events = doc.get("events") or []
    print(f"blackbox: reason={doc.get('reason')} pid={doc.get('pid')} "
          f"dumped_at={_ts(doc.get('t_unix'))} "
          f"events={len(events)}"
          + (f" (+{doc['dropped_events']} older dropped)"
             if doc.get("dropped_events") else ""))
    for ev in (events[-args.last:] if args.last > 0 else []):
        data = ev.get("data") or {}
        detail = " ".join(f"{k}={v}" for k, v in data.items())
        if len(detail) > 140:
            detail = detail[:137] + "..."
        print(f"{_ts(ev.get('t_unix')):>14}  {ev.get('kind', '?'):<10} {detail}")


def report_drift_main(argv: list[str]) -> None:
    """``report drift RUN.jsonl``: one line per outer sync, in step
    order — the dynamics timeline a drift alarm sends an operator to.
    Divergence alarms interleave at their step so the timeline shows
    what the sentinel saw when it fired."""
    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch report drift")
    p.add_argument("jsonl", help="metrics JSONL from a run with "
                                 "--dynamics-metrics (the default)")
    p.add_argument("--json", action="store_true",
                   help="print the timeline as one JSON array")
    args = p.parse_args(argv)

    from nanodiloco_tpu_torch.training.metrics import read_jsonl_records

    recs, _torn = read_jsonl_records(args.jsonl)
    events = []
    for r in recs:
        if r.get("drift_max") is not None:
            events.append({
                "event": "sync",
                "step": r.get("step"),
                "drift_max": r["drift_max"],
                "drift_mean": r.get("drift_mean"),
                "pg_norm": r.get("pg_norm"),
                "outer_momentum_norm": r.get("outer_momentum_norm"),
                "outer_update_cos": r.get("outer_update_cos"),
                **({"quarantined_workers": r["quarantined_workers"]}
                   if r.get("quarantined_workers") else {}),
            })
        elif r.get("alarm") == "divergence":
            events.append({"event": "alarm", **r})
    if args.json:
        print(json.dumps(events))
        return
    if not events:
        print(
            "no dynamics records (run predates the dynamics metrics, "
            "used --no-dynamics-metrics, or streamed)"
        )
        return
    def num(e: dict, key: str, spec: str = ".4g") -> str:
        # keys may be PRESENT but None (a torn record, an older writer):
        # a dict.get default never fires then — format defensively
        v = e.get(key)
        return format(v, spec) if isinstance(v, (int, float)) else "?"

    def step_of(e: dict):
        # same present-but-null hazard: ">8" on None raises
        s = e.get("step")
        return "?" if s is None else s

    for e in events:
        if e["event"] == "alarm":
            print(
                f"step {step_of(e):>8}  ALARM divergence "
                f"drift={e.get('drift')} threshold={e.get('threshold')}"
            )
            continue
        # same present-but-null hazard for the list-valued key
        pg = [x for x in (e.get("pg_norm") or [])
              if isinstance(x, (int, float))]
        pg_s = (
            f" pg[min={min(pg):.4g} max={max(pg):.4g}]" if pg else ""
        )
        quar = (
            f" quarantined={e['quarantined_workers']}"
            if e.get("quarantined_workers") else ""
        )
        print(
            f"step {step_of(e):>8}  "
            f"drift_max={num(e, 'drift_max')} "
            f"drift_mean={num(e, 'drift_mean')}"
            f"{pg_s} "
            f"momentum={num(e, 'outer_momentum_norm')} "
            f"cos={num(e, 'outer_update_cos', '.3f')}{quar}"
        )


def export_hf_main(argv: list[str]) -> list[str]:
    """Export a trained checkpoint's merged snapshot as an HF-layout
    safetensors checkpoint plus ``config.json``, which
    ``transformers.LlamaForCausalLM.from_pretrained`` loads. Reads the
    snapshot memory-mapped on the host; writes one tensor at a time in
    float32. Returns the written file names."""
    from nanodiloco_tpu_torch.models.hf_interop import hf_config, save_hf_pretrained

    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch export-hf")
    p.add_argument("--checkpoint-dir", type=str, required=True)
    p.add_argument("--out", type=str, required=True,
                   help="output directory for the safetensors shard(s) + config.json")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("--max-shard-gb", type=float, default=5.0,
                   help="split the safetensors above this many GiB (HF sharded "
                        "layout with its index; 5 is transformers' own default)")
    args = p.parse_args(argv)
    model_cfg, _sidecar, snapshot = _load_checkpoint_snapshot(args.checkpoint_dir, args.step)
    os.makedirs(args.out, exist_ok=True)
    written = save_hf_pretrained(snapshot, model_cfg, args.out,
                                 max_shard_bytes=int(args.max_shard_gb * 1024**3))
    with open(os.path.join(args.out, "config.json"), "w") as f:
        json.dump(hf_config(model_cfg), f, indent=1)
    print(f"exported {', '.join(written)} to {args.out}")
    return written


def _load_checkpoint_snapshot(checkpoint_dir: str, step: int | None):
    """(model_cfg, sidecar dict, snapshot params) from a self-describing
    checkpoint: the merged global model alone, memory-mapped on the host,
    not the per-worker params or the optimizer moments."""
    from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager

    sidecar_path = os.path.join(checkpoint_dir, "model_config.json")
    try:
        with open(sidecar_path) as f:
            sidecar = json.load(f)
    except FileNotFoundError:
        raise SystemExit(
            f"no model_config.json in {checkpoint_dir}: this command needs "
            "a checkpoint written by this framework's training loop"
        )
    model_cfg = LlamaConfig.from_dict(sidecar["model"])
    state = CheckpointManager(checkpoint_dir).restore_raw(step, only={"snapshot"})
    return model_cfg, sidecar, state["snapshot"]


def build_generate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nanodiloco_tpu_torch generate",
        description="Sample text from a trained checkpoint.",
    )
    p.add_argument("--checkpoint-dir", type=str, required=True,
                   help="directory written by training with --checkpoint-dir; "
                        "its model_config.json sidecar makes the checkpoint "
                        "self-describing")
    p.add_argument("--prompt", type=str, default="The",
                   help="prompt text (encoded with the training tokenizer)")
    p.add_argument("--prompts-file", type=str, default=None,
                   help="file with one prompt per line, sampled as one batch "
                        "(variable lengths left-padded via pad_prompts); "
                        "overrides --prompt")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--temperature", type=float, default=0.8,
                   help="0 = greedy decoding")
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0,
                   help="nucleus sampling: keep the smallest token set "
                        "with probability mass >= p (1.0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to load (default: latest)")
    p.add_argument("--tokenizer", type=str, default=None,
                   help="override the tokenizer recorded at training time")
    p.add_argument("--stop-at-eos", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="end the continuation at the tokenizer's EOS token")
    p.add_argument("--device", type=str, default="cuda")
    return p


def generate_main(argv: list[str]) -> list[str]:
    """Prints one continuation per prompt; returns them."""
    from nanodiloco_tpu_torch.data.tokenizer import load_tokenizer
    from nanodiloco_tpu_torch.models.generate import generate, pad_prompts

    args = build_generate_parser().parse_args(argv)
    model_cfg, sidecar, params = _load_checkpoint_snapshot(args.checkpoint_dir, args.step)
    tokenizer = load_tokenizer(args.tokenizer or sidecar.get("tokenizer"))
    if args.prompts_file:
        with open(args.prompts_file) as f:
            prompts = [line for line in f.read().splitlines() if line.strip()]
        if not prompts:
            raise SystemExit(f"no prompts in {args.prompts_file}")
    else:
        prompts = [args.prompt]
    encoded = [tokenizer.encode(p) for p in prompts]
    for n, (p_text, ids) in enumerate(zip(prompts, encoded), start=1):
        if not ids:
            raise SystemExit(f"prompt {n} ({p_text!r}) is empty after tokenization")
        if any(i >= model_cfg.vocab_size for i in ids):
            raise SystemExit(
                f"prompt {n} ({p_text!r}) tokenizes outside the model "
                f"vocabulary ({model_cfg.vocab_size}); pass the training --tokenizer"
            )
    prompt, valid = pad_prompts(encoded)
    stop = getattr(tokenizer, "eos_id", None) if args.stop_at_eos else None
    out = generate(
        params, prompt, model_cfg, args.max_new_tokens, prompt_valid=valid,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed, stop_token=stop, device=args.device,
    )
    texts = []
    for row, text_in in zip(out.tolist(), prompts):
        if stop is not None and stop in row:
            row = row[: row.index(stop)]
        texts.append(text_in + tokenizer.decode(row))
        print(texts[-1], flush=True)
    return texts


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nanodiloco_tpu_torch serve",
        description="Continuous-batching inference server over a trained "
                    "checkpoint: POST /v1/generate, GET /healthz, GET /metrics.",
    )
    p.add_argument("--checkpoint-dir", type=str, required=True,
                   help="self-describing checkpoint written by training "
                        "with --checkpoint-dir (model_config.json sidecar)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to load (default: latest)")
    p.add_argument("--tokenizer", type=str, default=None,
                   help="override the tokenizer recorded at training time")
    p.add_argument("--port", type=int, default=0,
                   help="HTTP port; 0 (default) picks a free port, printed at startup")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--slots", type=int, default=4,
                   help="decode batch size B: concurrent requests decoded "
                        "per tick; each slot owns a KV-cache region")
    p.add_argument("--max-len", type=int, default=1024,
                   help="per-slot cache length: prompt + max_new_tokens "
                        "must fit (longer requests get 400)")
    p.add_argument("--max-queue", type=int, default=64,
                   help="admission queue depth; a full queue answers 429")
    p.add_argument("--chunk-size", type=int, default=64,
                   help="prefill chunk length: long prompts prefill in chunks "
                        "of at most this many tokens, one chunk interleaved per "
                        "decode tick; chunk lengths are bucketed to powers of two")
    p.add_argument("--prefix-cache-tokens", type=int, default=4096,
                   help="shared-prefix KV cache capacity in tokens; 0 disables")
    p.add_argument("--kv-block-size", type=int, default=0, metavar="TOKENS",
                   help="paged KV cache: one block arena shared by all slots, "
                        "a request holding only the blocks its prompt + "
                        "max_new_tokens need (clamped to a power of two <= "
                        "--chunk-size); 0 (default) = the dense per-slot cache")
    p.add_argument("--kv-dtype", choices=("model", "int8"), default="model",
                   help="KV cache storage dtype: 'model' (the compute dtype) or "
                        "'int8' (per-row scales; needs --kv-block-size)")
    p.add_argument("--kv-pool-blocks", type=int, default=None, metavar="N",
                   help="paged KV pool size in blocks (default: slots x "
                        "ceil(max_len / block)); paged mode only")
    p.add_argument("--tp", type=int, default=1, metavar="N",
                   help="tensor-parallel degree; only 1 is ported (ROADMAP.md, "
                        "Queue A item 7)")
    p.add_argument("--spec-k", type=int, default=0, metavar="K",
                   help="speculative decoding: verify up to K prompt-lookup "
                        "drafts per slot per tick (0 = off)")
    p.add_argument("--spec-ngram", type=int, default=3,
                   help="longest n-gram the prompt-lookup proposer matches")
    p.add_argument("--starvation-s", type=float, default=30.0,
                   help="starvation bound for priority admission: a queued "
                        "request older than this is admitted next regardless "
                        "of class; 0 = pure priority/EDF")
    p.add_argument("--stats-jsonl", type=str, default=None, metavar="JSONL",
                   help="append one final scheduler-stats record to this JSONL "
                        "at shutdown, readable by `report`")
    p.add_argument("--max-new-tokens", type=int, default=64,
                   help="default completion length for requests that omit it")
    p.add_argument("--max-new-tokens-cap", type=int, default=256,
                   help="upper bound a request may ask for")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="default per-request deadline (unset = no deadline)")
    p.add_argument("--request-timeout-s", type=float, default=600.0,
                   help="HTTP-level wait bound per request")
    p.add_argument("--trace-out", type=str, default=None, metavar="JSON",
                   help="export per-request serve spans (queued/prefill/decode) "
                        "as Chrome trace-event JSON at shutdown")
    p.add_argument("--trace-sample-rate", type=float, default=1.0, metavar="RATE",
                   help="head-sampling rate for trace contexts minted here")
    p.add_argument("--trace-reservoir", type=int, default=2, metavar="N",
                   help="unsampled traces per window promoted anyway (default 2)")
    p.add_argument("--blackbox", type=str, default=None, metavar="JSON",
                   help="arm the crash flight recorder: dump recent request "
                        "outcomes to this path if the engine loop dies")
    p.add_argument("--profile-dir", type=str, default=None, metavar="DIR",
                   help="enable POST /debug/profile?seconds=N: capture a "
                        "torch.profiler trace of the live process here")
    p.add_argument("--inject-tick-delay-s", type=float, default=0.0, metavar="S",
                   help="DRILL HOOK: sleep this long before every scheduling tick")
    p.add_argument("--role", type=str, default="both",
                   choices=("prefill", "decode", "both"),
                   help="disaggregation tier this replica declares in its "
                        "health body (routing only)")
    p.add_argument("--park-ttl-s", type=float, default=30.0,
                   help="seconds a prefilled-and-parked stream waits for export")
    p.add_argument("--device", type=str, default="cuda")
    return p


def serve_main(argv: list[str]) -> None:
    """Serve until SIGTERM or SIGINT."""
    import signal
    import threading

    from nanodiloco_tpu_torch.data.tokenizer import load_tokenizer
    from nanodiloco_tpu_torch.obs import flightrec
    from nanodiloco_tpu_torch.obs.tracer import SpanTracer
    from nanodiloco_tpu_torch.serve import InferenceEngine, Scheduler, ServeServer

    args = build_serve_parser().parse_args(argv)
    model_cfg, sidecar, params = _load_checkpoint_snapshot(args.checkpoint_dir, args.step)
    tokenizer = load_tokenizer(args.tokenizer or sidecar.get("tokenizer"))
    max_len = min(args.max_len, model_cfg.max_position_embeddings)
    engine = InferenceEngine(
        params, model_cfg, num_slots=args.slots, max_len=max_len,
        chunk_size=args.chunk_size, prefix_cache_tokens=args.prefix_cache_tokens,
        kv_block_size=args.kv_block_size, kv_dtype=args.kv_dtype,
        kv_pool_blocks=args.kv_pool_blocks, spec_k=args.spec_k,
        spec_ngram=args.spec_ngram, tp=args.tp, device=args.device,
    )
    del params  # the engine holds its own serving copy
    if args.spec_k:
        # run every verify width before traffic arrives
        engine.warm_spec()
    tracer = None
    if args.trace_out:
        # SAME clock as the scheduler (time.monotonic) so the recorded
        # request-phase timestamps land on this tracer's timebase
        tracer = SpanTracer(clock=time.monotonic, process_name="nanodiloco serve",
                            sample_rate=args.trace_sample_rate,
                            reservoir_per_window=args.trace_reservoir)
    scheduler = Scheduler(
        engine, max_queue=args.max_queue, tracer=tracer,
        starvation_s=args.starvation_s if args.starvation_s > 0 else None,
        park_ttl_s=args.park_ttl_s,
    )
    def swap_loader(ckpt_dir: str, step: int | None):
        """POST /admin/swap's loader: the restore boot used, plus an
        architecture check, so another config's checkpoint is a readable
        400, never a shape error out of the next tick."""
        new_cfg, _, new_params = _load_checkpoint_snapshot(ckpt_dir, step)
        if new_cfg != model_cfg:
            raise ValueError(
                f"checkpoint {ckpt_dir} was trained with a different model config than "
                "this replica serves; boot a new replica for architecture changes, hot "
                "swap is for same-shape weight updates")
        return new_params

    server = ServeServer(
        scheduler, tokenizer, port=args.port, host=args.host,
        default_max_new_tokens=args.max_new_tokens,
        max_new_tokens_cap=args.max_new_tokens_cap,
        request_timeout_s=args.request_timeout_s,
        default_deadline_s=args.deadline_s, profile_dir=args.profile_dir,
        swap_loader=swap_loader, tick_delay_s=args.inject_tick_delay_s, role=args.role,
    ).start()
    print(f"serving {args.checkpoint_dir} on {args.host}:{server.port} "
          f"(slots={args.slots}, max_len={max_len}, device={engine.device}); "
          "POST /v1/generate", flush=True)
    prev_recorder = None
    if args.blackbox:
        prev_recorder = flightrec.install(flightrec.FlightRecorder(dump_path=args.blackbox))
        flightrec.arm_fatal_signals()
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:  # not the main thread (embedded use)
            break
    try:
        while not stop.is_set():
            time.sleep(0.2)
    finally:
        server.stop()
        if args.stats_jsonl:
            try:
                _append_serve_stats(args.stats_jsonl, scheduler)
                print(f"serve stats -> {args.stats_jsonl}", flush=True)
            except OSError:
                pass  # a full disk must not mask the shutdown
        if tracer is not None:
            try:
                tracer.export_chrome(args.trace_out)
                print(f"serve span trace -> {args.trace_out}", flush=True)
            except OSError:
                pass
        if args.blackbox:
            flightrec.disarm_fatal_signals()
            flightrec.install(prev_recorder)


def _append_serve_stats(path: str, scheduler) -> None:
    """One flat ``serve_stats`` JSONL record from the scheduler's final
    snapshot (histograms dropped: the JSONL carries scalars, /metrics
    carries distributions)."""
    s = scheduler.stats()
    rec = {
        "serve_stats": True,
        "t_unix": round(time.time(), 3),
        **{k: v for k, v in s.items() if not k.startswith("hist_")},
    }
    for nested in ("kv_pool", "spec", "kvship"):
        if isinstance(rec.get(nested), dict):
            rec[nested] = {k: v for k, v in rec[nested].items() if not k.startswith("hist_")}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def build_fleet_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nanodiloco_tpu_torch fleet",
        description="Fleet router + canary deploy controller over N "
                    "serve replicas (nanodiloco_tpu_torch/fleet): POST "
                    "/v1/generate spreads load on queue-depth + "
                    "kv_blocks_free, /healthz-503 replicas are ejected "
                    "(blackbox attached), and --watch-checkpoint-dir "
                    "canaries every fresh training checkpoint with "
                    "promote-on-passing-compare-verdict / rollback.",
    )
    p.add_argument("--replica", action="append", required=True,
                   metavar="URL[,BLACKBOX]",
                   help="a serve replica's base URL, e.g. "
                        "http://127.0.0.1:8101 — repeat per replica. An "
                        "optional ,PATH names the replica's `serve "
                        "--blackbox` dump file, attached to its "
                        "ejection event")
    p.add_argument("--port", type=int, default=0,
                   help="router HTTP port; 0 (default) picks a free "
                        "port, printed at startup")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--events-jsonl", type=str, default=None,
                   metavar="JSONL",
                   help="append every deploy event (promote/rollback/"
                        "eject/drain/swap/canary) plus the final fleet-"
                        "goodput record here — readable by `report` / "
                        "summarize_run")
    p.add_argument("--health-interval-s", type=float, default=1.0,
                   help="replica probe cadence")
    p.add_argument("--eject-after", type=int, default=3,
                   help="consecutive UNREACHABLE probes before ejection "
                        "(an explicit /healthz 503 — a dead engine loop "
                        "— ejects immediately)")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="bounded wait for a draining replica's in-flight "
                        "streams before its weight swap proceeds (the "
                        "swap is safe under stragglers either way — "
                        "they finish on the old weights)")
    p.add_argument("--watch-checkpoint-dir", type=str, default=None,
                   metavar="DIR",
                   help="training --checkpoint-dir to watch: every "
                        "fresh checkpoint is canaried and promoted/"
                        "rolled back (unset = routing only)")
    p.add_argument("--initial-step", type=int, default=None,
                   help="checkpoint step the replicas booted with (the "
                        "first canary baseline; without it the first "
                        "discovered checkpoint promotes against no "
                        "baseline)")
    p.add_argument("--canary", type=str, default=None,
                   help="replica name (r0, r1, ...) to canary on; "
                        "default the first replica")
    p.add_argument("--poll-interval-s", type=float, default=2.0,
                   help="checkpoint-dir watch cadence")
    p.add_argument("--canary-clients", type=int, default=2,
                   help="closed-loop clients in the canary bench")
    p.add_argument("--canary-requests", type=int, default=2,
                   help="requests per canary client")
    p.add_argument("--canary-max-new-tokens", type=int, default=16)
    p.add_argument("--canary-prompt-len", type=int, default=12)
    p.add_argument("--max-loss-increase", type=float, default=0.02,
                   help="relative canary eval-loss increase that blocks "
                        "promotion (the `report compare` loss gate)")
    p.add_argument("--max-tps-drop", type=float, default=0.2,
                   help="relative canary tokens/s drop that blocks "
                        "promotion")
    p.add_argument("--max-latency-increase", type=float, default=0.5,
                   help="relative canary TTFT increase that blocks "
                        "promotion")
    p.add_argument("--trace-out", type=str, default=None, metavar="JSON",
                   help="export the router's per-request route/forward "
                        "spans (tagged with the request_id join key) as "
                        "a Chrome trace-event JSON at shutdown — `report "
                        "merge-trace` folds it with the replicas' serve "
                        "shards so one Perfetto timeline shows client "
                        "wait vs router hop vs queue vs prefill vs "
                        "decode per request")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   metavar="RATE",
                   help="head-sampling rate for causal trace contexts "
                        "minted at this router (the fleet edge decides "
                        "once; replicas inherit the decision off the "
                        "wire). 1.0 (default) samples everything")
    p.add_argument("--trace-reservoir", type=int, default=2, metavar="N",
                   help="always-on reservoir: up to N unsampled traces "
                        "per window are promoted anyway (default 2)")
    # predictive autoscaling (fleet/autoscaler.py): an embedded
    # collector scrapes the replicas, obs/forecast's CapacityModel
    # turns the series into exhaustion forecasts, and the control loop
    # launches/retires serve subprocesses through the router's drain
    # discipline — never from raw point gauges
    p.add_argument("--autoscale-template", type=str, default=None,
                   metavar="CMD",
                   help="enable the predictive autoscaler: a shell "
                        "command with a {port} placeholder that launches "
                        "one serve replica, e.g. 'python -m "
                        "nanodiloco_tpu_torch serve --checkpoint-dir C --port "
                        "{port}'. Children exiting with code 75 or by "
                        "SIGTERM are treated as spot preemptions and "
                        "relaunched immediately")
    p.add_argument("--autoscale-min", type=int, default=1,
                   help="fleet size floor (the seed --replica set "
                        "counts toward it)")
    p.add_argument("--autoscale-max", type=int, default=4,
                   help="fleet size ceiling")
    p.add_argument("--autoscale-interval-s", type=float, default=2.0,
                   help="observe->decide->act cadence (also the "
                        "embedded scrape cadence)")
    p.add_argument("--autoscale-cooldown-s", type=float, default=20.0,
                   help="minimum seconds between scale actions")
    p.add_argument("--autoscale-max-step", type=int, default=1,
                   help="replicas added/removed per action")
    p.add_argument("--autoscale-hysteresis", type=int, default=2,
                   help="consecutive agreeing ticks before a scale "
                        "action (forecast noise must not flap the "
                        "fleet)")
    p.add_argument("--autoscale-horizon-s", type=float, default=60.0,
                   help="scale out when a resource (kv_blocks_free, "
                        "queue depth vs slots) is forecast to exhaust "
                        "within this many seconds")
    p.add_argument("--autoscale-idle-ticks", type=int, default=5,
                   help="consecutive headroom ticks before scale-in")
    p.add_argument("--autoscale-window-s", type=float, default=60.0,
                   help="trend window for the capacity model's slope/"
                        "exhaustion queries")
    p.add_argument("--shed-horizon-s", type=float, default=10.0,
                   help="with the fleet at --autoscale-max, forecasted "
                        "exhaustion inside this horizon starts class-"
                        "aware shedding (lowest class first, one class "
                        "per tick)")
    p.add_argument("--admission-max-priority", type=int, default=9,
                   metavar="N",
                   help="initial admission ceiling: requests with "
                        "priority > N get a terminal shed 429 "
                        "({\"shed\": true}); 9 (default) admits every "
                        "class. The autoscaler moves this under "
                        "pressure")
    p.add_argument("--hedge-after-s", type=float, default=None,
                   metavar="S",
                   help="launch a hedge attempt on a second replica "
                        "when the first is this slow; unset = adaptive "
                        "(p95 of recent winner latencies once enough "
                        "samples exist); 0 disables hedging. First "
                        "answer wins, the loser is cancelled via "
                        "/v1/cancel")
    p.add_argument("--retry-budget-ratio", type=float, default=0.2,
                   help="retry-budget token-bucket refill per success "
                        "(retries admitted as a fraction of recent "
                        "successes; an empty bucket returns the "
                        "replica's honest error instead of amplifying "
                        "overload)")
    p.add_argument("--retry-budget-min", type=float, default=3.0,
                   help="retry-budget floor: failovers that never wait "
                        "on prior successes")
    p.add_argument("--breaker-window", type=int, default=20,
                   help="per-replica circuit-breaker rolling sample "
                        "window")
    p.add_argument("--breaker-min-samples", type=int, default=5,
                   help="samples in window before the breaker may trip")
    p.add_argument("--breaker-failure-rate", type=float, default=0.5,
                   help="bad fraction of the window that trips the "
                        "breaker (route-around, never ejection)")
    p.add_argument("--breaker-open-s", type=float, default=10.0,
                   help="seconds a tripped breaker stays open before "
                        "the half-open single-probe request")
    p.add_argument("--breaker-slow-s", type=float, default=None,
                   metavar="S",
                   help="count 200s slower than this as breaker "
                        "failures (a replica can be sick without "
                        "erroring); unset = errors only")
    p.add_argument("--chaos-plan", type=str, default=None,
                   metavar="JSON",
                   help="chaos drill: a fleet/chaos.py fault-plan file; "
                        "every replica is fronted by an in-process "
                        "ChaosProxy realizing the plan's wire faults "
                        "(latency, reset, blackhole, 500s, flapping "
                        "healthz, kill) keyed by per-replica request/"
                        "probe ordinals. Injections append {\"chaos\": "
                        "kind} records to --events-jsonl. kill faults "
                        "are record-only here (the CLI does not own the "
                        "replica processes) plus the wire abort")
    # disaggregated prefill/decode serving (fleet/disagg.py): replicas
    # declare a tier with `serve --role`, the router prefills on one
    # tier, ships the parked KV (serve/kvship.py), and resumes the
    # stream on the decode tier — streams stay bit-identical to solo
    # generate, and any handoff failure degrades to one honest
    # re-prefill on the decode tier
    p.add_argument("--disagg", action="store_true",
                   help="route each request through the prefill tier "
                        "then hand the KV off to the decode tier "
                        "(replicas declare tiers via `serve --role`); "
                        "with no prefill-tier replica ready the fleet "
                        "behaves exactly like a monolithic router")
    p.add_argument("--handoff-timeout-s", type=float, default=60.0,
                   help="bound on the prefill and KV-export legs of a "
                        "disaggregated handoff (the decode leg runs "
                        "under the normal request timeout)")
    p.add_argument("--autoscale-template-decode", type=str, default=None,
                   metavar="CMD",
                   help="with --disagg and --autoscale-template: the "
                        "launch command for DECODE-tier replicas "
                        "(--autoscale-template then launches the "
                        "prefill tier; both should pass `serve "
                        "--role ...`). Enables the two-loop tier "
                        "autoscaler — each tier sized off its own "
                        "pinned capacity model")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the canary's held-out loss (the "
                        "replicas choose their own with `serve --device`)")
    p.add_argument("--quiet", action="store_true")
    return p


def fleet_main(argv: list[str]) -> None:
    args = build_fleet_parser().parse_args(argv)
    import signal
    import threading

    from nanodiloco_tpu_torch.fleet import DeployController, FleetRouter, Replica

    replicas = []
    for i, spec in enumerate(args.replica):
        url, _, blackbox = spec.partition(",")
        replicas.append(Replica(
            name=f"r{i}", url=url.rstrip("/"),
            blackbox=blackbox or None,
        ))
    chaos_plan = None
    chaos_proxies = []
    if args.chaos_plan:
        from nanodiloco_tpu_torch.fleet.chaos import ChaosPlan, proxy_fleet

        chaos_plan = ChaosPlan.load(args.chaos_plan)
        # the router is pointed at the proxies, not the replicas: every
        # fault crosses a real socket, exactly as production would see
        # it. No on_kill — the CLI fronts replicas it does not own, so
        # kill faults are record-only plus the wire abort.
        replicas, chaos_proxies = proxy_fleet(replicas, chaos_plan)
        print(
            f"chaos drill: {len(chaos_plan.faults)} fault(s) from "
            f"{args.chaos_plan} on the wire in front of "
            f"{len(replicas)} replica(s)",
            flush=True,
        )
    tracer = None
    if args.trace_out:
        from nanodiloco_tpu_torch.obs.tracer import SpanTracer

        # SAME clock as the router (time.monotonic, its default); a
        # distinct process name keeps the router lane labeled when
        # merged with the replicas' serve shards
        tracer = SpanTracer(clock=time.monotonic,
                            process_name="nanodiloco router",
                            sample_rate=args.trace_sample_rate,
                            reservoir_per_window=args.trace_reservoir)
    router_cls = FleetRouter
    router_kw = {}
    if args.disagg:
        from nanodiloco_tpu_torch.fleet import DisaggRouter

        router_cls = DisaggRouter
        router_kw["handoff_timeout_s"] = args.handoff_timeout_s
    router = router_cls(
        replicas,
        port=args.port, host=args.host,
        **router_kw,
        events_jsonl=args.events_jsonl,
        health_interval_s=args.health_interval_s,
        eject_after_failures=args.eject_after,
        drain_timeout_s=args.drain_timeout_s,
        hedge_after_s=args.hedge_after_s,
        retry_budget_ratio=args.retry_budget_ratio,
        retry_budget_min=args.retry_budget_min,
        breaker_window=args.breaker_window,
        breaker_min_samples=args.breaker_min_samples,
        breaker_failure_rate=args.breaker_failure_rate,
        breaker_open_s=args.breaker_open_s,
        breaker_slow_s=args.breaker_slow_s,
        tracer=tracer,
        quiet=args.quiet,
    ).start()
    print(
        f"fleet router{' (disaggregated)' if args.disagg else ''} on "
        f"{args.host}:{router.port} over "
        f"{len(replicas)} replica(s): "
        + ", ".join(f"{r.name}={r.url}" for r in replicas),
        flush=True,
    )
    stop = threading.Event()
    controller_thread = None
    if args.watch_checkpoint_dir:
        controller = DeployController(
            router, args.watch_checkpoint_dir,
            initial_step=args.initial_step,
            canary=args.canary,
            poll_interval_s=args.poll_interval_s,
            max_loss_increase=args.max_loss_increase,
            max_tps_drop=args.max_tps_drop,
            max_latency_increase=args.max_latency_increase,
            bench_kwargs={
                "clients": args.canary_clients,
                "requests_per_client": args.canary_requests,
                "max_new_tokens": args.canary_max_new_tokens,
                "prompt_len": args.canary_prompt_len,
                "device": args.device,
            },
        )
        controller_thread = threading.Thread(
            target=controller.run, args=(stop,),
            name="nanodiloco-fleet-deploy", daemon=True,
        )
        controller_thread.start()
        print(
            f"watching {args.watch_checkpoint_dir} for checkpoints "
            f"(canary={controller.canary}, "
            f"deployed_step={controller.deployed_step})",
            flush=True,
        )
    if args.admission_max_priority != 9:
        router.set_admission(args.admission_max_priority,
                             reason="cli --admission-max-priority")
    scaler_thread = None
    provider = None
    decode_provider = None
    if args.autoscale_template:
        from nanodiloco_tpu_torch.fleet.autoscaler import (
            Autoscaler,
            ProcessReplicaProvider,
        )
        from nanodiloco_tpu_torch.obs.collector import Collector
        from nanodiloco_tpu_torch.obs.forecast import CapacityModel

        # the autoscaler never reads raw point gauges: an embedded
        # collector turns replica /metrics scrapes into time series,
        # and the capacity model turns those into slopes and
        # exhaustion forecasts the control loop acts on
        scrape_targets = [(r.name, r.url) for r in replicas]
        collector = Collector(
            scrape_targets, interval_s=args.autoscale_interval_s,
        )
        model = CapacityModel(
            collector.store, window_s=args.autoscale_window_s,
        )
        provider = ProcessReplicaProvider(
            args.autoscale_template, host=args.host,
        )
        scaler_kw = dict(
            min_replicas=args.autoscale_min,
            max_replicas=args.autoscale_max,
            interval_s=args.autoscale_interval_s,
            cooldown_s=args.autoscale_cooldown_s,
            max_step=args.autoscale_max_step,
            hysteresis_ticks=args.autoscale_hysteresis,
            scale_out_horizon_s=args.autoscale_horizon_s,
            scale_in_idle_ticks=args.autoscale_idle_ticks,
            shed_horizon_s=args.shed_horizon_s,
        )
        if args.disagg and args.autoscale_template_decode:
            # two tier-scoped loops over one fleet: each tier gets its
            # own provider (role-carrying launch template) and its own
            # capacity model pinned to that tier's usable replicas; the
            # decode loop owns the admission ceiling
            from nanodiloco_tpu_torch.fleet import DisaggAutoscaler, TierAutoscaler

            decode_provider = ProcessReplicaProvider(
                args.autoscale_template_decode, host=args.host,
            )
            decode_model = CapacityModel(
                collector.store, window_s=args.autoscale_window_s,
            )
            scaler = DisaggAutoscaler(
                TierAutoscaler(router, model, provider,
                               tier="prefill", **scaler_kw),
                TierAutoscaler(router, decode_model, decode_provider,
                               tier="decode", manage_admission=True,
                               **scaler_kw),
            )
        else:
            scaler = Autoscaler(router, model, provider, **scaler_kw)

        def _autoscale_loop() -> None:
            while not stop.is_set():
                # follow elastic membership: scrape exactly the
                # replicas the router currently tracks
                targets = []
                for n in router.replica_names():
                    try:
                        targets.append((n, router.url_of(n)))
                    except KeyError:
                        continue  # removed between calls
                if targets:
                    try:
                        collector.set_targets(targets)
                        collector.scrape_once()
                    except Exception:
                        pass  # a bad scrape must not kill the loop
                try:
                    scaler.tick()
                except Exception:
                    pass
                stop.wait(args.autoscale_interval_s)

        scaler_thread = threading.Thread(
            target=_autoscale_loop,
            name="nanodiloco-fleet-autoscale", daemon=True,
        )
        scaler_thread.start()
        print(
            f"autoscaler on ({args.autoscale_min}..{args.autoscale_max} "
            f"replicas, horizon {args.autoscale_horizon_s:g}s, "
            f"shed horizon {args.shed_horizon_s:g}s)",
            flush=True,
        )
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:  # not the main thread (embedded use)
            break
    def _drain_chaos() -> None:
        # fired-fault records -> the events JSONL ({"chaos": kind, ...}
        # timeline summarize_run reads); without a JSONL the record
        # still printed once per injection for the operator
        if chaos_plan is None:
            return
        for rec in chaos_plan.drain_fired():
            if args.events_jsonl:
                try:
                    with open(args.events_jsonl, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                except OSError:
                    pass  # a full disk must not kill the drill
            if not args.quiet:
                print(f"chaos injected: {json.dumps(rec)}", flush=True)

    try:
        while not stop.is_set():
            _drain_chaos()
            time.sleep(0.2)
    finally:
        stop.set()
        if controller_thread is not None:
            controller_thread.join(timeout=10)
        if scaler_thread is not None:
            scaler_thread.join(timeout=10)
        if provider is not None:
            provider.stop_all()
        if decode_provider is not None:
            decode_provider.stop_all()
        router.stop()
        for proxy in chaos_proxies:
            proxy.stop()
        _drain_chaos()
        if tracer is not None:
            try:
                tracer.export_chrome(args.trace_out)
                print(f"router span trace -> {args.trace_out}", flush=True)
            except OSError:
                pass  # a full disk must not mask the shutdown
        if args.events_jsonl:
            print(f"deploy events -> {args.events_jsonl}", flush=True)


def build_obs_watch_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nanodiloco_tpu_torch obs-watch",
        description="Fleet observability plane (nanodiloco_tpu_torch/obs): "
                    "scrape a set of /metrics endpoints into bounded "
                    "time series, evaluate multi-window SLO burn rates, "
                    "emit slo_alert JSONL records, and post burn "
                    "transitions to the fleet router (route-around + "
                    "canary gate).",
    )
    p.add_argument("--target", action="append", required=True,
                   metavar="NAME=URL",
                   help="a scrape target's name and base URL, e.g. "
                        "r0=http://127.0.0.1:8101 — repeat per target "
                        "(replicas, the router, the trainer's "
                        "--metrics-port). Replica names must match the "
                        "router's (r0, r1, ...) for route-around to "
                        "land on the right replica")
    p.add_argument("--interval-s", type=float, default=1.0,
                   help="scrape + evaluation cadence")
    p.add_argument("--duration-s", type=float, default=0.0,
                   help="stop after this long (0 = run until SIGTERM)")
    p.add_argument("--series-jsonl", type=str, default=None, metavar="JSONL",
                   help="append one snapshot record per scrape per "
                        "target — `report timeseries` renders the "
                        "incident timeline from it after the fact")
    p.add_argument("--alerts-jsonl", type=str, default=None, metavar="JSONL",
                   help="append slo_alert firing/resolved records plus "
                        "the final slo_summary — readable by `report "
                        "faults` / summarize_run / `report compare`")
    p.add_argument("--router-url", type=str, default=None, metavar="URL",
                   help="fleet router base URL: burn transitions POST to "
                        "its /fleet/slo endpoint (replica-scope rules "
                        "mark the replica not-preferred; fleet-scope "
                        "rules defer canaries). Unset = observe only")
    p.add_argument("--port", type=int, default=None,
                   help="serve the watcher's OWN /metrics "
                        "(nanodiloco_slo_alerts_total{rule}, burn "
                        "seconds, scrape counters) on this port; 0 "
                        "picks a free port; unset = no endpoint")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--maxlen", type=int, default=2048,
                   help="ring-buffer bound per series (oldest evicted)")
    # rule thresholds (unset = that rule is off)
    p.add_argument("--ttft-p95-max", type=float, default=None, metavar="S",
                   help="TTFT p95 ceiling per replica (seconds)")
    p.add_argument("--class0-ttft-p95-max", type=float, default=None,
                   metavar="S",
                   help="TTFT p95 ceiling for priority class 0 only "
                        "(seconds) — the SLO that class-aware shedding "
                        "exists to protect: it must hold even while "
                        "lower classes are shed with terminal 429s")
    p.add_argument("--decode-tps-min", type=float, default=None,
                   help="decode tokens/s floor per replica")
    p.add_argument("--error-rate-max", type=float, default=None,
                   help="error-outcome share ceiling over the window, "
                        "from requests_by_outcome counter increases")
    p.add_argument("--kv-blocks-free-min", type=float, default=None,
                   help="KV block headroom floor per replica")
    p.add_argument("--fleet-goodput-min", type=float, default=None,
                   help="fleet goodput fraction floor (fleet scope: "
                        "gates canaries)")
    p.add_argument("--outer-staleness-max", type=float, default=None,
                   help="trainer outer-staleness ceiling (fleet scope)")
    # burn-rate windows
    p.add_argument("--fast-window-s", type=float, default=5.0,
                   help="fast burn window: trips quickly on a live burn")
    p.add_argument("--slow-window-s", type=float, default=30.0,
                   help="slow burn window: confirms it is not a blip")
    p.add_argument("--fast-burn", type=float, default=0.5,
                   help="breach fraction of the fast window that trips")
    p.add_argument("--slow-burn", type=float, default=0.25,
                   help="breach fraction of the slow window that confirms")
    p.add_argument("--clear-debounce-s", type=float, default=5.0,
                   help="the fast window must stay clean this long "
                        "before an alert resolves (flap protection)")
    p.add_argument("--quiet", action="store_true")
    return p


def obs_watch_main(argv: list[str]) -> None:
    args = build_obs_watch_parser().parse_args(argv)
    import signal
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from nanodiloco_tpu_torch.obs.collector import Collector
    from nanodiloco_tpu_torch.obs.slo import (
        SLOMonitor,
        router_action_hook,
        standard_rules,
    )
    from nanodiloco_tpu_torch.obs.telemetry import OPENMETRICS_CONTENT_TYPE

    targets = []
    for spec in args.target:
        name, sep, url = spec.partition("=")
        if not sep or not name or not url:
            raise SystemExit(f"--target must be NAME=URL; got {spec!r}")
        targets.append((name, url))
    rules = standard_rules(
        ttft_p95_max_s=args.ttft_p95_max,
        class0_ttft_p95_max_s=args.class0_ttft_p95_max,
        decode_tps_min=args.decode_tps_min,
        error_rate_max=args.error_rate_max,
        kv_blocks_free_min=args.kv_blocks_free_min,
        fleet_goodput_min=args.fleet_goodput_min,
        outer_staleness_max=args.outer_staleness_max,
        fast_window_s=args.fast_window_s,
        slow_window_s=args.slow_window_s,
        fast_burn=args.fast_burn,
        slow_burn=args.slow_burn,
        clear_debounce_s=args.clear_debounce_s,
    )
    if not rules:
        raise SystemExit(
            "no SLO rule configured — pass at least one threshold "
            "(--ttft-p95-max, --error-rate-max, ...)"
        )
    collector = Collector(
        targets, interval_s=args.interval_s, maxlen=args.maxlen,
        series_jsonl=args.series_jsonl,
    )
    on_alert = None
    if args.router_url:
        from nanodiloco_tpu_torch.serve.client import http_post_json

        on_alert = router_action_hook(
            lambda url, doc: http_post_json(url, doc, timeout=10.0),
            args.router_url,
        )
    monitor = SLOMonitor(
        collector.store, rules, [n for n, _ in targets],
        alerts_jsonl=args.alerts_jsonl, on_alert=on_alert,
        quiet=args.quiet,
    )

    httpd = None
    if args.port is not None:
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # scrapes must not spam stdout
                pass

            def do_GET(self):
                if self.path.split("?", 1)[0] != "/metrics":
                    body, code, ctype = b"not found\n", 404, "text/plain"
                else:
                    body = (collector.render_metrics().rstrip("\n")
                            .rsplit("# EOF", 1)[0]
                            + monitor.render_metrics()).encode()
                    code, ctype = 200, OPENMETRICS_CONTENT_TYPE
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        httpd = ThreadingHTTPServer((args.host, args.port), Handler)
        httpd.daemon_threads = True
        threading.Thread(target=httpd.serve_forever,
                         name="nanodiloco-obs-watch-http",
                         daemon=True).start()
        print(f"obs-watch /metrics on {args.host}:"
              f"{httpd.server_address[1]}", flush=True)

    print(
        f"obs-watch: {len(targets)} target(s), {len(rules)} rule(s) "
        f"[{', '.join(r.name for r in rules)}], "
        f"windows {args.fast_window_s:g}s/{args.slow_window_s:g}s",
        flush=True,
    )
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:  # not the main thread (embedded use)
            break
    deadline = (time.monotonic() + args.duration_s
                if args.duration_s > 0 else None)

    def on_scrape(_result):
        monitor.evaluate()
        if deadline is not None and time.monotonic() >= deadline:
            stop.set()

    try:
        collector.run(stop, on_scrape=on_scrape)
    finally:
        summary = monitor.finalize()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if not args.quiet:
            print(f"obs-watch summary: "
                  f"{json.dumps(summary['slo_summary'])}", flush=True)
        if args.alerts_jsonl:
            print(f"slo alerts -> {args.alerts_jsonl}", flush=True)
        if args.series_jsonl:
            print(f"series -> {args.series_jsonl}", flush=True)


def report_merge_trace_main(argv: list[str]) -> None:
    p = argparse.ArgumentParser(
        prog="nanodiloco_tpu_torch report merge-trace",
        description="Fold per-process Chrome trace shards into one "
                    "timeline. Shards from causal tracing (spans "
                    "carrying trace_id/span_id in args) remain "
                    "backward-compatible: the ids merge through "
                    "untouched, and shards WITHOUT ids still join by "
                    "request_id — mix old and new freely.")
    p.add_argument("shards", nargs="+",
                   help="per-process Chrome trace shards: rank 0's "
                        "--trace-out file plus the trace.rank{k}.json "
                        "files the other hosts wrote next to it")
    p.add_argument("-o", "--out", required=True,
                   help="merged Chrome trace output path (open in "
                        "Perfetto / chrome://tracing)")
    args = p.parse_args(argv)

    from nanodiloco_tpu_torch.obs.tracer import merge_chrome_traces

    docs = []
    for path in args.shards:
        with open(path) as f:
            docs.append(json.load(f))
    merged = merge_chrome_traces(docs)
    d = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(merged, f)
    spans = sum(1 for e in merged["traceEvents"] if e.get("ph") == "X")
    pids = {e["pid"] for e in merged["traceEvents"]}
    print(
        f"merged {len(docs)} shard(s) -> {args.out} "
        f"({spans} spans across {len(pids)} process(es))"
    )


def report_trace_main(argv: list[str]) -> None:
    """``report trace NEEDLE SHARD...``: the hop-by-hop answer to
    "where did this request's latency go" — stitch per-process trace
    shards into one causal tree (parent links where the spans carry
    ids, request_id fallback where they don't), render the waterfall,
    and walk the critical path with the un-attributed remainder
    (network + stitch slack) reported as its own ``residual`` segment
    instead of silently dropped."""
    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch report trace")
    p.add_argument("needle",
                   help="request_id or 32-hex trace_id to reconstruct")
    p.add_argument("shards", nargs="+",
                   help="per-process Chrome trace shards (tracer "
                        "export_chrome / --trace-out files) — router + "
                        "each tier's shard for a fleet request")
    p.add_argument("--width", type=int, default=56,
                   help="waterfall bar width in characters (default 56)")
    p.add_argument("--json", action="store_true",
                   help="print the stitched tree + critical path as one "
                        "JSON object instead of the rendered waterfall")
    args = p.parse_args(argv)

    from nanodiloco_tpu_torch.obs.tracer import (
        critical_path,
        render_waterfall,
        stitch_trace,
    )

    docs = []
    for path in args.shards:
        with open(path) as f:
            docs.append(json.load(f))
    try:
        stitched = stitch_trace(docs, args.needle)
    except ValueError as e:
        print(f"error: {e}")
        raise SystemExit(1)
    segments = critical_path(stitched["root"])
    if args.json:
        print(json.dumps({**stitched, "critical_path": segments}))
        return
    print(render_waterfall(stitched, width=args.width))
    root = stitched["root"]
    total = root["end_s"] - root["start_s"]
    print(f"\ncritical path ({total * 1e3:.1f} ms total):")
    for seg in segments:
        share = seg["seconds"] / total if total > 0 else 0.0
        tail = f" [{seg['outcome']}]" if seg.get("outcome") else ""
        kind = "" if seg["kind"] == "span" else f" ({seg['kind']})"
        print(
            f"  {seg['seconds'] * 1e3:9.2f} ms {share:6.1%}  "
            f"{seg['span']}{kind}  @{seg['process']}{tail}"
        )


def report_timeseries_main(argv: list[str]) -> None:
    """``report timeseries SERIES.jsonl``: one sparkline per scraped
    series from the collector's snapshot JSONL — the operator's
    after-the-fact incident timeline (what did TTFT, the queue, and
    the KV pool do while the alert burned), no plotting stack needed."""
    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch report timeseries")
    p.add_argument("jsonl", help="series JSONL written by `obs-watch "
                                 "--series-jsonl` (obs/collector "
                                 "snapshot records)")
    p.add_argument("--key", type=str, default=None, metavar="SUBSTR",
                   help="only series whose key contains this substring "
                        "(e.g. ttft, r1:, _total)")
    p.add_argument("--width", type=int, default=60,
                   help="sparkline width in characters")
    p.add_argument("--all", action="store_true",
                   help="include constant series (hidden by default — "
                        "a flat gauge is rarely the incident)")
    p.add_argument("--json", action="store_true",
                   help="print {key: {n, first, last, min, max}} as one "
                        "JSON object")
    args = p.parse_args(argv)

    from nanodiloco_tpu_torch.obs.collector import read_series_jsonl, sparkline

    series = read_series_jsonl(args.jsonl)
    if args.key:
        series = {k: v for k, v in series.items() if args.key in k}
    if not series:
        raise SystemExit(
            f"no matching series in {args.jsonl}"
            + (f" for key substring {args.key!r}" if args.key else "")
        )
    out = {}
    for key in sorted(series):
        vals = [v for _, v in series[key]]
        if not args.all and min(vals) == max(vals):
            continue
        out[key] = {
            "n": len(vals),
            "first": vals[0], "last": vals[-1],
            "min": min(vals), "max": max(vals),
        }
    if args.json:
        print(json.dumps(out))
        return
    if not out:
        print("every series is constant (pass --all to show them)")
        return
    span = max(len(k) for k in out)
    for key, st in out.items():
        spark = sparkline([v for _, v in series[key]], width=args.width)
        print(f"{key:>{span}} |{spark}| "
              f"min={st['min']:.4g} max={st['max']:.4g} "
              f"last={st['last']:.4g} n={st['n']}")


def report_dashboard_main(argv: list[str]) -> None:
    """``report dashboard ARTIFACT.jsonl -o PAGE.html``: render the
    offline incident dashboard (obs/dashboard) — one self-contained
    HTML file, no scripts, no network, from a collector series JSONL
    (`obs-watch --series-jsonl`) or a serve stats JSONL."""
    p = argparse.ArgumentParser(prog="nanodiloco_tpu_torch report dashboard")
    p.add_argument("jsonl",
                   help="collector series JSONL (obs-watch "
                        "--series-jsonl) or serve stats JSONL "
                        "(serve --stats-jsonl)")
    p.add_argument("-o", "--out", required=True,
                   help="output HTML path")
    p.add_argument("--title", type=str, default="nanodiloco fleet",
                   help="page title")
    p.add_argument("--width", type=int, default=60,
                   help="sparkline width in characters")
    args = p.parse_args(argv)

    from nanodiloco_tpu_torch.obs.dashboard import (
        load_dashboard_series,
        render_dashboard,
    )

    series = load_dashboard_series(args.jsonl)
    page = render_dashboard(series, title=args.title, width=args.width)
    d = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        f.write(page)
    n_samples = sum(len(v) for v in series.values())
    print(f"rendered {len(series)} series ({n_samples} samples) "
          f"-> {args.out}")


def main(argv=None) -> dict | None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["supervise"]:
        from nanodiloco_tpu_torch.resilience.supervisor import supervise_main

        supervise_main(argv[1:])
        return None
    if argv[:1] == ["export-hf"]:
        export_hf_main(argv[1:])
        return None
    if argv[:1] == ["fleet"]:
        fleet_main(argv[1:])
        return None
    if argv[:1] == ["obs-watch"]:
        obs_watch_main(argv[1:])
        return None
    if argv[:1] == ["report"]:
        report_main(argv[1:])
        return None
    if argv[:1] == ["generate"]:
        generate_main(argv[1:])
        return None
    if argv[:1] == ["serve"]:
        serve_main(argv[1:])
        return None
    a = parse_args(argv)
    import torch.distributed as dist

    device, grouped = a.device, int(os.environ.get("WORLD_SIZE", "1")) > 1
    # a caller that already started the group keeps it (and ends it)
    own_group = grouped and not dist.is_initialized()
    if own_group:
        # launched by torchrun (one process per rank): NCCL on
        # cuda:LOCAL_RANK, gloo with --device cpu; rank 0 builds the
        # kernels while the others wait, so N ranks run nvcc once
        from nanodiloco_tpu_torch.parallel.mesh import init_from_env

        device = init_from_env(a.device)
        if device.type == "cuda":
            from nanodiloco_tpu_torch.ops.cuda import build

            if dist.get_rank() == 0:
                build.build_all()
            dist.barrier()
    try:
        summary = train(config_from_args(a), device=device)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()
    if not grouped or summary["rank"] == 0:
        print(json.dumps({k: v for k, v in summary.items() if k not in ("losses", "state")}))
    return summary


if __name__ == "__main__":
    main()
