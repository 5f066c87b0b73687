"""Metrics: the run JSONL, its summary and the regression gate.

A copy of ``nanodiloco_tpu/training/metrics.py`` (jax-free apart from
one ``jax.process_index()`` call; the JAX package's ``__init__`` imports
jax, so the port keeps its own). The port runs one process, so every
sink writes. ``summarize_run``, ``load_comparable`` and ``compare_runs``
are unchanged, so ``report`` and ``report compare`` read a run of either
package through either package and give the same answer.

Sinks: JSONL file (the source of truth), stdout, the live telemetry
mirror (``telemetry``, set by the train loop), and wandb when asked for
(``use_wandb``: the reference logged through wandb only) and installed;
if ``wandb`` is missing or cannot start a run, the JSONL remains.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

from nanodiloco_tpu_torch.obs import flightrec
from nanodiloco_tpu_torch.obs.costs import analytic_mfu
from nanodiloco_tpu_torch.obs.goodput import stitch_goodput_records


class SyncTimer:
    """Accumulates outer-sync wall-clock (the reference's avg_sync_time
    stub, real)."""

    def __init__(self) -> None:
        self._sync_time = 0.0
        self._sync_calls = 0
        self._t0: float | None = None

    def __enter__(self) -> "SyncTimer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self._sync_time += time.perf_counter() - self._t0
        self._sync_calls += 1
        self._t0 = None

    @property
    def avg_sync_time(self) -> float:
        return self._sync_time / self._sync_calls if self._sync_calls else 0.0

    @property
    def total(self) -> float:
        return self._sync_time

    @property
    def calls(self) -> int:
        return self._sync_calls


class MetricsLogger:
    def __init__(
        self,
        run_name: str,
        out_dir: str | None = None,
        use_wandb: bool = False,
        wandb_project: str = "nano-diloco",
        config: dict | None = None,
        quiet: bool = False,
        process_index: int | None = None,
    ) -> None:
        self.run_name = run_name
        # ALWAYS set, even for file-less runs and non-writer ranks: any
        # consumer probing logger.path must read None, not AttributeError
        self.path: str | None = None
        # optional live scrape mirror (obs/telemetry.TelemetryServer):
        # every record log() writes also updates its gauges, so /metrics
        # and the JSONL cannot disagree; assigned by the train loop
        self.telemetry = None
        # records may be logged from more than one thread; one lock keeps
        # JSONL lines whole (a torn line is exactly the corruption
        # summarize_run has to paper over)
        self._lock = threading.Lock()
        self._file = None
        self._wandb = None
        if process_index is None:
            import torch.distributed as dist

            process_index = (dist.get_rank()
                             if dist.is_available() and dist.is_initialized() else 0)
        # every sink is rank 0's: under a process group, N unguarded ranks
        # would mean N JSONL files, N wandb runs and N interleaved stdout
        # streams for one job (JAX metrics.py; injectable for tests)
        self.is_writer = process_index == 0
        self.quiet = quiet or not self.is_writer
        if not self.is_writer:
            return
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.path = os.path.join(out_dir, f"{run_name}.jsonl")
            self._file = open(self.path, "a")
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(project=wandb_project, name=run_name, config=config or {})
            except Exception:
                self._wandb = None  # wandb missing/offline: JSONL remains

    def log(self, metrics: dict[str, Any], step: int | None = None) -> None:
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        with self._lock:
            if self._file:
                self._file.write(json.dumps(rec) + "\n")
                self._file.flush()
            if self._wandb:
                self._wandb.log(rec)
        if self.telemetry is not None:
            try:
                self.telemetry.observe(rec)
            except Exception:
                pass  # a scrape-mirror bug must never take down training
        # black-box feed (obs/flightrec): every JSONL record also lands
        # in the bounded crash ring. No-op when no recorder is installed;
        # a ring bug must never take down training.
        try:
            flightrec.record_event("record", **rec)
        except Exception:
            pass
        if not self.quiet:
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
            )
            print(f"[{self.run_name}] {parts}", flush=True)

    def finish(self) -> None:
        with self._lock:
            if self._file:
                self._file.close()
                self._file = None
            if self._wandb:
                self._wandb.finish()
                self._wandb = None


def read_jsonl_records(path: str) -> tuple[list[dict], int]:
    """``(records, torn_line_count)`` from a run JSONL. A live writer
    mid-append (or a crash) leaves a torn trailing line; every consumer
    (``report``, ``report cost``, compare) must read the valid records,
    not traceback — ONE implementation of that tolerance."""
    recs: list[dict] = []
    torn = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                torn += 1
    return recs, torn


def find_cost_record(recs: list[dict]) -> dict | None:
    """The run's one-time ``cost_analysis`` record (obs/costs), or None
    — shared by ``summarize_run`` and ``report cost`` so the two can
    never disagree about which record counts."""
    return next(
        (r["cost_analysis"] for r in recs
         if isinstance(r.get("cost_analysis"), dict)),
        None,
    )


def summarize_run(path: str) -> dict[str, Any]:
    """One-screen summary of a training JSONL (the ``report`` CLI): loss
    and eval trajectory, throughput, sync share, and — when the run
    recorded them — quarantine events, HBM peak, and MoE router health.
    Keys appear only when the underlying metric was logged, mirroring
    the logger's own never-fake-zeros schema."""
    recs, torn = read_jsonl_records(path)
    if not recs:
        raise ValueError(f"no metric records in {path}")

    def series(key):
        return [r[key] for r in recs if r.get(key) is not None]

    losses = series("loss")
    out: dict[str, Any] = {
        # last record CARRYING a step — the trailing record may be a
        # step-less terminal one (the final goodput snapshot)
        "steps": next(
            (r["step"] for r in reversed(recs)
             if r.get("step") is not None),
            len(recs),
        ),
        "records": len(recs),
        **({"torn_lines_skipped": torn} if torn else {}),
        "first_loss": round(losses[0], 4) if losses else None,
        "final_loss": round(losses[-1], 4) if losses else None,
        "best_loss": round(min(losses), 4) if losses else None,
    }
    evals = series("eval_loss")
    if evals:
        out["first_eval_loss"] = round(evals[0], 4)
        out["final_eval_loss"] = round(evals[-1], 4)
    tps = series("tokens_per_sec")
    if tps:
        out["tokens_per_sec_last"] = round(tps[-1], 1)
    shares = series("comm_share")
    if shares:
        out["comm_share_last"] = round(shares[-1], 5)
    syncs = [r for r in recs if r.get("outer_synced")]
    out["outer_syncs"] = len(syncs)
    quar = series("quarantined_workers")
    if quar:
        out["quarantine_events"] = int(sum(1 for q in quar if q > 0))
        out["max_quarantined_workers"] = int(max(quar))
    # elastic DiLoCo (training/elastic.py): width timeline, straggler
    # demotions, per-worker realized H — keys appear only when the run
    # logged elastic records (older JSONLs summarize unchanged)
    active = series("workers_active")
    if active:
        out["workers_active_last"] = int(active[-1])
        if int(min(active)) != int(max(active)):
            out["workers_active_min"] = int(min(active))
            out["workers_active_max"] = int(max(active))
    elastic = [r for r in recs if r.get("elastic")]
    if elastic:
        out["elastic_events"] = len(elastic)
        ekinds: dict[str, int] = {}
        for e in elastic:
            ekinds[e["elastic"]] = ekinds.get(e["elastic"], 0) + 1
        out["elastic_kinds"] = ekinds
        if ekinds.get("straggler_demote"):
            out["straggler_demotions"] = ekinds["straggler_demote"]
    realized = series("inner_steps_realized")
    if realized:
        last = realized[-1]
        if isinstance(last, list) and last:
            out["inner_steps_realized_last"] = [int(h) for h in last]
            out["hetero_h_rounds"] = int(sum(
                1 for v in realized
                if isinstance(v, list) and len(set(v)) > 1
            ))
    hbm = series("hbm_peak_bytes")
    if hbm:
        out["hbm_peak_gib"] = round(max(hbm) / 2**30, 3)
    # DiLoCo dynamics (per-sync drift records; `report drift` prints the
    # full timeline) — summary keys appear only when the run logged them
    drift = series("drift_max")
    if drift:
        out["drift_max_last"] = round(drift[-1], 6)
        out["drift_max_peak"] = round(max(drift), 6)
    cos = series("outer_update_cos")
    if cos:
        out["outer_update_cos_last"] = round(cos[-1], 4)
    # async delayed-apply outer step: the realized staleness of each
    # applied merge (rounds late), plus the mode flag itself — so a
    # summary says which outer-sync regime produced the run's numbers
    stale = series("outer_staleness")
    if stale:
        out["outer_staleness_last"] = round(float(stale[-1]), 4)
        out["outer_staleness_max"] = round(float(max(stale)), 4)
    if any(r.get("async_outer") for r in recs):
        out["async_outer"] = True
        delays = series("outer_delay")
        if delays:
            out["outer_delay"] = int(delays[-1])
    drop = series("moe_dropped_frac")
    if drop:
        out["moe_dropped_frac_last"] = round(drop[-1], 5)
        out["moe_dropped_frac_max"] = round(max(drop), 5)
    ent = series("moe_router_entropy")
    if ent:
        out["moe_router_entropy_last"] = round(ent[-1], 4)
        out["moe_router_entropy_min"] = round(min(ent), 4)
    # SLO burn-rate alerts (obs/slo, written by obs-watch): fired
    # count, cumulative burn seconds (the compare-gated incident cost),
    # and the worst-burning rule. The monitor's final slo_summary
    # record is authoritative when present; without one (the monitor
    # died mid-run) the numbers are rebuilt from the alert records
    # themselves. Keys appear only when the JSONL carries SLO records —
    # older JSONLs summarize unchanged.
    slo_alerts = [r for r in recs if r.get("slo_alert")]
    slo_summary = next(
        (r["slo_summary"] for r in reversed(recs)
         if isinstance(r.get("slo_summary"), dict)),
        None,
    )
    if slo_alerts or slo_summary:
        if slo_summary:
            out["slo_alerts_total"] = int(slo_summary.get("alerts_total", 0))
            out["slo_burn_seconds"] = float(
                slo_summary.get("burn_seconds_total", 0.0)
            )
            if slo_summary.get("worst_rule"):
                out["slo_worst_rule"] = slo_summary["worst_rule"]
        else:
            fired = [r for r in slo_alerts if r.get("state") == "firing"]
            out["slo_alerts_total"] = len(fired)
            burn: dict[str, float] = {}
            for r in slo_alerts:
                if r.get("state") == "resolved" and isinstance(
                    r.get("burn_s"), (int, float)
                ):
                    burn[r["slo_alert"]] = (
                        burn.get(r["slo_alert"], 0.0) + float(r["burn_s"])
                    )
            out["slo_burn_seconds"] = round(sum(burn.values()), 3)
            if burn:
                out["slo_worst_rule"] = max(burn, key=burn.get)
    # observability stack (PR: obs/): alarms, wire bytes, phase budget
    alarms = [r for r in recs if r.get("alarm")]
    if alarms:
        out["alarms"] = len(alarms)
        kinds: dict[str, int] = {}
        for a in alarms:
            kinds[a["alarm"]] = kinds.get(a["alarm"], 0) + 1
        out["alarm_kinds"] = kinds
    # resilience stack (PR: resilience/): injected faults, resumes,
    # preempt exits, IO retries — the fault timeline's summary keys
    # (`report faults` prints the full ordered list)
    faults = [r for r in recs if r.get("fault")]
    if faults:
        out["faults"] = len(faults)
        fkinds: dict[str, int] = {}
        for f in faults:
            fkinds[f["fault"]] = fkinds.get(f["fault"], 0) + 1
        out["fault_kinds"] = fkinds
    # chaos harness (fleet/chaos): wire-level fault injections logged
    # as {"chaos": kind, "target": ..., "ordinal": ...} records by the
    # chaos bench/drill — same shape discipline as the fault timeline
    chaos = [r for r in recs if r.get("chaos")]
    if chaos:
        out["chaos_injected_total"] = len(chaos)
        ckinds: dict[str, int] = {}
        for c in chaos:
            ckinds[c["chaos"]] = ckinds.get(c["chaos"], 0) + 1
        out["chaos_kinds"] = ckinds
    resumes = [r for r in recs if "resume" in r]
    if resumes:
        out["resumes"] = len(resumes)
        restarts = [r.get("restart_count") for r in resumes
                    if r.get("restart_count") is not None]
        if restarts:
            out["restarts"] = int(max(restarts))
    preempts = [r for r in recs if r.get("preempt")]
    if preempts:
        out["preempt_exits"] = len(preempts)
    retries = [r for r in recs if r.get("retry")]
    if retries:
        out["io_retries"] = len(retries)
    wire = series("wire_bytes_per_sync")
    if wire:
        totals = series("wire_bytes_total")
        out["wire_bytes_total"] = int(totals[-1]) if totals else int(sum(wire))
        comp = series("wire_compression")
        if comp:
            out["wire_compression"] = comp[-1]
    # serving stack (nanodiloco_tpu/serve): a `serve --stats-jsonl`
    # session (or any embedder logging a serve_stats record) summarizes
    # with the same tooling as a training run — TTFT percentiles, chunk
    # counters, and the shared-prefix cache's hit economics
    serve = [r for r in recs if r.get("serve_stats")]
    if serve:
        last = serve[-1]
        for key, out_key in (
            ("served", "serve_served"),
            ("rejected", "serve_rejected"),
            ("expired", "serve_expired"),
            ("tokens_out", "serve_tokens_out"),
            ("prefill_chunks_total", "serve_prefill_chunks"),
            ("ttft_p50_s", "ttft_p50_s"),
            ("ttft_p95_s", "ttft_p95_s"),
            ("decode_tokens_per_sec", "decode_tokens_per_sec"),
        ):
            if last.get(key) is not None:
                out[out_key] = last[key]
        pc = last.get("prefix_cache")
        if isinstance(pc, dict):
            out["prefix_cache_hits"] = pc.get("hits")
            out["prefix_cache_misses"] = pc.get("misses")
            out["prefix_cache_hit_tokens"] = pc.get("hit_tokens")
            looked = (pc.get("hits") or 0) + (pc.get("misses") or 0)
            if looked:
                out["prefix_cache_hit_rate"] = round(
                    (pc.get("hits") or 0) / looked, 4
                )
        # paged KV block pool (kv_block_size > 0 serves): the same keys
        # the /metrics gauges export — absent from older JSONLs, whose
        # summaries are unchanged
        kv = last.get("kv_pool")
        if isinstance(kv, dict):
            out["kv_blocks_free"] = kv.get("blocks_free")
            out["kv_blocks_used"] = kv.get("blocks_used")
            out["kv_block_evictions"] = kv.get("block_evictions")
            if kv.get("block_size") is not None:
                out["kv_block_size"] = kv.get("block_size")
        for key in ("admission_blocked_no_slot",
                    "admission_blocked_no_blocks"):
            if last.get(key) is not None:
                out[f"serve_{key}"] = last[key]
        # tensor-parallel serving (tp > 1): the degree and the per-shard
        # free-block breakdown — absent from older JSONLs, whose
        # summaries are unchanged
        if last.get("tp_degree") is not None:
            out["serve_tp_degree"] = last["tp_degree"]
        if isinstance(kv, dict) and isinstance(
            kv.get("blocks_free_per_shard"), dict
        ):
            out["kv_blocks_free_per_shard"] = kv["blocks_free_per_shard"]
        # speculative decoding (spec_k > 0 serves): draft/accept
        # economics, same keys as the /metrics families — absent from
        # older JSONLs, whose summaries are unchanged
        spec = last.get("spec")
        if isinstance(spec, dict):
            for key, out_key in (
                ("draft_tokens", "spec_draft_tokens"),
                ("accepted_tokens", "spec_accepted_tokens"),
                ("rejected_tokens", "spec_rejected_tokens"),
                ("acceptance_rate", "spec_acceptance_rate"),
                ("tokens_per_tick_mean", "spec_tokens_per_tick"),
                ("spec_ticks", "spec_ticks"),
            ):
                if spec.get(key) is not None:
                    out[out_key] = spec[key]
        # device-time attribution (obs/devtime): the per-program
        # dispatch ledgers, per-class cost totals, and the decode
        # interference ratio — absent from older JSONLs, whose
        # summaries are unchanged
        dt = last.get("devtime")
        if isinstance(dt, dict) and dt.get("device_seconds_by_program"):
            out["device_seconds_by_program"] = (
                dt["device_seconds_by_program"]
            )
        if isinstance(dt, dict) and dt.get("compile_seconds_by_program"):
            out["compile_seconds_by_program"] = (
                dt["compile_seconds_by_program"]
            )
        dbp = last.get("device_seconds_by_priority")
        if isinstance(dbp, dict) and dbp:
            out["device_seconds_by_priority"] = dbp
            out["serve_device_seconds_total"] = round(
                sum(dbp.values()), 6
            )
        kbp = last.get("kv_block_seconds_by_priority")
        if isinstance(kbp, dict) and kbp:
            out["kv_block_seconds_by_priority"] = kbp
        if last.get("decode_interference_ratio") is not None:
            out["decode_interference_ratio"] = (
                last["decode_interference_ratio"]
            )
        # disaggregated serving (serve/kvship + fleet/disagg):
        # parked prefills and KV shipping volume — absent from older
        # JSONLs, whose summaries are unchanged
        for key in ("slots_parked", "park_expired"):
            if last.get(key) is not None:
                out[f"serve_{key}"] = last[key]
        ship = last.get("kvship")
        if isinstance(ship, dict):
            for key in ("export_requests", "export_bytes", "export_blocks",
                        "import_requests", "import_bytes", "import_blocks"):
                if ship.get(key) is not None:
                    out[f"kv_ship_{key}"] = ship[key]
            exp = ship.get("export_requests") or 0
            if exp and ship.get("export_bytes") is not None:
                out["kv_ship_bytes_per_request"] = round(
                    ship["export_bytes"] / exp, 1
                )
    # fleet deployment (nanodiloco_tpu/fleet): the deploy-event timeline
    # a `fleet --events-jsonl` session writes — promote/rollback/eject
    # counts, the last promoted step, and the router's final fleet-
    # goodput record. Keys appear only when the JSONL carries deploy
    # records; older JSONLs summarize unchanged.
    deploys = [r for r in recs if r.get("deploy_event")]
    if deploys:
        out["deploy_events"] = len(deploys)
        dkinds: dict[str, int] = {}
        for d in deploys:
            dkinds[d["deploy_event"]] = dkinds.get(d["deploy_event"], 0) + 1
        out["deploy_kinds"] = dkinds
        for kind, key in (("promote", "fleet_promotes"),
                          ("rollback", "fleet_rollbacks"),
                          ("eject", "fleet_ejections")):
            if dkinds.get(kind):
                out[key] = dkinds[kind]
        promoted = [d.get("step") for d in deploys
                    if d.get("deploy_event") == "promote"
                    and d.get("step") is not None]
        if promoted:
            out["deployed_step_last"] = int(promoted[-1])
    fleet = [r["fleet_goodput"] for r in recs
             if isinstance(r.get("fleet_goodput"), dict)]
    if fleet:
        last = fleet[-1]
        if last.get("fleet_goodput_fraction") is not None:
            out["fleet_goodput_fraction"] = last["fleet_goodput_fraction"]
        if last.get("replicas_total") is not None:
            out["fleet_replicas"] = last["replicas_total"]
        if last.get("replicas_ejected"):
            out["fleet_replicas_ejected"] = last["replicas_ejected"]
        if last.get("replica_ready_s") is not None:
            out["fleet_replica_ready_s"] = last["replica_ready_s"]
        # request-level resilience counters: absent from older
        # fleet_goodput records, and zero is not news — surface only
        # when the fleet actually hedged/retried/tripped
        for rk in ("hedges", "hedge_wins", "retries",
                   "retry_budget_exhausted", "deadline_expired",
                   "breaker_opens"):
            if last.get(rk):
                out[f"fleet_{rk}"] = last[rk]
        by_state = last.get("seconds_by_state")
        if isinstance(by_state, dict) and by_state.get("breaker_open"):
            out["fleet_breaker_open_s"] = by_state["breaker_open"]
    # goodput ledger (obs/goodput): stitch the per-lifetime snapshots —
    # a supervised crash-loopy run appends several lifetimes to ONE
    # JSONL, and the honest number is the merged fraction including the
    # restart downtime each resumed lifetime booked. Keys appear only
    # when the run logged goodput records (older JSONLs summarize as
    # before).
    stitched = stitch_goodput_records(recs)
    if stitched is not None:
        if stitched.get("goodput_fraction") is not None:
            out["goodput_fraction"] = stitched["goodput_fraction"]
        if stitched.get("badput_top_cause") is not None:
            out["badput_top_cause"] = stitched["badput_top_cause"]
        out["restart_downtime_s"] = stitched.get("restart_downtime_s", 0.0)
        if stitched.get("lifetimes", 1) > 1:
            out["goodput_lifetimes"] = stitched["lifetimes"]
        if stitched.get("tokens_per_wall_s") is not None:
            out["tokens_per_wall_s"] = stitched["tokens_per_wall_s"]
    phase_keys = sorted(
        {k for r in recs for k in r if k.startswith("t_") and r[k] is not None}
    )
    for k in phase_keys:
        vals = series(k)
        if vals:
            out[f"{k}_mean_s"] = round(sum(vals) / len(vals), 4)
    # XLA cost analytics (obs/costs): the one-time cost_analysis record
    # turns measured throughput into an analytic MFU — computed here so
    # report compare can gate it without touching the backend
    cost = find_cost_record(recs)
    if cost:
        fpt = cost.get("flops_per_token")
        if fpt:
            out["flops_per_token_analytic"] = round(float(fpt), 1)
        if tps:
            mfu = analytic_mfu(cost, tps[-1])
            if mfu is not None:
                out["mfu_analytic"] = round(mfu, 5)
    return out


# regression-gate metric directions: (summary key, lower_is_better)
_COMPARE_METRICS = [
    ("final_loss", True),
    ("final_eval_loss", True),
    ("best_loss", True),
    ("tokens_per_sec_last", False),
    ("comm_share_last", True),
    # analytic MFU (obs/costs cost record x measured tokens/sec): gated
    # only when BOTH summaries carry it — compare_runs' missing-metric
    # rule — so runs without a captured peak never fail on it. Shares
    # the throughput direction/threshold: it IS throughput, normalized.
    ("mfu_analytic", False),
    # serving metrics (scripts/serve_bench.py BENCH_SERVE records and
    # serve --stats-jsonl): latency keys gate on max_latency_increase
    # (CPU-bench latency is noisier than loss — a dedicated threshold,
    # not the 2% loss one), throughput keys on max_tps_drop. Only gated
    # when both sides carry them, so training compares are untouched.
    ("ttft_p50_s", True),
    ("ttft_p95_s", True),
    ("short_ttft_p95_s", True),
    ("decode_tokens_per_sec", False),
    ("client_tokens_per_sec", False),
    # paged-KV capacity keys (serve_bench --workload capacity): the two
    # directions of the same contract — a candidate must not spend more
    # HBM per resident token NOR fit fewer concurrent requests at the
    # fixed budget. Gated only when both summaries carry them.
    ("kv_hbm_bytes_per_token", True),
    ("max_concurrent_slots", False),
    # speculative decoding (serve_bench --workload repetitive): the
    # speedup on lookup-friendly traffic must not erode, acceptance and
    # emitted tokens/tick must not collapse, AND the adversarial
    # (no-accept) workload's spec-on/spec-off ratio must not sink —
    # both directions of the speculation contract. Gated only when
    # both summaries carry them.
    ("spec_speedup", False),
    ("spec_acceptance_rate", False),
    ("spec_tokens_per_tick", False),
    ("spec_adversarial_ratio", False),
    # tensor-parallel serving (serve_bench --workload capacity --tp N):
    # the per-layout decode throughput on the TP mesh must not erode.
    # The CPU numbers are an ABSOLUTE parity bar — virtual-device
    # shards pin program structure and correctness, the chip sitting
    # pins the speedup — compared TP-record vs TP-record, never TP vs
    # solo. Gated only when both summaries carry them. (The record's
    # headline ``tp_decode_tokens_per_sec`` mirrors the paged-int8
    # number and is deliberately NOT gated — gating the alias would
    # report the same regression twice.)
    ("tp_dense_decode_tokens_per_sec", False),
    ("tp_paged_fp_decode_tokens_per_sec", False),
    ("tp_paged_int8_decode_tokens_per_sec", False),
    # sync-vs-async outer-sync shares from the overlap bench differencing
    # (scripts/streaming_overlap.py / bench.py BENCH_ASYNC): the fraction
    # of a warm round the outer boundary costs in each mode. Shares are
    # already ratios — gated ABSOLUTE like comm_share, only when both
    # summaries carry them (training compares are untouched).
    ("outer_sync_share_sync", True),
    ("outer_sync_share_async", True),
    # canary quality (fleet/deploy.py canary_bench): held-out eval loss
    # of the checkpoint under canary — the deploy controller's verdict
    # runs THROUGH compare_runs, so the promotion gate and the CLI gate
    # are one implementation. Loss direction, loss threshold. Gated
    # only when both summaries carry it.
    ("canary_eval_loss", True),
    # fleet goodput (fleet/router.py): replica-seconds serving-and-
    # ready over all tracked replica-seconds — a share like comm_share
    # (ABSOLUTE threshold), higher is better (a drop is the regression).
    ("fleet_goodput_fraction", False),
    # autoscale surge workload (serve_bench --workload surge): the
    # protected class's TTFT p95 while lower classes shed (latency
    # class/threshold — it must hold under overload), and the total
    # sheds the surge provoked. Sheds gate BOTH WAYS on a wide relative
    # band (_SHED_KEYS): a surge candidate shedding far MORE means
    # overload handling regressed, shedding far LESS (or zero) means
    # admission control stopped firing and every class collapsed
    # together — both are failures of the same contract. Gated only
    # when both summaries carry them.
    ("class0_ttft_p95_s", True),
    ("shed_total", True),
    # goodput fraction (obs/goodput ledger, stitched across restarts):
    # a share of wall-clock like comm_share, so it gates on an ABSOLUTE
    # move past max_comm_share_increase — but HIGHER is better (a drop
    # is the regression). Only gated when both summaries carry it.
    ("goodput_fraction", False),
    # SLO burn seconds (obs/slo alerts in the run's JSONL): cumulative
    # firing time across rules — gated ABSOLUTE like the share class
    # (seconds are already a budget, a relative threshold would let a
    # near-zero baseline hide a real incident), lower is better, its
    # own threshold (max_slo_burn_increase_s). Gated only when both
    # summaries carry it, so SLO-less runs compare untouched.
    ("slo_burn_seconds", True),
    # device-second cost per token (serve_bench capacity and surge
    # records, obs/devtime attribution): gated BOTH directions on the
    # latency band (_COST_KEYS) — costlier tokens are a regression, and
    # a wildly CHEAPER number means the measurement window or the
    # attribution broke (fence removed, sections skipped), not that the
    # engine got 10x faster overnight. Gated only when both summaries
    # carry it.
    ("device_seconds_per_token", True),
    # chaos drill (serve_bench --workload chaos, fleet/chaos.py): the
    # highest-class goodput under the committed fault schedule — a
    # share, ABSOLUTE threshold, higher is better — and dropped
    # in-flight streams, which gate BOTH WAYS like sheds (more drops =
    # resilience regressed; the committed plan injects drops'-worth of
    # faults, so a bench that suddenly reports fewer opportunities to
    # drop means the schedule stopped firing). Gated only when both
    # summaries carry them.
    ("chaos_goodput_fraction", False),
    ("chaos_dropped_streams", True),
    # disaggregated serving (serve_bench --workload disagg): the
    # tiered fleet's long-prompt TTFT p95 (latency class/threshold) and
    # its decode throughput on the decode tier, which the whole split
    # exists to protect (tps class). kv_ship_bytes_per_request gates
    # BOTH WAYS on the cost band (_COST_KEYS semantics): heavier ships
    # mean the wire format bloated, and a wildly LIGHTER ship means the
    # export stopped carrying the whole cache — both break the
    # contract. Gated only when both summaries carry them.
    ("disagg_ttft_p95_s", True),
    ("disagg_decode_tokens_per_sec", False),
    ("kv_ship_bytes_per_request", True),
    # per-phase TTFT waterfall (serve_bench disagg): where the
    # handed-off request's first-token latency went — queue on the
    # prefill tier, prefill compute, the ship window, import admission.
    # Gated BOTH WAYS on the latency band (_PHASE_KEYS, 1 ms floor): a
    # slower phase is the regression the waterfall exists to localize,
    # and a phase that collapses to ~zero means its boundary clock
    # stopped being measured, not that the hop got free. Gated only
    # when both summaries carry them.
    ("disagg_phase_queue_p50_s", True),
    ("disagg_phase_queue_p95_s", True),
    ("disagg_phase_prefill_p50_s", True),
    ("disagg_phase_prefill_p95_s", True),
    ("disagg_phase_ship_p50_s", True),
    ("disagg_phase_ship_p95_s", True),
    ("disagg_phase_decode_admission_p50_s", True),
    ("disagg_phase_decode_admission_p95_s", True),
]

# share-of-wall-clock keys (already ratios): regress on an ABSOLUTE
# move past max_comm_share_increase, never a relative one; the
# regression direction follows the key's lower_better flag
_SHARE_KEYS = {"comm_share_last", "outer_sync_share_sync",
               "outer_sync_share_async", "goodput_fraction",
               "fleet_goodput_fraction", "chaos_goodput_fraction"}

# serve latency keys (seconds, lower better) that use the dedicated
# latency threshold instead of the loss one
_LATENCY_KEYS = {"ttft_p50_s", "ttft_p95_s", "short_ttft_p95_s",
                 "class0_ttft_p95_s", "disagg_ttft_p95_s"}

# shed counters regress in BOTH directions (see the _COMPARE_METRICS
# note): |delta| beyond the latency band (relative, floored at 1 so a
# near-zero baseline doesn't gate on a single extra shed)
_SHED_KEYS = {"shed_total", "chaos_dropped_streams"}

# SLO burn keys (seconds, absolute threshold, share-class semantics —
# regress on an absolute move past max_slo_burn_increase_s in the key's
# lower_better direction)
_SLO_BURN_KEYS = {"slo_burn_seconds"}

# per-token cost keys regress in BOTH directions on the relative
# latency band: |delta| beyond max_latency_increase x baseline — unlike
# _SHED_KEYS there is no count floor (the values are tiny fractions of
# a second, a 1.0 floor would never gate). kv_ship_bytes_per_request
# rides the same both-ways band: a heavier ship bloated the wire
# format, a wildly lighter one stopped shipping the whole cache.
_COST_KEYS = {"device_seconds_per_token", "kv_ship_bytes_per_request"}

# per-phase TTFT waterfall keys (serve_bench disagg): BOTH-ways
# relative band like _COST_KEYS, but floored at 1 ms — a queue phase
# idling near zero must not gate on sub-millisecond jitter, while a
# phase that grows OR vanishes past the band still trips the gate
_PHASE_KEYS = {
    f"disagg_phase_{ph}_{p}_s"
    for ph in ("queue", "prefill", "ship", "decode_admission")
    for p in ("p50", "p95")
}


def load_comparable(path: str) -> dict[str, Any]:
    """A summary dict for ``compare_runs`` from either a run JSONL or a
    plain-JSON summary/baseline file. A ``.json`` file may be a
    ``report --json`` dump or a BASELINE.json whose numbers live under
    ``"published"``; anything without at least one comparable metric is
    rejected loudly (a silently-empty baseline would gate nothing)."""
    if path.endswith(".jsonl"):
        return summarize_run(path)
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc.get("published"), dict) and doc["published"]:
        doc = doc["published"]
    if not any(k in doc for k, _ in _COMPARE_METRICS):
        raise ValueError(
            f"{path} has none of the comparable metrics "
            f"({', '.join(k for k, _ in _COMPARE_METRICS)}); pass a run "
            ".jsonl or a summary JSON"
        )
    return doc


def compare_runs(
    baseline: dict[str, Any],
    candidate: dict[str, Any],
    max_loss_increase: float = 0.02,
    max_tps_drop: float = 0.2,
    max_comm_share_increase: float = 0.05,
    max_latency_increase: float = 0.5,
    max_slo_burn_increase_s: float = 5.0,
) -> dict[str, Any]:
    """Diff two run summaries and flag regressions — the gate that turns
    a bench trajectory into an enforced contract (``report compare``
    exits non-zero when ``regressions`` is non-empty).

    Thresholds: losses regress when they INCREASE by more than
    ``max_loss_increase`` relative; throughput regresses when it DROPS
    by more than ``max_tps_drop`` relative; comm share regresses when
    it increases by more than ``max_comm_share_increase`` ABSOLUTE
    (shares are already ratios); serve latency percentiles (TTFT keys)
    regress when they increase by more than ``max_latency_increase``
    relative — a wide default (+50%), because closed-loop CPU latency
    is far noisier run to run than a loss trajectory; SLO burn seconds
    regress when they increase by more than ``max_slo_burn_increase_s``
    ABSOLUTE (an incident budget, not a ratio of one). Metrics present
    in only one summary are reported but never gate — a baseline
    without eval numbers must not fail every candidate that has them."""
    metrics: dict[str, Any] = {}
    regressions: list[str] = []
    for key, lower_better in _COMPARE_METRICS:
        b, c = baseline.get(key), candidate.get(key)
        if b is None or c is None:
            if b is not None or c is not None:
                metrics[key] = {"baseline": b, "candidate": c, "gated": False}
            continue
        b, c = float(b), float(c)
        delta = c - b
        if key in _SHARE_KEYS:
            regressed = (
                delta > max_comm_share_increase if lower_better
                else -delta > max_comm_share_increase
            )
        elif key in _SLO_BURN_KEYS:
            regressed = (
                delta > max_slo_burn_increase_s if lower_better
                else -delta > max_slo_burn_increase_s
            )
        elif key in _SHED_KEYS:
            regressed = abs(delta) > max_latency_increase * max(abs(b), 1.0)
        elif key in _COST_KEYS:
            regressed = abs(delta) > max_latency_increase * max(abs(b), 1e-12)
        elif key in _PHASE_KEYS:
            regressed = abs(delta) > max_latency_increase * max(abs(b), 1e-3)
        elif key in _LATENCY_KEYS:
            regressed = delta > max_latency_increase * max(abs(b), 1e-12)
        elif lower_better:
            regressed = delta > max_loss_increase * max(abs(b), 1e-12)
        else:
            regressed = -delta > max_tps_drop * max(abs(b), 1e-12)
        metrics[key] = {
            "baseline": b,
            "candidate": c,
            "delta": round(delta, 6),
            "gated": True,
            "regressed": regressed,
        }
        if regressed:
            regressions.append(key)
    return {
        "metrics": metrics,
        "regressions": regressions,
        "ok": not regressions,
    }
