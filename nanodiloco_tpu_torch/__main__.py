"""``python -m nanodiloco_tpu_torch``: the DiLoCo training job, with the
JAX CLI's flag names for every ``TrainConfig`` field the port has: data
(``--dataset-path X.tshrd``, ``--data-layout``), held-out evaluation
(``--eval-every``, ``--eval-batches``), checkpoint and resume
(``--checkpoint-dir``, ``--checkpoint-every``, ``--no-resume``), the
metrics JSONL (``--log-dir``, ``--run-name``), ``--measure-comm``,
``--trace-out`` and ``--preempt-signals`` (SIGTERM/SIGINT checkpoint at
the next round boundary and exit 75), and the DiLoCo options
(``--streaming-fragments``, ``--streaming-delay``, ``--merge-alpha``,
``--async-outer``, ``--outer-delay``, ``--inner-steps-per-worker``,
``--straggler-factor``, ``--straggler-min-steps``, ``--outer-comm-dtype``,
``--outer-wire-collective``, ``--quarantine-nonfinite``,
``--offload-snapshot``, ``--dynamics-metrics/--no-dynamics-metrics``). Prints the metrics records and the
run summary last. Runs on the CUDA card unless ``--device cpu``.

``python -m nanodiloco_tpu_torch report RUN.jsonl`` summarizes a run's
JSONL; ``report compare BASELINE CANDIDATE`` is the regression gate
(exit 1 on a regression). Both give the JAX CLI's output, for a run of
either package.

``python -m nanodiloco_tpu_torch generate --checkpoint-dir DIR`` samples
text from a checkpoint's merged snapshot; ``serve --checkpoint-dir DIR``
runs the continuous-batching HTTP server over it (``POST /v1/generate``,
``GET /healthz``, ``GET /metrics``, ``POST /admin/swap`` to hot-swap
another checkpoint's weights in, ``/admin/kv/export`` and
``/admin/kv/import`` to ship a stream's KV rows). Both take the JAX
CLI's flags, plus ``--device`` (the card unless ``--device cpu``):
``--kv-block-size`` serves from a paged block arena, ``--kv-dtype int8``
stores it quantized, ``--spec-k`` turns on prompt-lookup speculative
decoding. ``--tp`` above 1 raises NotImplementedError (tensor-parallel
serving is not ported yet).
"""

from __future__ import annotations

import argparse
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
    p.add_argument("--dataset-path", type=str, default=None,
                   help="pre-tokenized .tshrd shard (scripts/prepare_data.py); "
                        "default: built-in synthetic corpus")
    p.add_argument("--llama-config-file", type=str, default=None,
                   help="HF-style model config JSON (configs/*.json)")
    p.add_argument("--data-layout", type=str, default="packed",
                   choices=["packed", "padded"],
                   help="packed (default): eos-joined stream cut into fixed-length "
                        "rows. padded: one document per row, pad positions masked "
                        "out of the loss")
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--measure-comm", action=argparse.BooleanOptionalAction, default=True,
                   help="fence the card around the outer step so avg_sync_time_s "
                        "and comm_share time the sync alone (default on)")
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
                        "sidecar. Its rule demotes a worker whose per-step round "
                        "seconds exceed this factor x the median of the others, but "
                        "this package models every worker's per-step seconds as the "
                        "round's wall time / H, so it never demotes until fault "
                        "injection, whose straggle seconds drive it, is ported "
                        "(ROADMAP.md, Queue A item 5)")
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
    p.add_argument("--preempt-signals", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="install SIGTERM/SIGINT handlers that checkpoint at the "
                        "next round boundary and exit with code 75")
    p.add_argument("--checkpoint-dir", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=1,
                   help="checkpoint cadence in outer syncs")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--log-dir", type=str, default="runs")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--run-name", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def config_from_args(a: argparse.Namespace) -> TrainConfig:
    model = (LlamaConfig.from_json(a.llama_config_file) if a.llama_config_file
             else LlamaConfig())
    return TrainConfig(
        seed=a.seed, batch_size=a.batch_size,
        per_device_batch_size=a.per_device_batch_size, seq_length=a.seq_length,
        warmup_steps=a.warmup_steps, total_steps=a.total_steps,
        inner_steps=a.inner_steps, lr=a.lr, outer_lr=a.outer_lr,
        dataset_path=a.dataset_path, data_layout=a.data_layout,
        num_workers=a.num_workers, measure_comm=a.measure_comm, model=model,
        eval_every=a.eval_every, eval_batches=a.eval_batches, trace_out=a.trace_out,
        preempt_signals=a.preempt_signals, checkpoint_dir=a.checkpoint_dir,
        checkpoint_every=a.checkpoint_every, resume=not a.no_resume,
        log_dir=a.log_dir, quiet=a.quiet, run_name=a.run_name,
        streaming_fragments=a.streaming_fragments, streaming_delay=a.streaming_delay,
        merge_alpha=a.merge_alpha, async_outer=a.async_outer, outer_delay=a.outer_delay,
        inner_steps_per_worker=(
            tuple(int(h) for h in a.inner_steps_per_worker.split(","))
            if a.inner_steps_per_worker else None
        ),
        straggler_factor=a.straggler_factor, straggler_min_steps=a.straggler_min_steps,
        outer_comm_dtype=a.outer_comm_dtype, outer_wire_collective=a.outer_wire_collective,
        quarantine_nonfinite=a.quarantine_nonfinite, offload_snapshot=a.offload_snapshot,
        dynamics_metrics=a.dynamics_metrics,
    )


def report_main(argv: list[str]) -> None:
    """``report RUN.jsonl``: one-screen summary of a run's JSONL.
    ``report compare BASELINE CANDIDATE``: exit 1 when the candidate
    regresses past the thresholds."""
    if argv[:1] == ["compare"]:
        report_compare_main(argv[1:])
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
    from nanodiloco_tpu_torch.data.tokenizer import get_tokenizer
    from nanodiloco_tpu_torch.models.generate import generate, pad_prompts

    args = build_generate_parser().parse_args(argv)
    model_cfg, sidecar, params = _load_checkpoint_snapshot(args.checkpoint_dir, args.step)
    tokenizer = get_tokenizer(args.tokenizer or sidecar.get("tokenizer"))
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

    from nanodiloco_tpu_torch.data.tokenizer import get_tokenizer
    from nanodiloco_tpu_torch.obs import flightrec
    from nanodiloco_tpu_torch.obs.tracer import SpanTracer
    from nanodiloco_tpu_torch.serve import InferenceEngine, Scheduler, ServeServer

    args = build_serve_parser().parse_args(argv)
    model_cfg, sidecar, params = _load_checkpoint_snapshot(args.checkpoint_dir, args.step)
    tokenizer = get_tokenizer(args.tokenizer or sidecar.get("tokenizer"))
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


def main(argv=None) -> dict | None:
    argv = sys.argv[1:] if argv is None else argv
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
    summary = train(config_from_args(a), device=a.device)
    print(json.dumps({k: v for k, v in summary.items() if k not in ("losses", "state")}))
    return summary


if __name__ == "__main__":
    main()
