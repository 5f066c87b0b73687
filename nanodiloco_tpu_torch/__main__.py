"""``python -m nanodiloco_tpu_torch``: the DiLoCo training job, with the
JAX CLI's flag names for every ``TrainConfig`` field the port has: data
(``--dataset-path X.tshrd``, ``--data-layout``), held-out evaluation
(``--eval-every``, ``--eval-batches``), checkpoint and resume
(``--checkpoint-dir``, ``--checkpoint-every``, ``--no-resume``), the
metrics JSONL (``--log-dir``, ``--run-name``), ``--measure-comm``,
``--trace-out`` and ``--preempt-signals`` (SIGTERM/SIGINT checkpoint at
the next round boundary and exit 75). Prints the metrics records and the
run summary last. Runs on the CUDA card unless ``--device cpu``.

``python -m nanodiloco_tpu_torch report RUN.jsonl`` summarizes a run's
JSONL; ``report compare BASELINE CANDIDATE`` is the regression gate
(exit 1 on a regression). Both give the JAX CLI's output, for a run of
either package.
"""

from __future__ import annotations

import argparse
import json
import sys

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


def main(argv=None) -> dict | None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["report"]:
        report_main(argv[1:])
        return None
    a = parse_args(argv)
    summary = train(config_from_args(a), device=a.device)
    print(json.dumps({k: v for k, v in summary.items() if k not in ("losses", "state")}))
    return summary


if __name__ == "__main__":
    main()
