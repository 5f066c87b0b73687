#!/usr/bin/env python3
"""Time the port's train() in two checkouts on one card, in turns, at the
8B-width configuration of chip_smoke.py's train phase (Llama-3-8B widths,
1 layer, W=2, H=2, grad_accum 2, S=2048, bf16 compute, flash attention),
with more rounds.

    python3 scripts/torch_train_ab.py --other build/parent [--rounds 4] [--turns 1]

``--other`` is the root of another checkout of this repo (for example the
parent commit unpacked with ``git archive``). Three variants run in the
order this, this with ``measure_comm=False`` (no fences around the outer
step), other, then the same backwards, ``--turns`` times; each run is a
fresh process (one training state on the card at a time) that builds its
checkout's kernels. Prints one JSON line per run (its round seconds and
``tokens_per_sec_after_first_round``), then one line with the medians per
variant and the card's name and power limit. Needs a CUDA card; fails
without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# run inside each turn's process: argv = root, rounds, measure_comm (-1 =
# leave the checkout's default: its TrainConfig may not have the field)
TURN = r"""
import dataclasses, json, sys
import torch
sys.path.insert(0, sys.argv[1])
from nanodiloco_tpu_torch.models.config import LLAMA3_8B
from nanodiloco_tpu_torch.training import train_loop
assert train_loop.__file__.startswith(sys.argv[1]), train_loop.__file__
rounds, measure_comm = int(sys.argv[2]), int(sys.argv[3])
extra = {} if measure_comm < 0 else {"measure_comm": bool(measure_comm), "log_dir": None}
cfg = train_loop.TrainConfig(
    seed=0, batch_size=2, per_device_batch_size=1, seq_length=2048, warmup_steps=1,
    total_steps=2 * rounds, inner_steps=2, num_workers=2,
    model=dataclasses.replace(LLAMA3_8B, num_hidden_layers=1), fit_vocab=False,
    quiet=True, **extra)
s = train_loop.train(cfg, device="cuda")
print(json.dumps({k: s[k] for k in ("round_seconds", "tokens_per_sec_after_first_round")}))
"""


def turn(tree: Path, rounds: int, measure_comm: int) -> dict:
    res = subprocess.run(
        [sys.executable, "-c", TURN, str(tree.resolve()), str(rounds), str(measure_comm)],
        capture_output=True, text=True, check=True, cwd=tree,
    )
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    variants = [("this", ROOT, 1), ("this_no_fence", ROOT, 0), ("other", args.other, -1)]
    runs = []
    for _ in range(args.turns):
        for label, tree, measure_comm in variants + variants[::-1]:
            run = {"variant": label, **turn(tree, args.rounds, measure_comm)}
            print(json.dumps(run), flush=True)
            runs.append(run)
    median = {
        label: statistics.median(r["tokens_per_sec_after_first_round"]
                                 for r in runs if r["variant"] == label)
        for label, _, _ in variants
    }
    print(json.dumps({"nvidia_smi": smi, "other": str(args.other), "rounds": args.rounds,
                      "median_tokens_per_sec_after_first_round": median}))


if __name__ == "__main__":
    main()
