#!/usr/bin/env python3
"""Time the port's flash-attention kernels in two checkouts on one card, in
turns (this tree, the other, the other, this tree), at the training shape of
chip_smoke.py (bf16, B=2, H=32, Hkv=8, S=2048, hd=128, causal).

    python3 scripts/torch_flash_ab.py --other build/parent [--rounds 2]

``--other`` is the root of another checkout of this repo (for example the
parent commit unpacked with ``git archive``). Each turn is a fresh process
that builds that checkout's kernels from its own sources and prints the
CUDA-event median over 20 samples of 10 launches back to back, per launch
(chip_smoke.py's timing), for each kernel; the script prints one JSON
line with every turn and the per-kernel median over each tree's turns, and
the card's name and power limit. Needs a CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# run inside each turn's process, with the checkout's root first on sys.path
TURN = r"""
import json, statistics, sys
import torch
sys.path.insert(0, sys.argv[1])
import nanodiloco_tpu_torch.ops.cuda.flash_attention as fa
from nanodiloco_tpu_torch.ops.cuda import build
assert fa.__file__.startswith(sys.argv[1]), fa.__file__
build.build_all()
b, h, hkv, s, hd = 2, 32, 8, 2048, 128
gen = torch.Generator(device="cuda").manual_seed(0)
rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
q, do = rnd(b * h, s, hd), rnd(b * h, s, hd)
k, v = rnd(b * hkv, s, hd), rnd(b * hkv, s, hd)
o, lse = fa.flash_fwd(q, k, v, True)
delta = (do.float() * o.float()).sum(-1, keepdim=True)
calls = {
    "flash_fwd": lambda: fa.flash_fwd(q, k, v, True),
    "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True),
    "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True),
}
out = {}
for name, fn in calls.items():
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    out[name] = statistics.median(times)
print(json.dumps(out))
"""


def turn(tree: Path) -> dict[str, float]:
    res = subprocess.run([sys.executable, "-c", TURN, str(tree.resolve())],
                         capture_output=True, text=True, check=True, cwd=tree)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    turns = []
    for r in range(args.rounds):
        order = [("this", ROOT), ("other", args.other)]
        for label, tree in order if r % 2 == 0 else order[::-1]:
            turns.append({"tree": label, "ms": turn(tree)})
    median = {
        label: {name: statistics.median(t["ms"][name] for t in turns if t["tree"] == label)
                for name in turns[0]["ms"]}
        for label in ("this", "other")
    }
    print(json.dumps({"nvidia_smi": smi, "other": str(args.other), "turns": turns,
                      "median_ms": median}))


if __name__ == "__main__":
    main()
