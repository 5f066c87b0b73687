#!/usr/bin/env python3
"""Time the port's flash-attention kernels in two checkouts on one card, in
turns (this tree, the other, the other, this tree), at one or more shapes.

    python3 scripts/torch_flash_ab.py --other build/parent [--rounds 2]
        [--shape train_bf16 moe_hd64 moe64e_hd32 tiny_hd32]

``--other`` is the root of another checkout of this repo (for example the
parent commit unpacked with ``git archive``). ``--shape`` names shapes of
``SHAPES`` (default: chip_smoke.py's training shape, ``train_bf16``):

- ``train_bf16``: bf16, B 2, H 32, Hkv 8, S 2048, hd 128, causal (the 8B
  width's training in chip_smoke.py: W 2 x b 1);
- ``moe_hd64``: bf16, B 16, H 8, Hkv 4, S 1024, hd 64, causal
  (moe-8x-top2's training in chip_smoke.py: W 2 x b 8);
- ``moe64e_hd32``: bf16, B 16, H 8, Hkv 8, S 1024, hd 32, causal
  (configs/llama_moe_64e.json at the same W 2 x b 8);
- ``tiny_hd32``: bf16, B 8, H 4, Hkv 4, S 1024, hd 32, causal (bench.py's
  tiny model on one device);
- ``phi3_hd96`` / ``phi2_hd80``: bf16, B 2, H 32, Hkv 32, S 2048, hd 96 /
  80, causal (Phi-3-mini's and Phi-2's hidden 3072 and 2560 over 32 heads);
- ``gqa4_bf16_hd96`` (B 1, H 8, Hkv 2, S 256, causal) and
  ``noncausal_bf16_hd80`` (B 1, H 4, Hkv 4, S 77, not causal): chip_smoke.py's
  edge shapes of the hd-96 and hd-80 routes;
- ``small_f32_hd64``: float32, B 2, H 4, Hkv 2, S 200, hd 64, causal
  (chip_smoke.py's train_small and diloco_options_small);
- ``gqa4_f32``: float32, B 1, H 8, Hkv 2, S 320, hd 128, causal;
- ``tiny_f32_hd32``: float32, B 8, H 4, Hkv 4, S 1024, hd 32, causal
  (configs/llama_default.json in float32 at the reference CLI's batch 8,
  S 1024);
- ``moe_small_f32_hd16``: float32, B 2, H 4, Hkv 2, S 200, hd 16, causal
  (chip_smoke.py's moe_small);
- ``phi3_f32_hd96`` / ``phi2_f32_hd80``: phi3_hd96 and phi2_hd80 in float32;
- ``mha_f32_hd96`` (B 2, H 2, Hkv 2, S 128), ``ragged_gqa2_f32_hd80`` (B 1,
  H 4, Hkv 2, S 333) and ``ragged_gqa2_bf16_hd16`` (bf16, B 2, H 4, Hkv 2,
  S 200), all causal: chip_smoke.py's shapes of those routes;
- ``gemma2b_hd256``: bf16, B 2, H 8, Hkv 1, S 2048, hd 256, causal
  (Gemma-2B's attention), ``train_hd256`` the same at B 4 (chip_smoke.py's
  train_hd256: W 2 x b 2), and ``gemma2b_f32_hd256`` in float32 at B 1,
  S 1024.

B counts every worker's sequences: the model folds W x b into B before
attention.

Each turn is a fresh process that builds that checkout's kernels from its
own sources and prints, per shape, the CUDA-event median over 20 samples
of 10 launches back to back, per launch (chip_smoke.py's timing), for each
kernel, and for ``scaled_dot_product_attention`` on the same inputs (the
yardstick: its forward, and one backward for dQ, dK and dV together); and
under ``<name>_device`` the device's time alone (chip_smoke.py's
``device_ms``: 10 calls captured in one CUDA graph, replayed between CUDA
events, median of 20). The
script prints one JSON line with every turn and the per-shape, per-kernel
median over each tree's turns, and the card's name and power limit. Needs
a CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# name: (dtype, B, H, Hkv, S, hd, causal)
SHAPES = {
    "train_bf16": ("bfloat16", 2, 32, 8, 2048, 128, True),
    "moe_hd64": ("bfloat16", 16, 8, 4, 1024, 64, True),
    "moe64e_hd32": ("bfloat16", 16, 8, 8, 1024, 32, True),
    "tiny_hd32": ("bfloat16", 8, 4, 4, 1024, 32, True),
    "phi3_hd96": ("bfloat16", 2, 32, 32, 2048, 96, True),
    "phi2_hd80": ("bfloat16", 2, 32, 32, 2048, 80, True),
    "gqa4_bf16_hd96": ("bfloat16", 1, 8, 2, 256, 96, True),
    "noncausal_bf16_hd80": ("bfloat16", 1, 4, 4, 77, 80, False),
    "small_f32_hd64": ("float32", 2, 4, 2, 200, 64, True),
    "gqa4_f32": ("float32", 1, 8, 2, 320, 128, True),
    "tiny_f32_hd32": ("float32", 8, 4, 4, 1024, 32, True),
    "moe_small_f32_hd16": ("float32", 2, 4, 2, 200, 16, True),
    "phi3_f32_hd96": ("float32", 2, 32, 32, 2048, 96, True),
    "phi2_f32_hd80": ("float32", 2, 32, 32, 2048, 80, True),
    "mha_f32_hd96": ("float32", 2, 2, 2, 128, 96, True),
    "ragged_gqa2_f32_hd80": ("float32", 1, 4, 2, 333, 80, True),
    "ragged_gqa2_bf16_hd16": ("bfloat16", 2, 4, 2, 200, 16, True),
    "gemma2b_hd256": ("bfloat16", 2, 8, 1, 2048, 256, True),
    "train_hd256": ("bfloat16", 4, 8, 1, 2048, 256, True),
    "gemma2b_f32_hd256": ("float32", 1, 8, 1, 1024, 256, True),
}

# run inside each turn's process, with the checkout's root first on sys.path
TURN = r"""
import json, statistics, sys
import torch
sys.path.insert(0, sys.argv[1])
import nanodiloco_tpu_torch.ops.cuda.flash_attention as fa
from nanodiloco_tpu_torch.ops.cuda import build
assert fa.__file__.startswith(sys.argv[1]), fa.__file__
build.build_all()


def median_ms(fn):
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
    return statistics.median(times)


def device_ms(fn, stream):
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
        graph.capture_begin(capture_error_mode="relaxed")
        try:
            for _ in range(10):
                fn()
        finally:
            graph.capture_end()
    graph.replay()
    times = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    graph.reset()
    return statistics.median(times)


out = {}
for name, (dtype, b, h, hkv, s, hd, causal) in json.loads(sys.argv[2]).items():
    dtype = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, do = rnd(b * h, s, hd), rnd(b * h, s, hd)
    k, v = rnd(b * hkv, s, hd), rnd(b * hkv, s, hd)
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql, kl, vl = (x.view(b, -1, s, hd).detach().requires_grad_(True) for x in (q, k, v))
    ref = sdpa(ql, kl, vl, is_causal=causal, enable_gqa=True)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, causal),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
        "sdpa_fwd": lambda: sdpa(ql, kl, vl, is_causal=causal, enable_gqa=True),
        "sdpa_bwd": lambda: torch.autograd.grad(ref, (ql, kl, vl), do.view(b, h, s, hd),
                                                retain_graph=True),
    }
    out[name] = {kname: median_ms(fn) for kname, fn in calls.items()}
    # the graphs' stream, and SDPA leaves made on it (a captured backward
    # runs on its leaves' accumulators' stream)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        leaves = [x.detach().requires_grad_(True) for x in (ql, kl, vl)]
        ref_side = sdpa(*leaves, is_causal=causal, enable_gqa=True)
    calls["sdpa_fwd"] = lambda: sdpa(*leaves, is_causal=causal, enable_gqa=True)
    calls["sdpa_bwd"] = lambda: torch.autograd.grad(ref_side, leaves, do.view(b, h, s, hd),
                                                    retain_graph=True)
    out[name].update({f"{kname}_device": device_ms(fn, side) for kname, fn in calls.items()})
    # an older checkout has the table alone, no route()
    route = getattr(fa, "route", lambda kname, dtype, hd: fa.ROUTES[kname, dtype, hd])
    out[name]["variants"] = {kname: route(kname, dtype, hd) for kname in fa.KERNEL_NAMES}
print(json.dumps(out))
"""


def turn(tree: Path, shapes: dict) -> dict:
    res = subprocess.run([sys.executable, "-c", TURN, str(tree.resolve()), json.dumps(shapes)],
                         capture_output=True, text=True, check=True, cwd=tree)
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shape", nargs="+", choices=sorted(SHAPES), default=["train_bf16"])
    args = ap.parse_args()
    shapes = {name: SHAPES[name] for name in args.shape}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    turns = []
    for r in range(args.rounds):
        order = [("this", ROOT), ("other", args.other)]
        for label, tree in order if r % 2 == 0 else order[::-1]:
            turns.append({"tree": label, "ms": turn(tree, shapes)})
    median = {
        label: {
            shape: {name: statistics.median(t["ms"][shape][name] for t in turns
                                            if t["tree"] == label)
                    for name, ms in turns[0]["ms"][shape].items() if name != "variants"}
            for shape in shapes
        }
        for label in ("this", "other")
    }
    variants = {label: next(t["ms"] for t in turns if t["tree"] == label)
                for label in ("this", "other")}
    print(json.dumps({"nvidia_smi": smi, "other": str(args.other), "shapes": shapes,
                      "variants": {label: {shape: v[shape]["variants"] for shape in shapes}
                                   for label, v in variants.items()},
                      "turns": turns, "median_ms": median}))


if __name__ == "__main__":
    main()
