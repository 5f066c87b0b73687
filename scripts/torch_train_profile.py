#!/usr/bin/env python3
"""Where a DiLoCo round's time goes in the PyTorch/CUDA port, on one card.

    python3 scripts/torch_train_profile.py [--layers 1] [--out runs/torch_profile]

Runs the train phase of chip_smoke.py (Llama-3-8B width, depth cut to
``--layers``, W=2 workers, H=2, grad_accum 2, per-device batch 1, S=2048,
flash attention, bf16 compute over f32 master weights): one warm-up round,
then one round under ``torch.profiler``. Prints one JSON line with the
round's wall time, the device's busy and idle share, device time by group
(the flash kernels, with each kernel's own share, matrix products, the
AdamW and SGD steps, the other kernels), the top kernels and the host ops that launched the most device
time, and writes the Chrome trace to ``--out``. Needs a
CUDA card; fails without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nanodiloco_tpu_torch.data.pipeline import DilocoBatcher, pack_corpus, synthetic_corpus  # noqa: E402
from nanodiloco_tpu_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from nanodiloco_tpu_torch.models.config import LLAMA3_8B  # noqa: E402
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig  # noqa: E402

# kernel symbol names: the FMA kernels of csrc/flash_attention.cu and the
# tensor-core kernels of csrc/flash_attention_tc.cu
FLASH = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
         "flash_fwd_tc_kernel", "flash_bwd_dq_tc_kernel", "flash_bwd_dkv_tc_kernel")
GEMM = ("gemm", "cutlass", "xmma", "nvjet", "cublas")


def device_time(evt) -> float:
    """Self device time of a profiler event in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def total_device_time(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--out", type=str, default="runs/torch_profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    model = dataclasses.replace(LLAMA3_8B, num_hidden_layers=args.layers)
    dcfg = DilocoConfig(num_workers=2, inner_steps=2, warmup_steps=1, total_steps=4,
                        grad_accum=2)
    rows = pack_corpus(synthetic_corpus(seed=0), ByteTokenizer(), 2048)
    batches = iter(DilocoBatcher(rows, num_workers=2, grad_accum=2, per_device_batch=1))

    def next_round():
        steps = [next(batches) for _ in range(dcfg.inner_steps)]
        return np.stack([t for t, _ in steps]), np.stack([m for _, m in steps])

    dl = Diloco(model, dcfg, device="cuda")
    state = dl.init_state(torch.Generator(device="cuda").manual_seed(0))
    dl.round_step(state, *next_round())  # warm-up: cuBLAS plans, allocator, kernel load
    torch.cuda.synchronize()

    tokens, mask = next_round()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, losses = dl.round_step(state, tokens, mask)
        losses = losses.cpu()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    events = prof.key_averages()
    # a record_function range (e.g. Optimizer.step#AdamW.step) also shows
    # up as a device-side annotation; only real kernels count as busy time
    host_keys = {e.key for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host_keys]
    busy = sum(device_time(e) for e in kernels)
    ranges = {
        e.key: total_device_time(e) for e in events
        if e.key.startswith("Optimizer.step#") and e.device_type == torch.autograd.DeviceType.CPU
    }
    groups = {"flash_kernels": 0.0, "matmul": 0.0, "other_kernels": 0.0}
    flash = dict.fromkeys(FLASH, 0.0)
    for e in kernels:
        hit = [f for f in FLASH if f in e.key]
        if hit:
            groups["flash_kernels"] += device_time(e)
            flash[hit[0]] += device_time(e)
        elif any(g in e.key.lower() for g in GEMM):
            groups["matmul"] += device_time(e)
        else:
            groups["other_kernels"] += device_time(e)
    # the optimizer steps' kernels are elementwise: split them out of "other"
    groups["other_kernels"] -= sum(ranges.values())
    groups.update({k.removeprefix("Optimizer.step#"): v for k, v in ranges.items()})
    top = sorted(kernels, key=device_time, reverse=True)[:15]
    # the host-side op that launched each kernel: self device time of aten
    # ops, so every kernel is counted under exactly one op
    ops = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU and device_time(e) > 0]
    top_ops = sorted(ops, key=device_time, reverse=True)[:20]
    Path(args.out).mkdir(parents=True, exist_ok=True)
    trace = Path(args.out) / "torch_train_profile.json"
    prof.export_chrome_trace(str(trace))
    print(json.dumps({
        "nvidia_smi": smi,
        "layers": args.layers,
        "losses": losses.tolist(),
        "round_wall_ms": wall_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy / wall_us),
        "groups_ms": {k: v / 1e3 for k, v in groups.items()},
        "flash_ms": {k: v / 1e3 for k, v in flash.items() if v},
        "top_kernels": [
            {"name": e.key[:120], "ms": device_time(e) / 1e3, "calls": e.count} for e in top
        ],
        "top_ops": [
            {"name": e.key[:120], "ms": device_time(e) / 1e3, "calls": e.count}
            for e in top_ops
        ],
        "trace": str(trace),
    }))


if __name__ == "__main__":
    main()
