#!/usr/bin/env python3
"""Where a flash-attention wrapper call's host time goes, on one card.

    python3 scripts/torch_flash_host.py [--shape small_f32_hd64]

At one shape of ``scripts/torch_flash_ab.py`` (default train_small's), times
on the host clock, per call, a whole ``flash_fwd`` call and each piece of
its host work: the input checks, the two output allocations, the
``torch.cuda.device`` context, a current-stream handle as a
``torch.cuda.Stream`` and as the raw handle the wrappers take, the launch
through ctypes alone, and the launch counters. Each is the median of 5
samples of 2000 calls (500 for the two that launch), after a warm-up.
Prints one JSON line with the card's name and power limit. Needs a CUDA
card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_flash_ab import SHAPES  # noqa: E402

from nanodiloco_tpu_torch.ops.cuda import build  # noqa: E402
from nanodiloco_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402


def per_call_us(fn, n: int) -> float:
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        samples.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(samples)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", choices=sorted(SHAPES), default="small_f32_hd64")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dtype, b, h, hkv, s, hd, causal = SHAPES[args.shape]
    dtype = getattr(torch, dtype)
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b * h, s, hd, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(b * hkv, s, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    variant = fa.ROUTES["flash_fwd", dtype, hd]
    o, lse = fa.flash_fwd(q, k, v, causal)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr())
    shape = (b * h, h // hkv, s, s, int(causal), hd ** -0.5)
    stream = torch.cuda.current_stream().cuda_stream
    if variant == "tf32x3":
        def launch():
            return fa._tf32_lib().nd_flash_fwd_tf32(fa._DTYPE_CODE[dtype], hd, *ptrs, *shape,
                                                    stream)
    else:
        def launch():
            return fa._tc_lib().nd_flash_fwd_tc(hd, *ptrs, *shape, stream)

    def device_context():
        with torch.cuda.device(q.device):
            pass

    pieces = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal), 500),
        "check": (lambda: fa._check("flash_fwd", q, k, v), 2000),
        "allocations": (lambda: (torch.empty_like(q), torch.empty(
            (b * h, s, 1), device=q.device, dtype=torch.float32)), 2000),
        "device_context": (device_context, 2000),
        "stream_object": (lambda: torch.cuda.current_stream(q.device).cuda_stream, 2000),
        "stream_raw": (lambda: fa._stream(q), 2000),
        "ctypes_launch": (launch, 500),
        "counters": (lambda: fa._counted(fa.flash_fwd, variant, q, k, causal), 2000),
    }
    us = {name: per_call_us(fn, n) for name, (fn, n) in pieces.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(json.dumps({"nvidia_smi": smi, "shape": args.shape, "variant": variant,
                      "us_per_call": us}))


if __name__ == "__main__":
    main()
