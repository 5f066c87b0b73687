#!/usr/bin/env python3
"""Profile serving at Llama-3-8B, full depth, on one CUDA card.

    python3 scripts/torch_serve_profile.py [--out DIR] [--layers 32]

Weights from seed 0 on the card (bf16 serving copy of the f32 masters),
an engine of 4 slots, max_len 1024, chunk 512. One warm decode tick at 4
live slots (each at position 512) and one warm 512-token prefill chunk
run under ``torch.profiler``; device time is grouped by what launched
it: ``matmul`` (the projections and the head, ``_linear``), ``attention``
(the score and value einsums, the mask and the softmax,
``_attend_dense``), ``sampling`` (``_sample_slots``) and ``elementwise``
(the rest: norms, RoPE, SwiGLU, residual adds, embedding gathers, cache
writes). The idle share is 1 - device-busy / the unprofiled tick's wall
time (the host read of the tokens ends each tick). If the profiler shows
no device time, the groups are "not measured" and the CUDA-event times
stand alone. Prints one JSON line and writes it, with the Chrome traces,
under ``--out`` (default ``runs/torch_serve_profile``). Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nanodiloco_tpu_torch.models.config import LLAMA3_8B  # noqa: E402
from nanodiloco_tpu_torch.models.llama import init_params  # noqa: E402
from nanodiloco_tpu_torch.serve import InferenceEngine  # noqa: E402

TG = importlib.import_module("nanodiloco_tpu_torch.models.generate")
GROUPS = {"matmul": "_linear", "attention": "_attend_dense", "sampling": "_sample_slots"}
PEAK_BYTES = 3.35e12
PEAK_FLOPS_BF16 = 989e12


def labelled(group: str, fn):
    def wrapper(*args, **kwargs):
        with record_function(f"serve::{group}"):
            return fn(*args, **kwargs)
    return wrapper


def profiled(fn, n: int, trace: Path) -> list[dict]:
    """Run ``fn`` n times under torch.profiler; export the Chrome trace and
    return its events."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    return json.loads(trace.read_text())["traceEvents"]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_ms(events: list[dict], n: int) -> float:
    """Device-busy ms per call: the union of the kernels', copies' and
    sets' intervals (the profiler's GPU-side annotation spans, which
    include the gaps between kernels, are not counted)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3 / n


def grouped_ms(events: list[dict], n: int) -> dict:
    """Device ms per call by group: each kernel goes to the ``serve::``
    range that encloses its launch (runtime or driver call, matched by
    correlation id); kernels launched outside every range are
    ``elementwise``."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"].split("::", 1)[1]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith("serve::"))
    starts = [r[0] for r in ranges]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = dict.fromkeys([*GROUPS, "elementwise"], 0.0)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = launch.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, ts) - 1 if ts is not None else -1
        group = ranges[i][2] if i >= 0 and ts <= ranges[i][1] else "elementwise"
        out[group] += e["dur"] / 1e3 / n
    return out


def cuda_event_ms(fn, n: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/torch_serve_profile")
    ap.add_argument("--layers", type=int, default=LLAMA3_8B.num_hidden_layers)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = dataclasses.replace(LLAMA3_8B, num_hidden_layers=args.layers)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    eng = InferenceEngine(params, cfg, num_slots=4, max_len=1024, chunk_size=512, device="cuda")
    del params
    torch.cuda.empty_cache()
    matmul_bytes = sum(t.numel() * 2 for k, t in eng.params["layers"].items()
                       if k in TG.MATMUL_KEYS) + eng.params["lm_head"].numel() * 2
    pos = 512
    for s in range(4):
        eng._active[s], eng._pos[s], eng._key_valid[s] = 1, pos, 1
    eng._dev_key_valid = None

    def tick():
        eng.step()  # ends in the host read of the tokens
        eng._pos[:] = pos

    toks = torch.randint(0, cfg.vocab_size, (1, 512), device="cuda")

    def chunk():
        eng._chunk(eng.params, eng.cache, toks, 0, 0, 511, None, 0.0, 0, 1.0)

    for _ in range(5):
        tick()
        chunk()
    # unlabelled: the times, and the device-busy union
    walls = []
    for _ in range(20):
        t0 = time.perf_counter()
        tick()
        walls.append((time.perf_counter() - t0) * 1e3)
    tick_ms = statistics.median(walls)
    tick_event_ms = cuda_event_ms(tick, 10)
    chunk_ms = cuda_event_ms(chunk, 5)
    tick_busy = busy_ms(profiled(tick, 5, out / "torch_serve_decode_trace.json"), 5)
    chunk_busy = busy_ms(profiled(chunk, 2, out / "torch_serve_prefill_trace.json"), 2)
    # labelled, for the split by group alone (the labels add host time)
    for g, name in GROUPS.items():
        setattr(TG, name, labelled(g, getattr(TG, name)))
    tick_groups = grouped_ms(profiled(tick, 5, out / "torch_serve_decode_groups.json"), 5)
    chunk_groups = grouped_ms(profiled(chunk, 2, out / "torch_serve_prefill_groups.json"), 2)
    kv_read = 4 * (pos + 1) * cfg.num_hidden_layers * 2 * cfg.kv_heads * cfg.head_dim * 2
    decode_bound = (matmul_bytes + kv_read) / PEAK_BYTES * 1e3
    layer_params = (matmul_bytes - eng.params["lm_head"].numel() * 2) // 2
    flops = (2.0 * 512 * layer_params + 4.0 * cfg.head_dim * cfg.num_attention_heads
             * cfg.num_hidden_layers * 512 * 513 / 2 + 2.0 * cfg.hidden_size * cfg.vocab_size)
    measured = tick_busy > 0
    result = {
        "script": "scripts/torch_serve_profile.py", "nvidia_smi": smi,
        "layers": cfg.num_hidden_layers, "slots": 4, "position": pos,
        "decode_tick": {
            "wall_ms": tick_ms, "cuda_event_ms": tick_event_ms, "bound_ms": decode_bound,
            "bound_by": "bytes", "bound_share": decode_bound / tick_ms,
            "device_busy_ms": tick_busy if measured else "not measured",
            "idle_share": max(0.0, 1.0 - tick_busy / tick_ms) if measured else "not measured",
            "groups_ms": tick_groups if measured else "not measured"},
        "prefill_chunk_512": {
            "cuda_event_ms": chunk_ms, "tflops": flops / chunk_ms / 1e9,
            "bound_ms": max(flops / PEAK_FLOPS_BF16, matmul_bytes / PEAK_BYTES) * 1e3,
            "bound_by": "operations",
            "device_busy_ms": chunk_busy if measured else "not measured",
            "groups_ms": chunk_groups if measured else "not measured"},
    }
    line = json.dumps(result)
    (out / "torch_serve_profile.json").write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        main()
