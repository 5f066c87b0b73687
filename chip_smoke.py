#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nanodiloco_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; the first failure exits non-zero:

1. device      - a CUDA card must be present; its name and power limit.
2. build       - nvcc builds every kernel from nanodiloco_tpu_torch/csrc,
                 and g++ the tokenshard reader from csrc/tokenshard.cpp.
3. kernels     - each kernel against its plain PyTorch version on the
                 card, at the training shape (bf16, hd 128), at bf16 hd-128
                 edge shapes (ragged S, non-causal S < one tile, MHA) that
                 run the tensor-core B1, B2 and B3, and at one shape for every
                 other (dtype, head dim) row of the route table (float32
                 and bf16 at hd 32/64 run the FMA kernels); at the training
                 shape, CUDA-event times of the kernel, the plain version
                 and the PyTorch library call, the least time the card
                 could take (bound_ms), TFLOP/s and the share of the bound.
4. train_small - two DiLoCo rounds at a small float32 size from one
                 parameter tree, on the card and on the CPU: the losses
                 and the snapshot must agree.
5. resume      - train() at a small bf16 hd-128 size (2 layers, hidden
                 1024, 8/4 heads, S 512, W 2, H 2, grad_accum 2, 3 rounds):
                 two uninterrupted runs (bit-identical or not, and if not,
                 the first leaf that differs and the spread); one round
                 with a checkpoint, then a resumed run to round 3, which
                 must equal the uninterrupted one bit for bit (or within
                 the measured spread); `python -m nanodiloco_tpu_torch` on
                 a .tshrd shard in a subprocess, sent SIGTERM after its
                 first round, must exit 75 with a checkpoint at a round
                 boundary, and a rerun must finish the remaining rounds;
                 the checkpoint's bytes, save and restore seconds.
6. train       - the port's train(): two DiLoCo rounds at Llama-3-8B
                 width (1 layer, W=2 workers, H=2, grad_accum 2, S=2048)
                 with attention_impl="flash", an eval of the snapshot after
                 each round and the metrics JSONL; every kernel's launch
                 count must rise during this phase (counts are reset just
                 before it), every B1, B2 and B3 launch of this bf16 round
                 must have gone to the tensor-core (wgmma) variant, B1
                 must launch during the evals, the JSONL must hold one
                 record per inner step with the eval keys on each round's
                 last, and `report compare` of the run against itself must
                 pass. Then the 8B-width state is saved, zeroed, restored
                 leaf by leaf and checked leaf by leaf against its float64
                 sums, with the restore's peak device memory (left out,
                 with a line that says so, if the disk lacks 1.5x the
                 state's bytes).

7. serve_small - serving at a small float32 size (2 layers, hidden 128,
                 4/2 heads, vocab 384) from one parameter tree, TF32 off:
                 greedy generate() gives the same tokens on the card and
                 on the CPU, and its prefill logits agree; the sampling
                 noise's uniforms are the same bits on both; on each
                 device the engine (2 slots, chunk 8, prefix cache on)
                 serves 3 overlapping requests, greedy and sampled, each
                 token-identical to solo generate() with its seed; on a
                 checkpoint train() writes here, `python -m
                 nanodiloco_tpu_torch generate` prints its continuation
                 and `... serve`, in a subprocess, answers POST
                 /v1/generate over a socket with the tokens generate()
                 gives, and /healthz and /metrics.
8. serve       - Llama-3-8B at full width and full depth (32 layers, bf16,
                 weights from seed 0 on the card): an engine of 4 slots,
                 max_len 1024, chunk 512 serves 8 requests (prompts of
                 64-600 tokens, 64 new tokens each, greedy and sampled
                 mixed) submitted faster than they retire. Each greedy
                 stream must equal solo generate() or part from it first
                 at a near-tie, and each greedy token must be the argmax
                 of the training forward (through B1) over prompt and
                 stream, within the same near-tie tolerance (NEAR_TIE).
                 Prints the weight, cache and peak bytes; prefill ms per
                 chunk bucket against its FLOP bound; decode ms per tick
                 at 1 and 4 live slots against its byte bound; TTFT p50 /
                 p95, decode tokens/s, and the device's idle share in a
                 decode tick (torch.profiler). B1's launches in this phase
                 (the teacher-forcing forward alone: generation and the
                 engine run no kernel of their own) go to the kernels line
                 as "launches_serve".

Then the kernels line ({"kernels": [...]}), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Needs one card; builds into build/ and
writes its runs and checkpoints under build/chip_smoke/, removed at the
end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

import nanodiloco_tpu_torch.ops.cuda.flash_attention as fa
from nanodiloco_tpu_torch import __main__ as cli
from nanodiloco_tpu_torch.data import tokenshard
from nanodiloco_tpu_torch.data.pipeline import (
    DilocoBatcher,
    pack_corpus,
    pack_corpus_to_shard,
    synthetic_corpus,
)
from nanodiloco_tpu_torch.data.tokenizer import ByteTokenizer
from nanodiloco_tpu_torch.models.config import LLAMA3_8B, LlamaConfig
from nanodiloco_tpu_torch.models.generate import (
    MATMUL_KEYS,
    _cached_block,
    generate,
    init_kv_cache,
    noise_uniforms,
    serving_params,
)
from nanodiloco_tpu_torch.models.llama import forward, init_params, tree_leaves
from nanodiloco_tpu_torch.ops.cuda import build
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.serve import (
    GenRequest,
    InferenceEngine,
    Scheduler,
    http_get,
    http_post_json,
)
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager, named_leaves, state_tree
from nanodiloco_tpu_torch.training.metrics import read_jsonl_records, summarize_run
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

REPLACES = {
    "flash_fwd": "nanodiloco_tpu/ops/pallas/flash_attention.py:347",
    "flash_bwd_dq": "nanodiloco_tpu/ops/pallas/flash_attention.py:254",
    "flash_bwd_dkv": "nanodiloco_tpu/ops/pallas/flash_attention.py:292",
}
SOURCE = {  # by variant
    "fma": "nanodiloco_tpu_torch/csrc/flash_attention.cu",
    "wgmma": "nanodiloco_tpu_torch/csrc/flash_attention_tc.cu",
}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
# (name, dtype, B, H, Hkv, S, hd, causal); the first is the training shape
SHAPES = [
    ("train_bf16", torch.bfloat16, 2, 32, 8, 2048, 128, True),
    ("ragged_gqa4_bf16", torch.bfloat16, 1, 8, 2, 1000, 128, True),
    ("noncausal_gqa2_bf16", torch.bfloat16, 2, 4, 2, 77, 128, False),
    ("mha_bf16", torch.bfloat16, 2, 4, 4, 256, 128, True),
    ("gqa2_bf16_hd64", torch.bfloat16, 2, 4, 2, 320, 64, True),
    ("noncausal_bf16_hd32", torch.bfloat16, 2, 4, 4, 192, 32, False),
    ("mha_f32", torch.float32, 2, 4, 4, 256, 64, True),
    ("gqa4_f32", torch.float32, 1, 8, 2, 320, 128, True),
    ("noncausal_gqa2_f32", torch.float32, 2, 4, 2, 192, 32, False),
    ("ragged_f32", torch.float32, 1, 4, 1, 1000, 128, True),
    ("ragged_noncausal_f32", torch.float32, 1, 2, 2, 77, 64, False),
]
# |kernel - plain| <= ATOL * max|plain| + RTOL * |plain|, elementwise, per
# (dtype, variant). The FMA kernels compute in float32 from the same inputs
# as the plain versions and differ only in summation order: ~1e-6 relative
# in float32, and in bf16 the two float32 results may round to neighbouring
# bf16 values (RTOL 2**-7). The tensor-core kernels also round P (B1), dS
# (B2) and P and dS (B3) to bf16 (relative error <= 2**-9 each) as the left
# operand of the last product, where the plain versions keep float32 (rounding
# error up to 2**-8 of each term). Summed over a row of random-signed terms
# that adds an error of about 2**-8 / sqrt(3) of the output's rms, a few
# times that at the worst of millions of outputs: ATOL 2**-8 of max|plain|
# for those kernels, about twice the largest need measured on the card
# (2.04e-3, dK at the MHA S=256 shape, where the FMA kernels' 2e-3 failed).
TOL = {
    (torch.float32, "fma"): (1e-4, 1e-4),
    (torch.bfloat16, "fma"): (2e-3, 2.0**-7),
    (torch.bfloat16, "wgmma"): (2.0**-8, 2.0**-7),
}
TOL_REASON = {
    (torch.float32, "fma"): "f32 on both sides, summation order only",
    (torch.bfloat16, "fma"): "bf16 outputs of f32 sums: one bf16 ulp apart at most",
    (torch.bfloat16, "wgmma"): "bf16 outputs one ulp apart, plus P (B1), dS (B2), P and dS "
                               "(B3) rounded to bf16 (2**-8) before the last product where "
                               "plain keeps f32",
}


def emit(**kv) -> None:
    print(json.dumps(kv), flush=True)


def fail(phase: str, msg: str) -> None:
    emit(phase=phase, ok=False, error=msg)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, runs: int = 20, reps: int = 10) -> float:
    """Median over ``runs`` samples of the CUDA-event time of ``reps`` calls
    back to back, per call. Back to back, the host's share of a call (the
    wrapper's checks and allocations, the launch) overlaps the previous
    call's device work, as it does in training; one call alone would add
    it to a kernel of a fraction of a millisecond."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def within(name, got, want, tol) -> tuple[float, float]:
    """(max |err|, the ATOL share of max|want| that the output needs at this
    RTOL); fails the phase if that is more than the tolerance's ATOL."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail("kernels", f"{name}: non-finite kernel output")
    err = (got - want).abs()
    need = max(0.0, (err - rtol * want.abs()).max().item()) / max(want.abs().max().item(), 1e-30)
    if need > atol:
        fail("kernels", f"{name}: max |err| {err.max().item():.3e} over tolerance "
                        f"(needs atol_of_max {need:.3e} > {atol:.3e})")
    return err.max().item(), need


def attended_pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def bounds(dtype, b, h, hkv, s, hd, causal) -> dict:
    """Least time per kernel: max(tensor-core products / peak rate, bytes
    each read once and written once / HBM rate). The exps are not counted."""
    esize = torch.finfo(dtype).bits // 8
    prod = 2.0 * hd * attended_pairs(s, causal) * b * h  # one S x S x hd product
    q_bytes = b * h * s * hd * esize
    kv_bytes = b * hkv * s * hd * esize
    row_bytes = b * h * s * 4  # lse or delta
    work = {
        "flash_fwd": (2 * prod, q_bytes + 2 * kv_bytes + q_bytes + row_bytes),
        "flash_bwd_dq": (3 * prod, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + q_bytes),
        "flash_bwd_dkv": (4 * prod, 2 * q_bytes + 2 * kv_bytes + 2 * row_bytes + 2 * kv_bytes),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        out[name] = {
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops,
        }
    return out


def phase_kernels() -> dict:
    covered = {(dtype, hd) for _, dtype, *_, hd, _ in SHAPES}
    missing = {(dtype, hd) for _, dtype, hd in fa.ROUTES} - covered
    if missing:
        fail("kernels", f"route-table rows without a shape: {sorted(map(str, missing))}")
    results = {}
    for name, dtype, b, h, hkv, s, hd, causal in SHAPES:
        variant = {kname: fa.ROUTES[kname, dtype, hd] for kname in fa.KERNEL_NAMES}
        tol = {kname: TOL[dtype, v] for kname, v in variant.items()}
        gen = torch.Generator(device="cuda").manual_seed(0)

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

        q, do = rnd(b * h, s, hd), rnd(b * h, s, hd)
        k, v = rnd(b * hkv, s, hd), rnd(b * hkv, s, hd)
        o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
        o, lse = fa.flash_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        # the backward kernels take the plain forward's (O, lse) so that
        # each is held against its plain version on identical inputs
        delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
        dq_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
        dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
        dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
        torch.cuda.synchronize()
        f32_tol = TOL[torch.float32, "fma"]
        checks = {
            "flash_fwd": [within(f"{name} O", o, o_ref, tol["flash_fwd"]),
                          within(f"{name} lse", lse, lse_ref, f32_tol)],
            "flash_bwd_dq": [within(f"{name} dQ", dq, dq_ref, tol["flash_bwd_dq"])],
            "flash_bwd_dkv": [within(f"{name} dK", dk, dk_ref, tol["flash_bwd_dkv"]),
                              within(f"{name} dV", dv, dv_ref, tol["flash_bwd_dkv"])],
        }
        errs = {kname: max(e for e, _ in c) for kname, c in checks.items()}
        line = {"shape": name, "dtype": str(dtype).removeprefix("torch."),
                "B": b, "H": h, "Hkv": hkv, "S": s, "hd": hd, "causal": causal,
                "variant": variant, "max_abs_err": errs,
                "atol_of_max_needed": {kname: max(n for _, n in c) for kname, c in checks.items()},
                "tolerance": {kname: {"atol_of_max": tol[kname][0], "rtol": tol[kname][1],
                                      "reason": TOL_REASON[dtype, variant[kname]]}
                              for kname in errs}}
        if name == "train_bf16":
            timing = time_train_shape(q, k, v, do, lse_ref, delta, causal, b, h, hkv, s, hd)
            bnd = bounds(dtype, b, h, hkv, s, hd, causal)
            for kname in errs:
                t = timing[kname]
                rate = {"tflops": bnd[kname]["flops"] / (t["ms"] * 1e-3) / 1e12,
                        "bound_share": bnd[kname]["bound_ms"] / t["ms"]}
                results[kname] = {"variant": variant[kname], "max_abs_err": errs[kname],
                                  **t, **bnd[kname], **rate}
            line["timing"] = {k2: results[k2] for k2 in errs}
        emit(phase="kernels", ok=True, **line)
        del q, k, v, do, o, lse, o_ref, lse_ref, dq, dk, dv, dq_ref, dk_ref, dv_ref
        torch.cuda.empty_cache()
    return results


def time_train_shape(q, k, v, do, lse, delta, causal, b, h, hkv, s, hd) -> dict:
    ms = {
        "flash_fwd": (
            cuda_ms(lambda: fa.flash_fwd(q, k, v, causal)),
            cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, causal), runs=5, reps=1),
        ),
        "flash_bwd_dq": (
            cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)),
            cuda_ms(lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal), runs=5,
                    reps=1),
        ),
        "flash_bwd_dkv": (
            cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)),
            cuda_ms(lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal), runs=5,
                    reps=1),
        ),
    }
    # yardstick only: torch's fused attention on the same inputs in its
    # [B, H, S, hd] layout (forward for B1, one backward for B2 + B3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ql = q.view(b, h, s, hd).detach().requires_grad_(True)
    kl = k.view(b, hkv, s, hd).detach().requires_grad_(True)
    vl = v.view(b, hkv, s, hd).detach().requires_grad_(True)
    lib_fwd = cuda_ms(lambda: sdpa(ql, kl, vl, is_causal=causal, enable_gqa=True))
    out = sdpa(ql, kl, vl, is_causal=causal, enable_gqa=True)
    dol = do.view(b, h, s, hd)
    lib_bwd = cuda_ms(
        lambda: torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True)
    )
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd, "flash_bwd_dkv": lib_bwd}
    return {
        name: {"ms": t, "plain_ms": p, "library_ms": library[name]}
        for name, (t, p) in ms.items()
    }


def phase_train_small() -> None:
    """Two DiLoCo rounds at a small float32 size from one parameter tree,
    on the card (through the kernels) and on the CPU (through their plain
    versions): the per-step [W] losses and the final snapshot must agree.
    Both sides run float32 matmuls in full float32 (TF32 off) and differ
    only in summation order, which four AdamW steps amplify to ~1e-5
    relative; 1e-3 bounds it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model = LlamaConfig(vocab_size=384, hidden_size=256, intermediate_size=512,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, attention_impl="flash", remat=True,
                        loss_chunk=128)
    dcfg = DilocoConfig(num_workers=2, inner_steps=2, warmup_steps=1, total_steps=4,
                        lr=1e-3, grad_accum=2)
    # S = 200 is no multiple of the kernels' 64-row tiles: the ragged edge
    rows = pack_corpus(synthetic_corpus(seed=0), ByteTokenizer(), 200)
    batches = iter(DilocoBatcher(rows, num_workers=2, grad_accum=2, per_device_batch=1))
    rounds = []
    for _ in range(2):
        steps = [next(batches) for _ in range(dcfg.inner_steps)]
        rounds.append((np.stack([t for t, _ in steps]), np.stack([m for _, m in steps])))
    params = init_params(torch.Generator().manual_seed(0), model, device="cpu")
    out = {}
    fa.reset_launch_counts()
    for device in ("cuda", "cpu"):
        dl = Diloco(model, dcfg, device=device)
        state = dl.init_state(params=params)
        losses = [dl.round_step(state, t, m)[1].cpu() for t, m in rounds]
        out[device] = (torch.cat(losses), [p.cpu() for p in tree_leaves(state.snapshot)])
    got, want = out["cuda"][0], out["cpu"][0]
    err = ((got - want).abs() / want.abs()).max().item()
    snap_err = max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(out["cuda"][1], out["cpu"][1]))
    if not torch.isfinite(got).all() or max(err, snap_err) > 1e-3:
        fail("train_small", f"card vs CPU: losses {got.tolist()} vs {want.tolist()}, "
                            f"snapshot rel err {snap_err:.3e}")
    if min(fa.launch_counts().values()) == 0:
        fail("train_small", f"a kernel was not launched: {fa.launch_counts()}")
    emit(phase="train_small", ok=True, losses=got.tolist(), cpu_losses=want.tolist(),
         max_rel_err=err, snapshot_max_rel_err=snap_err, tolerance=1e-3)


def state_leaves(state) -> list[tuple[str, torch.Tensor]]:
    """Every tensor a checkpoint holds, by name ("params/layers/wq",
    "inner_opt_state/embed/exp_avg", ...)."""
    tree = state_tree(state)
    del tree["inner_step_count"]
    return named_leaves(tree)


def run_spread(a: dict, b: dict) -> tuple[str | None, float]:
    """(first state leaf or "losses" that differs between two train()
    summaries, or None; the largest difference over losses and leaves, as
    max |a - b| / max |b| per tensor)."""
    first, spread = None, 0.0
    pairs = [("losses", torch.tensor(a["losses"]), torch.tensor(b["losses"]))]
    pairs += [(n, x, y) for (n, x), (_, y) in zip(state_leaves(a["state"]),
                                                  state_leaves(b["state"]))]
    for name, x, y in pairs:
        if not torch.equal(x, y):
            first = first or name
            d = (x.double() - y.double()).abs().max() / y.double().abs().max().clamp_min(1e-30)
            spread = max(spread, float(d))
    return first, spread


# the resume phase's size: bf16 at hd 128, so the tensor-core kernels run
RESUME_MODEL = LlamaConfig(
    vocab_size=384, hidden_size=1024, intermediate_size=4096, num_hidden_layers=2,
    num_attention_heads=8, num_key_value_heads=4, dtype="bfloat16", remat=True,
    attention_impl="flash",
)
RESUME_RUN = dict(seed=0, batch_size=2, per_device_batch_size=1, seq_length=512,
                  warmup_steps=1, inner_steps=2, num_workers=2, model=RESUME_MODEL,
                  quiet=True)


def phase_resume() -> None:
    """Bit-exact resume, the preemption exit of the CLI, and the cost of a
    checkpoint, at a small bf16 hd-128 size. Warmup is 1 step of H = 2, so
    the first round's learning rates do not depend on total_steps and a
    1-round run is the first round of a 3-round one."""
    work = WORK / "resume"
    shutil.rmtree(work, ignore_errors=True)

    def run(**kw) -> dict:
        return train(TrainConfig(**{**RESUME_RUN, "log_dir": str(work / "runs"), **kw}),
                     device="cuda")

    a = run(total_steps=6, run_name="a")
    b = run(total_steps=6, run_name="b")
    first_diff, spread = run_spread(a, b)
    ck_dir = str(work / "ck")
    run(total_steps=2, checkpoint_dir=ck_dir, run_name="c")
    d = run(total_steps=6, checkpoint_dir=ck_dir, run_name="d")
    resumed_from = read_jsonl_records(str(work / "runs" / "d.jsonl"))[0][0].get("resume")
    if resumed_from != 2 or d["rounds"] != 2:
        fail("resume", f"the resumed run did not start from step 2: {resumed_from}")
    d["losses"] = a["losses"][:2] + d["losses"]  # compare whole trajectories
    resume_diff, resume_err = run_spread(d, a)
    if first_diff is None and resume_diff is not None:
        fail("resume", f"uninterrupted runs are bit-identical but the resumed one differs "
                       f"first at {resume_diff} (max rel {resume_err:.3e})")
    if first_diff is not None and resume_err > 2 * spread:
        fail("resume", f"resumed run off by {resume_err:.3e}, run-to-run spread {spread:.3e}")

    # cost of one checkpoint at this size (the page cache is warm for the
    # restore: it reads what the save just wrote)
    ck = CheckpointManager(str(work / "ck_time"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(6, a["state"])
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ck.restore(a["state"])
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(ck.path(6))
    preempt = phase_resume_sigterm(work)
    emit(phase="resume", ok=True, bit_identical_runs=first_diff is None,
         first_differing_leaf=first_diff, run_to_run_spread=spread,
         resumed_bit_exact=resume_diff is None, resumed_first_diff=resume_diff,
         resumed_max_rel_err=resume_err, losses=a["losses"],
         checkpoint_bytes=ckpt_bytes, save_s=save_s, restore_s=restore_s, **preempt)
    del a, b, d
    torch.cuda.empty_cache()


def phase_resume_sigterm(work: Path) -> dict:
    """``python -m nanodiloco_tpu_torch`` on a .tshrd shard, SIGTERM after
    the first round: exit 75 with a checkpoint at a round boundary; a
    rerun resumes there and finishes."""
    shard = work / "data.tshrd"
    with tokenshard.ShardWriter(str(shard), RESUME_RUN["seq_length"]) as w:
        pack_corpus_to_shard(synthetic_corpus(seed=0), ByteTokenizer(),
                             RESUME_RUN["seq_length"], w)
    with open(str(shard) + ".manifest.json", "w") as f:
        json.dump({"vocab_size": ByteTokenizer.vocab_size, "tokenizer": "byte-level"}, f)
    model_file = work / "model.json"
    model_file.write_text(json.dumps(RESUME_MODEL.to_dict()))
    total, jsonl, ck_dir = 100, work / "cli_runs" / "sig.jsonl", work / "ck_sig"
    cmd = [sys.executable, "-m", "nanodiloco_tpu_torch", "--llama-config-file", str(model_file),
           "--dataset-path", str(shard), "--seed", "0", "--batch-size", "2",
           "--per-device-batch-size", "1", "--seq-length", str(RESUME_RUN["seq_length"]),
           "--warmup-steps", "1", "--total-steps", str(total), "--inner-steps", "2",
           "--num-workers", "2", "--eval-every", "1", "--eval-batches", "2",
           "--checkpoint-dir", str(ck_dir), "--checkpoint-every", "1000",
           "--log-dir", str(jsonl.parent), "--run-name", "sig", "--quiet"]

    def records() -> list[dict]:
        return read_jsonl_records(str(jsonl))[0] if jsonl.exists() else []

    def launch(log: str) -> subprocess.Popen:
        out = open(work / log, "w")
        return subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)

    proc = launch("sig_first.log")
    try:
        t0 = time.perf_counter()
        while not any(r.get("outer_synced") for r in records()):
            if proc.poll() is not None or time.perf_counter() - t0 > 300:
                fail("resume", f"the CLI run ended (rc {proc.returncode}) or stalled before "
                               f"its first round: {(work / 'sig_first.log').read_text()[-2000:]}")
            time.sleep(0.05)
        t_signal = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
        exit_s = time.perf_counter() - t_signal
    finally:
        if proc.poll() is None:
            proc.kill()
    preempts = [r for r in records() if "preempt" in r]
    latest = CheckpointManager(str(ck_dir)).latest_step
    if rc != 75 or len(preempts) != 1 or preempts[0]["checkpoint_step"] != latest:
        fail("resume", f"SIGTERM: exit {rc}, preempt records {preempts}, checkpoint {latest}")
    if not latest or latest % 2 or latest >= total:
        fail("resume", f"SIGTERM checkpoint at step {latest}, not a round boundary < {total}")
    proc = launch("sig_rerun.log")
    try:
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    recs = records()
    resumes = [r["resume"] for r in recs if "resume" in r]
    last = max(r["step"] for r in recs if "loss" in r)
    if rc != 0 or resumes != [latest] or last != total:
        fail("resume", f"rerun: exit {rc}, resumed from {resumes}, last step {last}: "
                       f"{(work / 'sig_rerun.log').read_text()[-2000:]}")
    return {"sigterm_exit_code": 75, "sigterm_checkpoint_step": latest,
            "sigterm_exit_s": exit_s, "rerun_exit_code": rc, "rerun_last_step": last}


def phase_train(smi: str) -> tuple[dict, dict]:
    """Two DiLoCo rounds at Llama-3-8B width, depth cut to one layer, with
    an eval of the snapshot after each round and the metrics JSONL."""
    model = dataclasses.replace(LLAMA3_8B, num_hidden_layers=1)
    log_dir = WORK / "train_runs"
    shutil.rmtree(log_dir, ignore_errors=True)
    cfg = TrainConfig(
        seed=0, batch_size=2, per_device_batch_size=1, seq_length=2048,
        warmup_steps=1, total_steps=4, inner_steps=2, num_workers=2,
        model=model, fit_vocab=False, quiet=True,
        eval_every=1, eval_batches=2, log_dir=str(log_dir), run_name="train8b",
    )
    fa.reset_launch_counts()
    summary = train(cfg, device="cuda")
    launches = fa.launch_counts()
    variants = fa.variant_counts()
    losses = summary["losses"]
    if not all(math.isfinite(x) for step in losses for x in step):
        fail("train", f"non-finite loss: {losses}")
    if len(losses) != 4 or any(len(step) != 2 for step in losses):
        fail("train", f"expected [4 steps][2 workers] losses, got {losses}")
    if not all(summary["snapshot_changed"]):
        fail("train", f"snapshot unchanged by an outer step: {summary['snapshot_changed']}")
    if min(launches.values()) == 0:
        fail("train", f"a kernel was not launched on the main path: {launches}")
    # the bf16 hd-128 round: every kernel only through the tensor cores
    if any(v["fma"] or not v["wgmma"] for v in variants.values()):
        fail("train", f"the main path did not run the routed variants: {variants}")
    # the evals: forward only, B1 on the tensor cores
    ev = summary["eval_kernel_launches"]
    if (not ev["flash_fwd"]["wgmma"] or ev["flash_fwd"]["fma"]
            or any(sum(ev[k].values()) for k in ("flash_bwd_dq", "flash_bwd_dkv"))):
        fail("train", f"the evals did not run B1 (wgmma) alone: {ev}")
    if not math.isfinite(summary.get("eval_loss", math.nan)):
        fail("train", f"no finite final eval_loss: {summary.get('eval_loss')}")
    jsonl = str(log_dir / "train8b.jsonl")
    recs = [r for r in read_jsonl_records(jsonl)[0] if "loss" in r]
    with_eval = [r["step"] for r in recs if "eval_loss" in r]
    if [r["step"] for r in recs] != [1, 2, 3, 4] or with_eval != [2, 4]:
        fail("train", f"JSONL steps {[r['step'] for r in recs]}, eval keys on {with_eval}")
    report = summarize_run(jsonl)
    if "final_loss" not in report or "final_eval_loss" not in report:
        fail("train", f"report lacks final_loss / final_eval_loss: {report}")
    compare_out = io.StringIO()
    try:
        with contextlib.redirect_stdout(compare_out):
            cli.main(["report", "compare", jsonl, jsonl])
    except SystemExit as e:
        fail("train", f"report compare of the run against itself exited {e.code}: "
                      f"{compare_out.getvalue()}")
    round_ends = [r for r in recs if r["outer_synced"]]
    emit(phase="train", ok=True, nvidia_smi=smi, num_params=summary["num_params"],
         losses=losses, snapshot_changed=summary["snapshot_changed"],
         tokens=summary["tokens"], seconds=summary["seconds"],
         round_seconds=summary["round_seconds"],
         tokens_per_sec=summary["tokens_per_sec"],
         tokens_per_sec_after_first_round=summary["tokens_per_sec_after_first_round"],
         peak_memory_bytes=summary["peak_memory_bytes"], launches=launches,
         variant_launches=variants, eval_launches=ev,
         eval_loss=[r["eval_loss"] for r in round_ends],
         eval_ms_per_call=[r["t_eval"] * 1e3 for r in round_ends],
         t_data_s=[r["t_data"] for r in round_ends],
         t_sync_s=[r["t_sync"] for r in round_ends],
         avg_sync_time_s=summary["avg_sync_time_s"], comm_share=summary["comm_share"],
         report=report, report_compare="exit 0")
    return launches, summary


def phase_checkpoint_full(summary: dict, smi: str) -> None:
    """Save the 8B-width state, zero it, restore it leaf by leaf from the
    memory-mapped file, and check every leaf's float64 sum."""
    state = summary["state"]
    leaves = state_leaves(state)
    nbytes = sum(t.numel() * t.element_size() for _, t in leaves)
    ck_dir = WORK / "ckpt_full"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck_dir.mkdir(parents=True)
    free = shutil.disk_usage(ck_dir).free
    if free < 1.5 * nbytes:
        emit(phase="checkpoint_full", ok=True, skipped=True, state_bytes=nbytes,
             free_bytes=free, reason="the local disk has less than 1.5x the state's bytes free")
        return
    sums = {n: float(t.sum(dtype=torch.float64)) for n, t in leaves}
    ck = CheckpointManager(str(ck_dir))
    step = state.inner_step_count
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(step, state)
    save_s = time.perf_counter() - t0
    file_bytes = os.path.getsize(ck.path(step))
    with torch.no_grad():
        for _, t in leaves:
            t.zero_()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    in_use = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ck.restore(state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    after = {n: float(t.sum(dtype=torch.float64)) for n, t in state_leaves(state)}
    bad = [n for n in sums if after.get(n) != sums[n]]
    shutil.rmtree(ck_dir)
    if bad:
        fail("checkpoint_full", f"{len(bad)} leaves differ after restore, first {bad[0]}")
    if peak >= 80e9:
        fail("checkpoint_full", f"restore peak {peak} bytes is not under 80 GB")
    emit(phase="checkpoint_full", ok=True, skipped=False, nvidia_smi=smi, state_bytes=nbytes,
         file_bytes=file_bytes, free_bytes=free, leaves=len(sums), save_s=save_s,
         restore_s=restore_s, save_gb_per_s=file_bytes / save_s / 1e9,
         restore_gb_per_s=file_bytes / restore_s / 1e9, bytes_in_use_before_restore=in_use,
         restore_peak_bytes=peak)


# -- serving -------------------------------------------------------------------

SERVE_SMALL = LlamaConfig(vocab_size=384, hidden_size=128, intermediate_size=256,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=256, initializer_range=0.2)
# card against CPU at float32, TF32 off: summation order alone, ~1e-6
# relative; 1e-4 of max|logit| bounds it. The weights are drawn at std 0.2,
# so the logits' top-2 gaps (~1e-1) dwarf that and a token cannot flip.
SERVE_SMALL_TOL = 1e-4
# bf16 unit roundoff: the near-tie rule of the 8B serve phase
BF16_U = 2.0 ** -8
NEAR_TIE = ("the top-2 gap l_a - l_b = sum_i h_i (W_ia - W_ib) of the training forward's "
            "final hidden state h and head W; if every h_i moves by one bf16 rounding "
            "(relative 2**-8) the gap moves by at most 2**-8 * sum_i |h_i (W_ia - W_ib)|, "
            "and rounding each logit to bf16 adds one ulp of each: two computations of the "
            "same bf16 network in other summation orders (B slots against one row, a chunk "
            "against a whole prompt, a flash forward) part no further than that")


def serve_small_requests(prompt: torch.Tensor) -> list[GenRequest]:
    return [
        GenRequest(prompt=tuple(prompt[0].tolist()), max_new_tokens=12, seed=0),
        GenRequest(prompt=tuple(prompt[1, :9].tolist()), max_new_tokens=10, temperature=0.9,
                   top_k=50, seed=5),
        GenRequest(prompt=tuple(prompt[0, :3].tolist()) + tuple(prompt[1].tolist()),
                   max_new_tokens=8, temperature=0.7, top_p=0.9, seed=9),
    ]


def drive(sched: Scheduler, reqs: list[GenRequest], per_tick: int = 1, ticks: int = 100_000):
    """Submit ``per_tick`` requests before each tick until all are in, then
    tick until every ticket is done."""
    tickets, pending = [], list(reqs)
    for _ in range(ticks):
        for _ in range(per_tick):
            if pending:
                tickets.append(sched.submit(pending.pop(0)))
        if sched.tick() == 0 and not pending and all(t.done() for t in tickets):
            return tickets
    raise RuntimeError("the scheduler did not finish its requests")


def solo(params, cfg, req: GenRequest, device) -> list[int]:
    return generate(params, [list(req.prompt)], cfg, req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                    seed=req.seed, device=device)[0].tolist()


def phase_serve_small(smi: str) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SERVE_SMALL
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(1))
    toks = {d: generate(params, prompt, cfg, 16, device=d).cpu() for d in ("cuda", "cpu")}
    if not torch.equal(toks["cuda"], toks["cpu"]):
        fail("serve_small", f"greedy generate(): card {toks['cuda'].tolist()} "
                            f"vs CPU {toks['cpu'].tolist()}")
    logits = {}
    for d in ("cuda", "cpu"):
        sp = serving_params(params, cfg, d)
        cache = init_kv_cache(cfg, 2, 32, d)
        logits[d] = _cached_block(sp, cfg, prompt.to(d), cache, 0,
                                  torch.ones((2, 32), dtype=torch.int32, device=d))[0].cpu()
    logit_err = ((logits["cuda"] - logits["cpu"]).abs().max()
                 / logits["cpu"].abs().max()).item()
    if logit_err > SERVE_SMALL_TOL:
        fail("serve_small", f"prefill logits: card vs CPU {logit_err:.3e} of max|logit|")
    u = {d: noise_uniforms([3, 2**40 + 1], [0, 0], [0, 63], cfg.vocab_size, d).cpu()
         for d in ("cuda", "cpu")}
    if not torch.equal(u["cuda"], u["cpu"]):
        fail("serve_small", "the sampling noise's uniforms differ between card and CPU")
    engine_ok = {}
    for d in ("cuda", "cpu"):
        eng = InferenceEngine(params, cfg, num_slots=2, max_len=64, chunk_size=8,
                              prefix_cache_tokens=64, device=d)
        reqs = serve_small_requests(prompt)
        tickets = drive(Scheduler(eng), reqs)
        got = [t.result["tokens"] for t in tickets]
        want = [solo(params, cfg, r, d) for r in reqs]
        if got != want:
            fail("serve_small", f"engine on {d}: {got} vs solo generate() {want}")
        engine_ok[d] = got
    cli_result = serve_small_cli()
    emit(phase="serve_small", ok=True, nvidia_smi=smi, greedy_tokens=toks["cuda"].tolist(),
         logits_max_err_of_max=logit_err, tolerance=SERVE_SMALL_TOL,
         tolerance_reason="f32 on both sides, TF32 off: summation order only",
         engine_streams=engine_ok["cuda"], engine_streams_cpu_equal=(
             engine_ok["cuda"] == engine_ok["cpu"]), **cli_result)


def serve_small_cli() -> dict:
    """train() writes a checkpoint (with its model_config.json sidecar) on
    the card; the generate and serve subcommands read it."""
    work = WORK / "serve_small"
    shutil.rmtree(work, ignore_errors=True)
    model = dataclasses.replace(SERVE_SMALL, max_position_embeddings=128)
    ck_dir = work / "ck"
    train(TrainConfig(seed=0, batch_size=2, per_device_batch_size=2, seq_length=64,
                      warmup_steps=1, total_steps=2, inner_steps=2, num_workers=1, model=model,
                      checkpoint_dir=str(ck_dir), log_dir=str(work / "runs"), run_name="s",
                      quiet=True), device="cuda")
    model_cfg, sidecar, snap = cli._load_checkpoint_snapshot(str(ck_dir), None)
    tok = ByteTokenizer()
    want = generate(snap, [tok.encode("Hello")], model_cfg, 8, device="cuda")[0].tolist()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["generate", "--checkpoint-dir", str(ck_dir), "--prompt", "Hello",
                  "--max-new-tokens", "8", "--temperature", "0", "--no-stop-at-eos"])
    if out.getvalue().strip() != "Hello" + tok.decode(want):
        fail("serve_small", f"CLI generate printed {out.getvalue()!r}, want {want}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "nanodiloco_tpu_torch", "serve", "--checkpoint-dir", str(ck_dir),
         "--host", "127.0.0.1", "--slots", "2", "--max-len", "128", "--chunk-size", "16"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("serving"):
            fail("serve_small", f"CLI serve did not start: {line}{proc.stdout.read()[-2000:]}")
        port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
        base = f"http://127.0.0.1:{port}"
        code, body = http_post_json(base + "/v1/generate",
                                    {"prompt": "Hello", "max_new_tokens": 8, "stop": False},
                                    timeout=120)
        if code != 200 or body.get("token_ids") != want:
            fail("serve_small", f"POST /v1/generate: {code} {body}, want {want}")
        health = http_get(base + "/healthz")[0]
        code_m, metrics = http_get(base + "/metrics")
        if health != 200 or code_m != 200 or 'outcome="served"} 1' not in metrics:
            fail("serve_small", f"/healthz {health}, /metrics {code_m}")
    finally:
        proc.terminate()
        rc = proc.wait(timeout=60)
    if rc != 0:
        fail("serve_small", f"CLI serve exited {rc} on SIGTERM")
    shutil.rmtree(work, ignore_errors=True)
    return {"cli_generate": out.getvalue().strip(), "cli_serve_tokens": want,
            "cli_serve_exit_code": rc, "checkpoint_tokenizer": sidecar.get("tokenizer")}


# the 8B serve workload: prompt lengths over 64-600, 64 new tokens each
SERVE_PROMPTS = (64, 600, 200, 448, 96, 333, 512, 150)
SERVE_NEW = 64


def serve_weights(cfg: LlamaConfig):
    """Llama-3-8B weights from seed 0, made on the card in float32 and cast
    once to the serving copy; the float32 tree is dropped."""
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    sp = serving_params(params, cfg)
    del params
    torch.cuda.empty_cache()
    return sp


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def tie_tolerance(h: torch.Tensor, head: torch.Tensor, logits: torch.Tensor, a, b):
    """NEAR_TIE for tokens a, b at each row: 2**-8 * sum_i |h_i (W_ia - W_ib)| plus
    one bf16 ulp of each logit. h [n, d] bf16, head [d, V], logits [n, V] f32."""
    diff = (head[:, a].float() - head[:, b].float()).T  # [n, d]
    spread = (h.float() * diff).abs().sum(-1) * BF16_U
    la, lb = logits.gather(-1, a[:, None])[:, 0], logits.gather(-1, b[:, None])[:, 0]

    def ulp(x):
        return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)

    return spread + ulp(la) + ulp(lb)


def teacher_forcing(sp, cfg, req: GenRequest, stream: list[int]) -> dict:
    """The training forward (through B1) over prompt + stream: for each
    emitted token, its logit gap to the forward's argmax against
    NEAR_TIE."""
    fcfg = dataclasses.replace(cfg, remat=False)
    toks = torch.tensor([list(req.prompt) + stream[:-1]], device="cuda")
    with torch.no_grad():
        h = forward(sp, toks, fcfg, return_hidden=True)[0, len(req.prompt) - 1:]
        logits = torch.matmul(h, sp["lm_head"]).float()
    emitted = torch.tensor(stream, device="cuda")
    best = logits.argmax(-1)
    tol = tie_tolerance(h, sp["lm_head"], logits, best, emitted)
    gap = logits.gather(-1, best[:, None])[:, 0] - logits.gather(-1, emitted[:, None])[:, 0]
    return {"exact": int((best == emitted).sum()), "n": len(stream),
            "max_gap": float(gap.max()), "gap_over_tol": float((gap / tol).max()),
            "ok": bool((gap <= tol).all()), "h": h, "logits": logits}


def phase_serve(smi: str) -> dict:
    cfg = LLAMA3_8B  # 32 layers, bf16 compute over float32 masters, flash attention
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sp = serve_weights(cfg)
    weight_s = time.perf_counter() - t0
    weight_bytes = tree_bytes(sp)
    matmul_bytes = sum(tree_bytes(sp["layers"][k]) for k in MATMUL_KEYS) + tree_bytes(
        sp["lm_head"])
    fa.reset_launch_counts()
    eng = InferenceEngine(sp, cfg, num_slots=4, max_len=1024, chunk_size=512, device="cuda")
    gen = torch.Generator().manual_seed(2)
    reqs = [GenRequest(prompt=tuple(torch.randint(0, cfg.vocab_size, (n,),
                                                  generator=gen).tolist()),
                       max_new_tokens=SERVE_NEW, seed=10 + i,
                       temperature=0.0 if i % 2 == 0 else 0.8,
                       top_k=0 if i % 4 != 1 else 50, top_p=1.0 if i % 4 != 3 else 0.9)
            for i, n in enumerate(SERVE_PROMPTS)]
    sched = Scheduler(eng)
    t0 = time.perf_counter()
    tickets = drive(sched, reqs, per_tick=2)
    workload_s = time.perf_counter() - t0
    stats = sched.stats()
    streams = [t.result["tokens"] for t in tickets]
    if any(len(s) != SERVE_NEW for s in streams):
        fail("serve", f"stream lengths {[len(s) for s in streams]}, want {SERVE_NEW}")
    # greedy streams against solo generate() and the training forward
    checks = []
    for req, stream in zip(reqs, streams):
        if req.temperature:
            continue
        ref = solo(sp, cfg, req, "cuda")
        tf = teacher_forcing(sp, cfg, req, stream)
        first = next((j for j, (a, b) in enumerate(zip(stream, ref)) if a != b), None)
        entry = {"prompt_len": len(req.prompt), "first_divergence": first,
                 "teacher_forcing_exact": tf["exact"], "teacher_forcing_n": tf["n"],
                 "teacher_forcing_max_gap": tf["max_gap"],
                 "teacher_forcing_gap_over_tol": tf["gap_over_tol"]}
        if first is not None:
            # the forward's logits at that position: the gap between the two
            # tokens the streams chose must be a near-tie
            a = torch.tensor([ref[first]], device="cuda")
            b = torch.tensor([stream[first]], device="cuda")
            row = tf["logits"][first:first + 1]
            gap = (row[0, a] - row[0, b]).abs().item()
            tol = tie_tolerance(tf["h"][first:first + 1], sp["lm_head"], row, a, b).item()
            entry.update(divergence_gap=gap, divergence_tol=tol)
            if gap > tol:
                fail("serve", f"greedy stream {entry} parts from solo generate() at {first} "
                              f"off a near-tie: gap {gap:.4g} > {tol:.4g}")
        if not tf["ok"]:
            fail("serve", f"a greedy token is not the training forward's argmax within the "
                          f"near-tie tolerance: {entry}")
        checks.append(entry)
    launches = fa.launch_counts()
    if launches["flash_fwd"] != cfg.num_hidden_layers * len(checks):
        fail("serve", f"B1 launches {launches}, want {cfg.num_hidden_layers} per forward")
    timing = serve_timing(eng, cfg, matmul_bytes)
    peak = torch.cuda.max_memory_allocated()
    tf_exact = sum(c["teacher_forcing_exact"] for c in checks)
    tf_n = sum(c["teacher_forcing_n"] for c in checks)
    emit(phase="serve", ok=True, nvidia_smi=smi, layers=cfg.num_hidden_layers,
         weight_bytes=weight_bytes, matmul_weight_bytes=matmul_bytes,
         cache_bytes=eng.kv_bytes(), peak_memory_bytes=peak, weights_seconds=weight_s,
         requests=len(reqs), prompt_lens=list(SERVE_PROMPTS), new_tokens=SERVE_NEW,
         workload_seconds=workload_s, ttft_p50_s=stats["ttft_p50_s"],
         ttft_p95_s=stats["ttft_p95_s"], decode_tokens_per_sec=stats["decode_tokens_per_sec"],
         prefill_chunks=stats["prefill_chunks_total"], greedy_checks=checks,
         teacher_forcing_exact_share=tf_exact / tf_n, near_tie_rule=NEAR_TIE,
         b1_launches=launches["flash_fwd"], devtime=eng.devtime_stats(), **timing)
    del eng, sp
    torch.cuda.empty_cache()
    return launches


def serve_timing(eng: InferenceEngine, cfg: LlamaConfig, matmul_bytes: int) -> dict:
    """Prefill ms per chunk bucket against its FLOP bound, decode ms per
    tick at 1 and 4 live slots against its byte bound, and the device's
    idle share in a 4-slot tick (torch.profiler's kernel time against the
    unprofiled tick)."""
    nh, nkv, hd, nl = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim, cfg.num_hidden_layers
    layer_params = (matmul_bytes - tree_bytes(eng.params["lm_head"])) // 2
    prefill = {}
    for c in (64, 128, 256, 512):
        toks = torch.randint(0, cfg.vocab_size, (1, c), device="cuda")
        fn = functools.partial(eng._chunk, eng.params, eng.cache, toks, 0, 0, c - 1, None,
                               0.0, 0, 1.0)
        ms = cuda_ms(fn, warmup=2, runs=5, reps=2)
        flops = (2.0 * c * layer_params + 4.0 * hd * nh * nl * c * (c + 1) / 2
                 + 2.0 * cfg.hidden_size * cfg.vocab_size)
        bound = max(flops / PEAK_FLOPS[torch.bfloat16], matmul_bytes / PEAK_BYTES) * 1e3
        prefill[c] = {"ms": ms, "tflops": flops / (ms * 1e-3) / 1e12, "bound_ms": bound,
                      "bound_by": "operations" if flops / PEAK_FLOPS[torch.bfloat16]
                      >= matmul_bytes / PEAK_BYTES else "bytes", "bound_share": bound / ms}
    decode = {}
    pos = 512
    for live in (1, 4):
        for s in range(eng.num_slots):
            eng.release(s)
        for s in range(live):
            eng._active[s], eng._pos[s], eng._key_valid[s] = 1, pos, 1
        eng._dev_key_valid = None
        for _ in range(3):
            eng.step()
            eng._pos[:live] = pos
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            eng.step()  # ends in the host read of the tokens
            times.append((time.perf_counter() - t0) * 1e3)
            eng._pos[:live] = pos
        ms = statistics.median(times)
        kv_read = live * (pos + 1) * nl * 2 * nkv * hd * 2
        bound = (matmul_bytes + kv_read) / PEAK_BYTES * 1e3
        decode[live] = {"ms": ms, "bound_ms": bound, "bound_by": "bytes",
                        "bound_share": bound / ms, "kv_read_bytes": kv_read}
    idle = decode_idle_share(eng, decode[4]["ms"])
    for s in range(eng.num_slots):
        eng.release(s)
    return {"prefill_by_bucket": prefill, "decode_by_live_slots": decode, **idle}


def device_busy_us(prof) -> tuple[float, int]:
    """(microseconds the card was busy, device activities) in a profile:
    the union of the CUDA-side events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, len(spans)


def decode_idle_share(eng: InferenceEngine, tick_ms: float) -> dict:
    from torch.profiler import ProfilerActivity, profile

    n = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
            eng._pos[:4] = 512
    busy_us, kernels = device_busy_us(prof)
    busy_ms = busy_us / 1e3 / n
    if busy_ms <= 0:
        return {"decode_idle_share": None,
                "decode_idle_share_note": "not measured: the profiler showed no device time"}
    return {"decode_device_busy_ms_per_tick": busy_ms, "decode_kernels_per_tick": kernels / n,
            "decode_idle_share": max(0.0, 1.0 - busy_ms / tick_ms)}


def main() -> None:
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = nvidia_smi()
    emit(phase="device", ok=True, nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:  # g++ beside the nvcc builds
        native = pool.submit(tokenshard.native_available)
        report = build.build_all()
        if not native.result():
            fail("build", f"g++ could not build {tokenshard.lib_path()}")
    for r in report.values():
        print(r["log"], file=sys.stderr)  # ptxas: registers, shared memory, spills
    emit(phase="build", ok=True, seconds=time.perf_counter() - t0,
         built={n: r["seconds"] for n, r in report.items()}, dir=str(build.build_dir()),
         tokenshard=str(tokenshard.lib_path()))

    kernels = phase_kernels()
    phase_train_small()
    phase_resume()
    launches, summary = phase_train(smi)
    phase_checkpoint_full(summary, smi)
    del summary
    torch.cuda.empty_cache()
    phase_serve_small(smi)
    serve_launches = phase_serve(smi)
    shutil.rmtree(WORK, ignore_errors=True)

    emit(kernels=[
        {"name": name, "route": "cuda", "source": SOURCE[kernels[name]["variant"]],
         "replaces": REPLACES[name], "launches": launches[name],
         "launches_serve": serve_launches[name], **kernels[name]}
        for name in REPLACES
    ])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
