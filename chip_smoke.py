#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nanodiloco_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; the first failure exits non-zero:

1. device      - a CUDA card must be present; its name and power limit.
2. build       - nvcc builds every kernel from nanodiloco_tpu_torch/csrc.
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
5. train       - the port's train(): two DiLoCo rounds at Llama-3-8B
                 width (1 layer, W=2 workers, H=2, grad_accum 2, S=2048)
                 with attention_impl="flash"; every kernel's launch count
                 must rise during this phase (counts are reset just
                 before it), and every B1, B2 and B3 launch of this bf16
                 round must have gone to the tensor-core (wgmma) variant.

Then the kernels line ({"kernels": [...]}), the nvidia-smi line, and last
{"ok": true, "device": {...}}. Needs one card; builds into build/.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import nanodiloco_tpu_torch.ops.cuda.flash_attention as fa
from nanodiloco_tpu_torch.data.pipeline import DilocoBatcher, pack_corpus, synthetic_corpus
from nanodiloco_tpu_torch.data.tokenizer import ByteTokenizer
from nanodiloco_tpu_torch.models.config import LLAMA3_8B, LlamaConfig
from nanodiloco_tpu_torch.models.llama import init_params, tree_leaves
from nanodiloco_tpu_torch.ops.cuda import build
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

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


def phase_train(smi: str) -> dict:
    """Two DiLoCo rounds at Llama-3-8B width, depth cut to one layer."""
    model = dataclasses.replace(LLAMA3_8B, num_hidden_layers=1)
    cfg = TrainConfig(
        seed=0, batch_size=2, per_device_batch_size=1, seq_length=2048,
        warmup_steps=1, total_steps=4, inner_steps=2, num_workers=2,
        model=model, fit_vocab=False, quiet=True,
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
    emit(phase="train", ok=True, nvidia_smi=smi, num_params=summary["num_params"],
         losses=losses, snapshot_changed=summary["snapshot_changed"],
         tokens=summary["tokens"], seconds=summary["seconds"],
         round_seconds=summary["round_seconds"],
         tokens_per_sec=summary["tokens_per_sec"],
         tokens_per_sec_after_first_round=summary["tokens_per_sec_after_first_round"],
         peak_memory_bytes=summary["peak_memory_bytes"], launches=launches,
         variant_launches=variants)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = nvidia_smi()
    emit(phase="device", ok=True, nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    report = build.build_all()
    for r in report.values():
        print(r["log"], file=sys.stderr)  # ptxas: registers, shared memory, spills
    emit(phase="build", ok=True, seconds=time.perf_counter() - t0,
         built={n: r["seconds"] for n, r in report.items()}, dir=str(build.build_dir()))

    kernels = phase_kernels()
    phase_train_small()
    launches = phase_train(smi)

    emit(kernels=[
        {"name": name, "route": "cuda", "source": SOURCE[kernels[name]["variant"]],
         "replaces": REPLACES[name], "launches": launches[name], **kernels[name]}
        for name in REPLACES
    ])
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
