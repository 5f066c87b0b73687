#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (nanodiloco_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; the first failure exits non-zero:

1. device      - a CUDA card must be present; its name and power limit.
2. build       - nvcc builds every kernel from nanodiloco_tpu_torch/csrc,
                 and g++ the tokenshard reader from csrc/tokenshard.cpp.
3. kernels     - each kernel against its plain PyTorch version on the
                 card at the tolerance of its route, at shapes that cover
                 every (dtype, head dim) row of the route table (hd 16, 32,
                 64, 80, 96, 128; ragged S, non-causal, S under one tile,
                 MHA and GQA): bf16 B1 and B3 at hd 128, 64 and 32 and B2
                 at hd 128 run the tensor cores, the rest the FMA kernels.
                 At one shape of every route that no phase is built to
                 run (hd 16, 80, 96 in bf16; hd 32, 80, 96, 128 in f32),
                 CUDA-event times of the kernel, the plain version and the
                 PyTorch library call, the least time the card could take
                 (bound_ms), TFLOP/s and the share of the bound. From here
                 on every launch is counted by shape (fa.shape_counts),
                 and the child processes that train report theirs.
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
                 pass, and the JSONL must hold the goodput snapshots, the
                 devtime ledgers and the cost_analysis record (printed with
                 the analytic MFU). Then the 8B-width state is saved, zeroed, restored
                 leaf by leaf and checked leaf by leaf against its float64
                 sums, with the restore's peak device memory (left out,
                 with a line that says so, if the disk lacks 1.5x the
                 state's bytes).

7. diloco_options_small - every DiLoCo option (quarantine, the bf16,
                 int8 and int4-integer wires, dynamics, heterogeneous H
                 (1, 2), async at delay 1, streaming at P=2 / delay 1 /
                 alpha 0.5, the snapshot offload, remat "dots") at
                 train_small's size, on the card and on the CPU from one
                 parameter tree: losses and snapshot within 1e-3 (one
                 quantization bin granted under a quantized wire, whose
                 inputs differ at float32 roundoff). One sync's deltas,
                 copied from the card to the CPU, must quantize to the
                 same integers and scales on both (the bf16 cast, int8
                 and int4 per worker, the integer wire's shared-scale
                 payload with and without a mask, and its merged leaf:
                 torch.equal). On the card also: a NaN written into worker 1's replica
                 mid-round is quarantined (worker 1 finite after the sync,
                 the snapshot the survivor's step); dynamics on/off, async
                 at delay 0 and streaming at P=1 / delay 0 / alpha 1 equal
                 classic bit for bit; remat "dots" gives no-remat's
                 gradients, and in the backward runs fewer GEMM kernels
                 than "nothing" (torch.profiler) with B1 recomputed once
                 a layer under both (the launch counter). Every kernel
                 must launch in the card runs.
8. diloco_options_8b - train() at the train phase's 8B width, 3 rounds
                 each: (a) classic with the dynamics readout, (b)
                 quarantine + int8 integer wire + snapshot offload, (c)
                 async delay 1 + budgets (2, 1) + int4 wire, (d) streaming
                 P=1 / delay 1 / alpha 0.5, (e) remat "dots". Prints each
                 run's tokens/s, t_sync per round beside the outer step's
                 byte bound, peak memory, the kernels' launches (each must
                 rise in every run) and the last sync record's keys.
9. serve_small - serving at a small float32 size (2 layers, hidden 128,
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
10. serve      - Llama-3-8B at full width and full depth (32 layers, bf16,
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
                 p95, decode tokens/s, the device's idle share in a decode
                 tick (torch.profiler), and what zeroing one slot's rows at
                 release costs against its byte bound. B1 launches only in
                 the teacher-forcing forwards (B 1, S of prompt + stream):
                 generation and the engine run no kernel of their own.
11. serve_modes_small - the engine's modes at serve_small's size in
                 float32, on the card and on the CPU: dense, paged (block 4),
                 paged + int8 and paged + speculation (spec_k 4) serve
                 serve_small's requests and two on a repeated prompt; each
                 mode's streams are the same on both devices and equal solo
                 generate() (int8: its greedy streams, and its first-token
                 logits within 5% of the fp logits' span); a swap_weights in
                 mid-stream leaves the live stream on the old weights and
                 runs the next admission on the new ones, and frees the old
                 serving copy (memory_allocated) when its last slot retires;
                 export -> wire doc -> import round trips dense -> paged
                 and paged -> int8 finish as solo generate().
12. serve_paged - Llama-3-8B at full depth (32 layers, bf16, serve's
                 weights): a paged arena of 16 slots x max_len 4096, block
                 16, chunk 512, serves 16 requests (prompts of 512-3000
                 tokens, 64 new, greedy and sampled) with bf16 KV and with
                 int8 KV. Prints the arena's bytes and bytes per token, peak
                 memory, TTFT p50/p95, decode tokens/s, the decode tick at 16
                 live slots against its byte bound with the device's idle
                 share and the gather/scatter kernels' share, the zeroing of
                 a 1024-token request's blocks, and int8's agreement with
                 bf16. Checks: paged bf16 against the dense
                 engine (16 x 1024, greedy) and spec_k=4 on repeated prompts
                 against the same engine without speculation; streams may
                 part only at a near-tie (NEAR_TIE).
13. hf_8b      - serve's weights, cast to one bf16 tree (32 layers), written as
                 an HF checkpoint in Meta's layout (4 safetensors shards of at
                 most 5 GB, the index, config.json from the LLAMA3_8B preset)
                 and imported back with from_hf_pretrained: the import's
                 seconds, GB/s, device bytes and the host RSS it adds (which
                 must stay under the one-leaf bound); every leaf must equal the
                 written one (torch.equal, contiguous) and the engine's greedy
                 streams (4 requests, 32 new tokens) on the import must equal
                 those on the originals.
14. faults_8b  - `python -m nanodiloco_tpu_torch --init-hf` from a 1-layer
                 8B-width bf16 HF fixture at the train phase's configuration,
                 5 rounds, quarantine, --straggler-factor 1.5, --metrics-port 0,
                 a status file and a fault plan (nan_params, io_error x2 on the
                 save, a 34 s stall, a 2 s straggle). Checks: its first step's
                 loss equals an in-process train() on the same weights bit for
                 bit; the NaN round's sync quarantines 1 worker and every loss
                 is finite; the one final save succeeds after 2 retries; one
                 stall alarm past the watchdog's 30 s floor after the stalled
                 round (and none but the final save's after it); a straggler
                 demote then a restore; the final
                 goodput snapshot's causes sum to its elapsed time within 1%
                 with ~2 s of straggler_wait and the stall's wait; a /metrics
                 scrape during the final save agrees with the JSONL; every
                 kernel launched. Then `export-hf --max-shard-gb 2` of the
                 checkpoint (3 shards and the index) re-imports equal to the
                 checkpoint's snapshot, leaf by leaf. Prints the cost_analysis
                 record, the run's analytic MFU and tokens/s.
15. supervise_small - `supervise` at the resume phase's size over a crash
                 fault at step 5 (exit 71, restart after a backoff) and a
                 SIGTERM to the second child (exit 75, immediate restart):
                 the final snapshot equals an uninterrupted run's bit for bit,
                 the third lifetime's resume record has restart_count 2, and
                 `report faults` / `report goodput` show the three lifetimes
                 with restart_downtime > 0.
16. fleet_8b   - serve's Llama-3-8B weights (32 layers, bf16, seed 0, made
                 again on the card) behind the port's fleet. Two replicas over
                 one params tree (r0 paged, r1 dense, 4 x 1024 each), each
                 behind the port's HTTP server: 16 greedy requests (prompts
                 of 64-600 tokens, 64 new) straight to the replicas, then
                 through the FleetRouter's front door; every stream equals
                 solo generate() or parts from it first at a near-tie, each
                 routed token is the training forward's argmax (through B1)
                 within NEAR_TIE, both replicas serve; the router's added
                 latency (8 one-token requests each way); obs-watch (a
                 subprocess) scrapes both replicas' /metrics throughout.
                 Chaos: DRILL_PLAN through a ChaosProxy on r1's wire, a lone
                 long request hedged (its loser cancelled on its replica),
                 8 requests in pairs: no client connection dropped, every
                 stream solo's or a near-tie, the breaker opens on r1, r0's
                 block pool whole again; r1's engine loop stopped, r1 is
                 ejected and r0 answers. Disagg: a prefill and a decode
                 replica behind the DisaggRouter, every stream handed off and
                 solo's or a near-tie; ship bytes per prompt token (131,072 at
                 8B bf16), ship seconds, TTFT against the monolithic fleet's.
                 The router's and both tiers' trace shards through `report
                 merge-trace` and `report trace` (the critical path sums to
                 the request's wall time); `report timeseries` and `report
                 dashboard` of obs-watch's series. Peak memory and seconds.
17. deploy_small - the train -> serve loop through the CLI at the resume
                 size (an 8B-width checkpoint is 40.6 GB): train() writes
                 steps 2, 4, 6; two `serve` replicas of step 2; `fleet
                 --watch-checkpoint-dir` canaries step 4 (its held-out loss on
                 the card, through B1) and promotes it, then rolls back a
                 step 6 written with a NaN snapshot and never canaries it
                 again; `report faults` of the events JSONL lists the
                 promotion then the rollback; the fleet-goodput record's state
                 seconds sum to the tracked replica-seconds within 1%; the
                 CLI's canary losses equal this process's; the rolled-back
                 canary's own greedy streams (both slots, which served the
                 NaN weights) equal the other replica's. Then `fleet
                 --autoscale-template` over one `serve` replica: a burst takes
                 the fleet from 1 to 2 replicas (the new child serves), idle
                 drains it back to 1.
18. moe_small   - every MoE mode at a small float32 size (2 layers, hidden
                 64, 4/2 heads: hd 16, the FMA kernels; vocab 384; 4 experts
                 top-2; TF32 off) from one parameter tree, two DiLoCo rounds
                 (W 2, H 2, grad_accum 2) on the card twice and on the CPU:
                 token-choice dense at cf 1.25 and at cf 0.25 (the capacity
                 binds), ragged, and expert-choice. The two card runs are bit-
                 identical; card and CPU losses and snapshots agree within
                 train_small's 1e-3; the router probe on one snapshot agrees
                 (dropped within one assignment, entropy 1e-5); top-k ties
                 come out lower index first on both; B1, B2, B3 launch, all
                 on the FMA kernels.
19. moe_train   - train() on bench.py's moe-8x-top2 (vocab 32000, hidden 512,
                 6 layers, 8/4 heads: hd 64 bf16; 8 experts top-2) at its
                 bench shape (S 1024 x B 8, W 2, H 2, 3 rounds), dense at cf
                 1.25 and ragged: tokens/s, peak memory, t_inner, t_sync
                 beside its byte bound, the analytic MFU, the router stats of
                 each sync; every kernel launches in every run, B1 and B3
                 only on the tensor cores and B2 only on the FMA kernel. The
                 ragged run checkpointed after round 1 and resumed equals the
                 uninterrupted one bit for bit. One profiled inner step per
                 dispatch (kernel ms by class, host syncs, idle share). `python
                 -m nanodiloco_tpu_torch --llama-config-file
                 configs/llama_moe_64e.json --attention flash --dtype
                 bfloat16` (64 experts, ragged, hd 32) in a subprocess, 3
                 rounds.
20. moe_serve   - moe-8x-top2 weights (seed 0, bf16) behind the dense and the
                 paged engine (4 slots x 1024, chunk 512, 8 greedy requests of
                 64 new tokens). Ragged: every stream equals solo generate() or
                 parts from it first at a near-tie, and each token is the
                 training forward's argmax within NEAR_TIE. Dense at cf 1.25:
                 streams that part beyond a near-tie are the documented
                 capacity divergence, counted. `generate` from the CLI on
                 moe_train's ragged checkpoint equals generate() on its
                 snapshot.

21. kernels_main - each kernel at every shape the main path (phases 4-20)
                 gave it, held against its plain version at its route's
                 tolerance and timed as in phase 3; fails unless every
                 kernel ran at the head dim and dtype of every model the
                 path trains (bf16 hd 128, 64, 32; f32 hd 64, 16).

Then the kernels line ({"kernels": [...]}: one entry per kernel and shape
of the main path, with its launches there, in all and by phase), the
nvidia-smi line, and last
{"ok": true, "device": {...}}. Needs one card; builds into build/ and
writes its runs and checkpoints under build/chip_smoke/, and the files
of phases 13-20 in a directory of its own under /dev/shm (a tmpfs: the
card's machine allows a run 45 GiB of disk writes, and
checkpoint_full takes 40.6 GB of them), each removed at the end.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
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
    kv_bytes_per_token,
    noise_uniforms,
    serving_params,
)
from nanodiloco_tpu_torch.models import safetensors_io
from nanodiloco_tpu_torch.models.hf_interop import _export_plan, from_hf_pretrained, hf_config
from nanodiloco_tpu_torch.models.moe import _mm as moe_mm
from nanodiloco_tpu_torch.models.moe import _top as moe_top
from nanodiloco_tpu_torch.models.moe import make_router_stats_fn
from nanodiloco_tpu_torch.models.llama import (
    causal_lm_loss,
    forward,
    init_params,
    tree_leaves,
    tree_map,
)
from nanodiloco_tpu_torch.obs.costs import analytic_mfu
from nanodiloco_tpu_torch.obs.goodput import CAUSES as GOODPUT_CAUSES
from nanodiloco_tpu_torch.obs.telemetry import parse_metrics_text
from nanodiloco_tpu_torch.obs.watchdog import WatchdogConfig
from nanodiloco_tpu_torch.ops.cuda import build
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.parallel.streaming import StreamingConfig, StreamingDiloco
from nanodiloco_tpu_torch.serve import (
    GenRequest,
    InferenceEngine,
    Scheduler,
    ServeServer,
    http_get,
    http_post_json,
    kvship,
)
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager, named_leaves, state_tree
from nanodiloco_tpu_torch.training.metrics import read_jsonl_records, summarize_run
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
# the files of hf_8b, faults_8b and supervise_small go in a directory of
# this run's own in RAM (/dev/shm, a tmpfs; main() makes it and removes
# it), because a run on the card's machine may write 45 GiB to its disk
# and checkpoint_full writes 40.6 GB there
MEM_PARENT = "/dev/shm"

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
# (name, dtype, B, H, Hkv, S, hd, causal): every route-table row's edge
# shapes (ragged S, non-causal, S under one tile, MHA, GQA) and the shapes
# the longest runs of the main path give the kernels (B counts every
# worker's sequences: the model folds W x b into B before attention):
#   train_bf16: the 8B width's training (train, diloco_options_8b, faults_8b);
#   moe_hd64: moe-8x-top2 in moe_train (W 2 x b 8);
#   moe64e_hd32: llama_moe_64e through the CLI in moe_train (W 2 x b 8, MHA);
#   tiny_hd32: bench.py's tiny model on one device (b 8);
#   small_f32_hd64 / moe_small_f32_hd16: train_small's and moe_small's rounds.
# The kernels line does not come from these: the main path's own shapes are
# counted as it runs (fa.shape_counts) and held and timed after it
# (kernels_main). Here the first shape of every route that no phase is
# built to run (MAIN_PATH_ROUTES) is timed, so that every route has a time.
SHAPES = [
    ("train_bf16", torch.bfloat16, 2, 32, 8, 2048, 128, True),
    ("ragged_gqa4_bf16", torch.bfloat16, 1, 8, 2, 1000, 128, True),
    ("noncausal_gqa2_bf16", torch.bfloat16, 2, 4, 2, 77, 128, False),
    ("mha_bf16", torch.bfloat16, 2, 4, 4, 256, 128, True),
    ("moe_hd64", torch.bfloat16, 16, 8, 4, 1024, 64, True),
    ("gqa2_bf16_hd64", torch.bfloat16, 2, 4, 2, 320, 64, True),
    ("ragged_gqa4_bf16_hd64", torch.bfloat16, 1, 8, 2, 1000, 64, True),
    ("noncausal_mha_bf16_hd64", torch.bfloat16, 2, 4, 4, 130, 64, False),
    ("moe64e_hd32", torch.bfloat16, 16, 8, 8, 1024, 32, True),
    ("tiny_hd32", torch.bfloat16, 8, 4, 4, 1024, 32, True),
    ("noncausal_bf16_hd32", torch.bfloat16, 2, 4, 4, 192, 32, False),
    ("ragged_gqa2_bf16_hd32", torch.bfloat16, 1, 4, 2, 77, 32, True),
    ("ragged_gqa2_bf16_hd16", torch.bfloat16, 2, 4, 2, 200, 16, True),
    ("noncausal_bf16_hd80", torch.bfloat16, 1, 4, 4, 77, 80, False),
    ("gqa4_bf16_hd96", torch.bfloat16, 1, 8, 2, 256, 96, True),
    ("small_f32_hd64", torch.float32, 2, 4, 2, 200, 64, True),
    ("mha_f32", torch.float32, 2, 4, 4, 256, 64, True),
    ("gqa4_f32", torch.float32, 1, 8, 2, 320, 128, True),
    ("noncausal_gqa2_f32", torch.float32, 2, 4, 2, 192, 32, False),
    ("ragged_f32", torch.float32, 1, 4, 1, 1000, 128, True),
    ("ragged_noncausal_f32", torch.float32, 1, 2, 2, 77, 64, False),
    ("moe_small_f32_hd16", torch.float32, 2, 4, 2, 200, 16, True),
    ("noncausal_f32_hd16", torch.float32, 2, 4, 4, 130, 16, False),
    ("ragged_gqa2_f32_hd80", torch.float32, 1, 4, 2, 333, 80, True),
    ("mha_f32_hd96", torch.float32, 2, 2, 2, 128, 96, True),
]
# the (dtype, head dim) of each model the main path trains: every kernel
# must launch at each of them (the 8B width and the resume size; moe-8x-top2;
# llama_moe_64e; train_small; moe_small)
MAIN_PATH_ROUTES = ((torch.bfloat16, 128), (torch.bfloat16, 64), (torch.bfloat16, 32),
                    (torch.float32, 64), (torch.float32, 16))
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


T0 = time.perf_counter()


def emit(**kv) -> None:
    """One JSON line; ``elapsed_s`` is the script's seconds so far."""
    print(json.dumps({**kv, "elapsed_s": round(time.perf_counter() - T0, 1)}), flush=True)


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


def within(phase, name, got, want, tol) -> tuple[float, float]:
    """(max |err|, the ATOL share of max|want| that the output needs at this
    RTOL); fails ``phase`` if that is more than the tolerance's ATOL."""
    atol, rtol = tol
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(phase, f"{name}: non-finite kernel output")
    err = (got - want).abs()
    need = max(0.0, (err - rtol * want.abs()).max().item()) / max(want.abs().max().item(), 1e-30)
    if need > atol:
        fail(phase, f"{name}: max |err| {err.max().item():.3e} over tolerance "
                    f"(needs atol_of_max {need:.3e} > {atol:.3e})")
    return err.max().item(), need


def attended_pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def bounds(dtype, bh, bh_kv, s, hd, causal) -> dict:
    """Least time per kernel at q [bh, s, hd], k and v [bh_kv, s, hd]:
    max(tensor-core products / peak rate, bytes each read once and written
    once / HBM rate). The exps are not counted."""
    esize = torch.finfo(dtype).bits // 8
    prod = 2.0 * hd * attended_pairs(s, causal) * bh  # one S x S x hd product
    q_bytes = bh * s * hd * esize
    kv_bytes = bh_kv * s * hd * esize
    row_bytes = bh * s * 4  # lse or delta
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


def check_variants(phase: str, variants: dict, dtype, hd: int) -> None:
    """Fails ``phase`` unless every launch in ``variants`` (a
    ``fa.variant_counts()``) went to the variant ROUTES names for
    (kernel, dtype, hd), and every kernel launched."""
    for kname, counts in variants.items():
        want = fa.ROUTES[kname, dtype, hd]
        if any(n for v, n in counts.items() if v != want) or counts[want] == 0:
            fail(phase, f"{kname} at {dtype} hd {hd} must launch only {want}: {variants}")


def check_routes(phase: str, dtype, hd: int) -> None:
    """check_variants on this process's launches since the counts were last
    reset."""
    check_variants(phase, fa.variant_counts(), dtype, hd)


def hold(phase: str, tag: str, dtype, bh: int, bh_kv: int, s: int, hd: int, causal: bool,
         kernels=fa.KERNEL_NAMES, timed: bool = False) -> dict:
    """Each of ``kernels`` against its plain version at q [bh, s, hd], k and
    v [bh_kv, s, hd], on its route's tolerance (fails ``phase`` past it);
    with ``timed``, CUDA-event times of the kernel, its plain version and
    the library call beside the bounds. The backward kernels take the
    plain forward's (O, lse), so each is held against its plain version on
    identical inputs. Returns the shape's JSON fields."""
    variant = {kname: fa.ROUTES[kname, dtype, hd] for kname in kernels}
    tol = {kname: TOL[dtype, v] for kname, v in variant.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, do = rnd(bh, s, hd), rnd(bh, s, hd)
    k, v = rnd(bh_kv, s, hd), rnd(bh_kv, s, hd)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    checks = {}
    if "flash_fwd" in kernels:
        o, lse = fa.flash_fwd(q, k, v, causal)
        checks["flash_fwd"] = [within(phase, f"{tag} O", o, o_ref, tol["flash_fwd"]),
                               within(phase, f"{tag} lse", lse, lse_ref,
                                      TOL[torch.float32, "fma"])]
    if "flash_bwd_dq" in kernels:
        dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal)
        dq_ref = fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal)
        checks["flash_bwd_dq"] = [within(phase, f"{tag} dQ", dq, dq_ref, tol["flash_bwd_dq"])]
    if "flash_bwd_dkv" in kernels:
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
        dk_ref, dv_ref = fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)
        checks["flash_bwd_dkv"] = [
            within(phase, f"{tag} dK", dk, dk_ref, tol["flash_bwd_dkv"]),
            within(phase, f"{tag} dV", dv, dv_ref, tol["flash_bwd_dkv"])]
    errs = {kname: max(e for e, _ in c) for kname, c in checks.items()}
    out = {"dtype": str(dtype).removeprefix("torch."), "BH": bh, "BH_kv": bh_kv, "S": s,
           "hd": hd, "causal": causal, "variant": variant, "max_abs_err": errs,
           "atol_of_max_needed": {kname: max(n for _, n in c) for kname, c in checks.items()},
           "tolerance": {kname: {"atol_of_max": tol[kname][0], "rtol": tol[kname][1],
                                 "reason": TOL_REASON[dtype, variant[kname]]}
                         for kname in errs}}
    if timed:
        timing = time_kernels(q, k, v, do, lse_ref, delta, causal, kernels)
        bnd = bounds(dtype, bh, bh_kv, s, hd, causal)
        out["timing"] = {}
        for kname in kernels:
            t = timing[kname]
            rate = {"tflops": bnd[kname]["flops"] / (t["ms"] * 1e-3) / 1e12,
                    "bound_share": bnd[kname]["bound_ms"] / t["ms"]}
            out["timing"][kname] = {"variant": variant[kname], "dtype": out["dtype"], "hd": hd,
                                    "max_abs_err": errs[kname], **t, **bnd[kname], **rate}
    torch.cuda.synchronize()
    return out


def phase_kernels() -> None:
    """Each kernel against its plain version at every shape of SHAPES, on
    its route's tolerance; timed at the first shape of every route that no
    phase is built to run (the others are timed at the main path's own
    shapes, in kernels_main)."""
    covered = {(dtype, hd) for _, dtype, *_, hd, _ in SHAPES}
    missing = {(dtype, hd) for _, dtype, hd in fa.ROUTES} - covered
    if missing:
        fail("kernels", f"route-table rows without a shape: {sorted(map(str, missing))}")
    timed = set(MAIN_PATH_ROUTES)
    for name, dtype, b, h, hkv, s, hd, causal in SHAPES:
        line = hold("kernels", name, dtype, b * h, b * hkv, s, hd, causal,
                    timed=(dtype, hd) not in timed)
        timed.add((dtype, hd))
        emit(phase="kernels", ok=True, shape=name, B=b, H=h, Hkv=hkv, **line)
        torch.cuda.empty_cache()


def phase_kernels_main(path: dict) -> list[dict]:
    """Each kernel at every shape the main path gave it (``path``: launches
    by phase, kernel and ``fa.shape_key``), held against its plain version
    and timed as in the kernels phase. Fails unless every kernel launched at
    every route of MAIN_PATH_ROUTES. Returns the kernels line: one entry
    per kernel and shape, with its launches at that shape, in all and by
    phase."""
    at = {}  # shape -> kernel -> phase -> launches
    for phase, by_kernel in path.items():
        for kname, shapes in by_kernel.items():
            for key, n in shapes.items():
                at.setdefault(key, {}).setdefault(kname, {})[phase] = n
    ran = {(kname, dtype, hd) for key, by_kernel in at.items() for kname in by_kernel
           for dtype, _, _, _, _, hd, _ in [fa.parse_shape_key(key)]}
    idle = [(kname, str(dtype), hd) for dtype, hd in MAIN_PATH_ROUTES
            for kname in fa.KERNEL_NAMES if (kname, dtype, hd) not in ran]
    if idle:
        fail("kernels_main", f"a route of the main path was not launched: {idle}")
    line = []
    for key in sorted(at, key=lambda key: -sum(sum(p.values()) for p in at[key].values())):
        dtype, bh, bh_kv, sq, sk, hd, causal = fa.parse_shape_key(key)
        if sq != sk:
            fail("kernels_main", f"{key}: the main path attends across lengths")
        kernels = tuple(kname for kname in fa.KERNEL_NAMES if kname in at[key])
        out = hold("kernels_main", key, dtype, bh, bh_kv, sq, hd, causal, kernels, timed=True)
        emit(phase="kernels_main", ok=True, shape=key, launches=at[key], **out)
        for kname in kernels:
            t = out["timing"][kname]
            line.append({"name": kname, "route": "cuda", "source": SOURCE[t["variant"]],
                         "replaces": REPLACES[kname], "shape": key,
                         "launches": sum(at[key][kname].values()),
                         "launches_by_phase": at[key][kname], **t})
        torch.cuda.empty_cache()
    return line


def time_kernels(q, k, v, do, lse, delta, causal, kernels) -> dict:
    """{kernel: ms, plain_ms, library_ms} at one shape. The library call is
    torch's fused attention on the same inputs in its [B, H, S, hd] layout
    (q as [BH_kv, group, S, hd], k and v as [BH_kv, 1, S, hd]): its forward
    for B1, one backward (dQ, dK and dV) for B2 and B3."""
    calls = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, causal),
                      lambda: fa.flash_fwd_plain(q, k, v, causal)),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    (bh, s, hd), bh_kv = q.shape, k.shape[0]
    ql = q.view(bh_kv, bh // bh_kv, s, hd).detach().requires_grad_(True)
    kl = k.view(bh_kv, 1, s, hd).detach().requires_grad_(True)
    vl = v.view(bh_kv, 1, s, hd).detach().requires_grad_(True)
    library = {}
    if "flash_fwd" in kernels:
        library["flash_fwd"] = cuda_ms(lambda: sdpa(ql, kl, vl, is_causal=causal,
                                                    enable_gqa=True))
    if {"flash_bwd_dq", "flash_bwd_dkv"} & set(kernels):
        out = sdpa(ql, kl, vl, is_causal=causal, enable_gqa=True)
        dol = do.view(bh_kv, bh // bh_kv, s, hd)
        library["flash_bwd_dq"] = library["flash_bwd_dkv"] = cuda_ms(
            lambda: torch.autograd.grad(out, (ql, kl, vl), dol, retain_graph=True))
    return {name: {"ms": cuda_ms(calls[name][0]),
                   "plain_ms": cuda_ms(calls[name][1], runs=5, reps=1),
                   "library_ms": library[name]}
            for name in kernels}


# train_small's size: float32, hd 64, so the FMA kernels run
SMALL_MODEL = LlamaConfig(vocab_size=384, hidden_size=256, intermediate_size=512,
                          num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                          attention_impl="flash", remat=True, loss_chunk=128)
SMALL_DILOCO = dict(num_workers=2, inner_steps=2, warmup_steps=1, total_steps=4, lr=1e-3,
                    grad_accum=2)
# card against CPU at float32, TF32 off (train_small's reason)
SMALL_TOL = 1e-3


def small_rounds(n: int = 2) -> list[tuple[np.ndarray, np.ndarray]]:
    """n rounds of [H, W, accum, B, S] tokens and masks; S = 200 is no
    multiple of the kernels' 64-row tiles: the ragged edge."""
    rows = pack_corpus(synthetic_corpus(seed=0), ByteTokenizer(), 200)
    batches = iter(DilocoBatcher(rows, num_workers=2, grad_accum=2, per_device_batch=1))
    rounds = []
    for _ in range(n):
        steps = [next(batches) for _ in range(SMALL_DILOCO["inner_steps"])]
        rounds.append((np.stack([t for t, _ in steps]), np.stack([m for _, m in steps])))
    return rounds


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / max |want|."""
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max().clamp_min(1e-30))


def phase_train_small() -> None:
    """Two DiLoCo rounds at a small float32 size from one parameter tree,
    on the card (through the kernels) and on the CPU (through their plain
    versions): the per-step [W] losses and the final snapshot must agree.
    Both sides run float32 matmuls in full float32 (TF32 off) and differ
    only in summation order, which four AdamW steps amplify to ~1e-5
    relative; 1e-3 bounds it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    model, dcfg, rounds = SMALL_MODEL, DilocoConfig(**SMALL_DILOCO), small_rounds()
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
    launches = fa.launch_counts()
    if min(launches.values()) == 0:
        fail("train_small", f"a kernel was not launched: {launches}")
    emit(phase="train_small", ok=True, losses=got.tolist(), cpu_losses=want.tolist(),
         max_rel_err=err, snapshot_max_rel_err=snap_err, tolerance=1e-3, launches=launches)


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


def phase_train(smi: str) -> dict:
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
    # the resilience and observability records of a plan-free run
    all_recs = read_jsonl_records(jsonl)[0]
    goodput = [r["goodput"] for r in all_recs if r.get("goodput")]
    cost = next((r["cost_analysis"] for r in all_recs if r.get("cost_analysis")), None)
    if (len(goodput) != 3 or not goodput[-1].get("final") or cost is None
            or not all("devtime" in r for r in round_ends) or summary["alarms"] != 0):
        fail("train", f"goodput {len(goodput)}, cost {cost}, devtime on "
                      f"{[r['step'] for r in round_ends if 'devtime' in r]}, "
                      f"alarms {summary['alarms']}")
    tps_warm = summary["tokens_per_sec_after_first_round"]
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
         cost_analysis=cost, mfu_analytic_after_first_round=analytic_mfu(cost, tps_warm),
         goodput=goodput[-1], devtime=round_ends[-1]["devtime"],
         report=report, report_compare="exit 0")
    return summary


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


# -- the DiLoCo options ----------------------------------------------------------

# each option at train_small's size: DilocoConfig fields, a streaming
# config, or model fields
SMALL_OPTIONS = {
    "quarantine": {"dcfg": {"quarantine_nonfinite": True}},
    "bf16_wire": {"dcfg": {"outer_comm_dtype": "bfloat16"}},
    "int8_wire": {"dcfg": {"outer_comm_dtype": "int8"}},
    "int4_integer_wire": {"dcfg": {"outer_comm_dtype": "int4", "outer_wire_collective": True}},
    "dynamics": {"dcfg": {"dynamics_metrics": True}},
    "hetero_1_2": {"dcfg": {"inner_steps_per_worker": (1, 2)}},
    "async_delay1": {"dcfg": {"async_outer": True, "outer_delay": 1}},
    "streaming_p2_delay1": {"streaming": {"num_fragments": 2, "delay": 1, "merge_alpha": 0.5}},
    "offload": {"dcfg": {"offload_snapshot": True}},
    "remat_dots": {"model": {"remat_policy": "dots"}},
}


def drive_option(device: str, params, rounds, dcfg=None, streaming=None, model=None):
    """The option's rounds from ``params``: (losses [R*H, W], snapshot
    leaves, dynamics per sync, the largest |snapshot - worker| entering a
    classic sync), on the CPU for the comparison."""
    cfg = DilocoConfig(**{**SMALL_DILOCO, **(dcfg or {})})
    mcfg = dataclasses.replace(SMALL_MODEL, **(model or {}))
    if streaming is not None:
        dl = StreamingDiloco(mcfg, cfg, StreamingConfig(**streaming), device=device)
    else:
        dl = Diloco(mcfg, cfg, device=device)
    state = dl.init_state(params=params)
    losses, dyn, amax = [], [], 0.0
    for r, (t, m) in enumerate(rounds):
        if streaming is not None:
            loss = dl.round_step(state, t, m)[1]
        elif cfg.async_outer:
            _, loss, aux = (dl.inner_round_step if r == 0 else dl.async_round_step)(state, t, m)
            if r and "dynamics" in aux:
                dyn.append(aux["dynamics"])
        else:
            _, loss = dl.inner_round(state, t, m)
            amax = max([amax] + [float((s.unsqueeze(0) - p.detach()).abs().max())
                                 for s, p in zip(tree_leaves(dl.device_snapshot(state)),
                                                 tree_leaves(state.params))])
            mask = torch.isfinite(loss).all(dim=0) if cfg.quarantine_nonfinite else None
            _, _, d = dl.outer_step(state) if mask is None else dl.outer_step(state, mask)
            if d is not None:
                dyn.append(d)
        losses.append(loss.cpu())
    if cfg.async_outer:
        dl.async_flush(state)
    snapshot = [t.detach().cpu() for t in tree_leaves(state.snapshot)]
    return (torch.cat(losses), snapshot, [{k: v.cpu() for k, v in d.items()} for d in dyn],
            amax)


def wire_bin(dcfg: dict, amax: float) -> float:
    """How far one quantization bin moves the snapshot: the card's and the
    CPU's deltas differ at float32 roundoff, so an element near a bin edge
    lands one bin off, moving the snapshot by outer_lr * (1 + momentum) *
    scale (a bf16 cast: one bf16 ulp, 2**-8 of the largest delta)."""
    wire = dcfg.get("outer_comm_dtype")
    if wire is None:
        return 0.0
    q_max = {"int4": 7, "int8": 127, "int16": 32767}.get(wire)
    scale = amax / q_max if q_max else amax * 2.0 ** -8
    cfg = DilocoConfig(**SMALL_DILOCO)
    return cfg.outer_lr * (1 + cfg.outer_momentum) * scale


def phase_diloco_options_small(smi: str) -> None:
    """Every DiLoCo option at train_small's size (float32, TF32 off), on
    the card and on the CPU from one parameter tree: losses and snapshot
    within SMALL_TOL (under a quantized wire after one bin, ``wire_bin``),
    and one sync's deltas quantize bit for bit alike on both devices
    (``wire_bits_check``). On the card also: a NaN written into worker 1's
    replica mid-round is quarantined (worker 1 finite after the sync, the
    snapshot the survivor's Nesterov step); dynamics on and off, async at
    delay 0, and streaming at P=1, delay 0, alpha 1 are classic bit for
    bit (within twice the run-to-run spread of two classic runs, should
    those differ); remat "dots" gives the gradients of no remat and
    recomputes no GEMM (``dots_check``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rounds = small_rounds()
    params = init_params(torch.Generator().manual_seed(0), SMALL_MODEL, device="cpu")
    fa.reset_launch_counts()
    card = {name: drive_option("cuda", params, rounds, **opt)
            for name, opt in {"classic": {}, **SMALL_OPTIONS}.items()}
    same = {
        "dynamics_on_off": card["dynamics"],
        "async_delay0": drive_option("cuda", params, rounds,
                                     dcfg={"async_outer": True, "outer_delay": 0}),
        "streaming_p1_delay0_alpha1": drive_option(
            "cuda", params, rounds, streaming={"num_fragments": 1, "delay": 0}),
    }
    quarantine = quarantine_check(params, rounds[0])
    wire_bits = wire_bits_check(params, rounds[0])
    dots = dots_check(params, rounds[0])
    launches = fa.launch_counts()
    if min(launches.values()) == 0:
        fail("diloco_options_small", f"a kernel was not launched: {launches}")
    # the identities are bit for bit where two classic runs are; else
    # within twice their run-to-run spread (as the resume phase holds them)
    classic, again = card["classic"], drive_option("cuda", params, rounds)

    def spread(run) -> float:
        return max([rel_err(run[0], classic[0])]
                   + [rel_err(a, b) for a, b in zip(run[1], classic[1])])

    def snapshot_err(got, want, bin_tol: float) -> float:
        """The snapshot's error against SMALL_TOL, leaf by leaf, after
        one quantization bin (``wire_bin``) is granted."""
        return max(float(((a.double() - b.double()).abs() - bin_tol).clamp_min(0).max()
                         / b.double().abs().max()) for a, b in zip(got, want))

    run_to_run = spread(again)
    identities = {name: spread(run) for name, run in same.items()}
    for name, err in identities.items():
        if err > 2 * run_to_run:
            fail("diloco_options_small", f"{name} is off classic DiLoCo by {err:.3e} "
                                         f"(run to run {run_to_run:.3e})")
    errs = {}
    for name, opt in SMALL_OPTIONS.items():
        losses, snap, dyn, amax = drive_option("cpu", params, rounds, **opt)
        got = card[name]
        if not torch.isfinite(got[0]).all():
            fail("diloco_options_small", f"{name}: non-finite loss on the card {got[0]}")
        bin_tol = wire_bin(opt.get("dcfg", {}), max(amax, got[3]))
        errs[name] = {"losses": rel_err(got[0], losses),
                      "snapshot": snapshot_err(got[1], snap, bin_tol)}
        if bin_tol:
            errs[name]["snapshot_raw"] = max(rel_err(a, b) for a, b in zip(got[1], snap))
            errs[name]["bin_tolerance_abs"] = bin_tol
        if dyn:
            errs[name]["dynamics"] = max(rel_err(a[k], b[k]) for a, b in zip(got[2], dyn)
                                         for k in b)
        if max(errs[name][k] for k in ("losses", "snapshot", "dynamics")
               if k in errs[name]) > SMALL_TOL:
            fail("diloco_options_small", f"{name}: card vs CPU {errs[name]} over {SMALL_TOL}")
    emit(phase="diloco_options_small", ok=True, nvidia_smi=smi, options=list(SMALL_OPTIONS),
         card_vs_cpu_max_rel_err=errs, tolerance=SMALL_TOL,
         classic_run_to_run_max_rel_err=run_to_run, identities_max_rel_err=identities,
         quarantine=quarantine, wire_bits=wire_bits, remat=dots,
         launches=launches)


def quarantine_check(params, round0) -> dict:
    """A NaN written into worker 1's replica after the round's first inner
    step: the sync quarantines it, every worker ends finite, and the new
    snapshot is the Nesterov step on worker 0's pseudo-gradient alone
    (the first sync: momentum = delta, update = -lr (1 + mu) delta)."""
    cfg = DilocoConfig(**SMALL_DILOCO, quarantine_nonfinite=True)
    dl = Diloco(SMALL_MODEL, cfg, device="cuda")
    state = dl.init_state(params=params)
    tokens, mask = round0
    dl.inner_step(state, tokens[0], mask[0])
    with torch.no_grad():
        for p in tree_leaves(state.params):
            p[1] = float("nan")
    for h in range(1, cfg.inner_steps):
        dl.inner_step(state, tokens[h], mask[h])
    old = [t.clone() for t in tree_leaves(state.snapshot)]
    survivor = [t.detach()[0].clone() for t in tree_leaves(state.params)]
    _, eff, _ = dl.outer_step(state)
    want = [s - cfg.outer_lr * (1 + cfg.outer_momentum) * (s - w) for s, w in zip(old, survivor)]
    err = max(rel_err(a, b) for a, b in zip(tree_leaves(state.snapshot), want))
    finite = all(bool(torch.isfinite(t).all()) for t in tree_leaves(state.params))
    if eff.tolist() != [True, False] or not finite or err > 1e-5:
        fail("diloco_options_small", f"quarantine: mask {eff.tolist()}, workers finite "
                                     f"{finite}, snapshot vs survivor step {err:.3e}")
    return {"effective_mask": eff.tolist(), "workers_finite": finite,
            "snapshot_vs_survivor_step_max_rel_err": err, "tolerance": 1e-5}


def wire_bits_check(params, round0) -> dict:
    """One classic round on the card, then its sync's deltas ``s - p``
    through every quantizer on the card and, copied to the CPU, there:
    the bf16 cast, int8 and int4 per worker (``quantize_wire``: integers
    and scales), the integer wire's shared-scale payload with no mask and
    with worker 1 masked (``integer_wire_payload``) and its merged leaf.
    Each must be identical on both devices (torch.equal): the one-bin
    allowance of the whole-run comparison is for inputs that differ, not
    for the quantizer."""
    dl = Diloco(SMALL_MODEL, DilocoConfig(**SMALL_DILOCO), device="cuda")
    state = dl.init_state(params=params)
    dl.inner_round(state, *round0)
    leaves = [(s.detach(), p.detach()) for s, p in zip(tree_leaves(state.snapshot),
                                                      tree_leaves(state.params))]
    compared = 0
    for wire in ("bfloat16", "int8", "int4"):
        integer = wire != "bfloat16"
        quant = {dev: Diloco(SMALL_MODEL, DilocoConfig(**SMALL_DILOCO, outer_comm_dtype=wire,
                                                       outer_wire_collective=integer),
                             device=dev) for dev in ("cuda", "cpu")}
        for i, (s, p) in enumerate(leaves):
            d = s.unsqueeze(0) - p
            host = (s.cpu(), p.cpu(), d.cpu())
            outs = {}
            for dev, (sd, pd, dd) in (("cuda", (s, p, d)), ("cpu", host)):
                q = quant[dev]
                if not integer:
                    outs[dev] = [q._wire_quantize(dd)]
                    continue
                outs[dev] = [*q.quantize_wire(dd), *q.integer_wire_payload(sd, pd, None),
                             *q.integer_wire_payload(sd, pd, [1.0, 0.0]),
                             q._integer_wire_leaf(sd, pd, None)]
            for k, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
                if not torch.equal(a.cpu(), b):
                    fail("diloco_options_small",
                         f"wire {wire}: output {k} of leaf {i} differs card vs CPU "
                         f"({int((a.cpu() != b).sum())} of {b.numel()} elements)")
                compared += 1
    return {"wires": ["bfloat16", "int8", "int4"], "leaves": len(leaves),
            "tensors_equal": compared}


# cuBLAS's GEMM kernels by name (sm90 xmma / nvjet / cutlass families)
GEMM_KERNEL = re.compile(r"gemm|xmma|nvjet|cutlass", re.IGNORECASE)


def dots_check(params, round0) -> dict:
    """One microbatch's forward and backward on the card with no remat,
    remat "nothing" and remat "dots". The gradients agree (1e-5 relative:
    the same kernels on the same inputs, launched in another order); in
    each backward, torch.profiler counts the GEMM kernels the card ran
    ("dots" recomputes no projection, so it runs fewer than "nothing") and
    the launch counter B1's launches (its recompute: one a layer under
    both policies, none without remat)."""
    tokens, mask = (torch.as_tensor(x[0, :, 0]).long().cuda() for x in round0)  # [W, B, S]
    grads, backward = {}, {}
    for policy in ("none", "nothing", "dots"):
        model = dataclasses.replace(SMALL_MODEL, remat=policy != "none",
                                    remat_policy="dots" if policy == "dots" else "nothing")
        p = tree_map(lambda v: v.cuda().unsqueeze(0).repeat(2, *[1] * v.ndim)
                     .requires_grad_(True), params)
        _, aux = causal_lm_loss(p, tokens, model, mask)
        loss = aux["sum_loss"].sum()
        torch.cuda.synchronize()
        b1 = fa.launch_counts()["flash_fwd"]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            loss.backward()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        backward[policy] = {"kernels": len(kernels),
                            "gemm_kernels": sum(bool(GEMM_KERNEL.search(k)) for k in kernels),
                            "flash_fwd_launches": fa.launch_counts()["flash_fwd"] - b1}
        grads[policy] = [t.grad for t in tree_leaves(p)]
    err = max(rel_err(a, b) for policy in ("nothing", "dots")
              for a, b in zip(grads[policy], grads["none"]))
    layers = SMALL_MODEL.num_hidden_layers
    fewer = ("gemm_kernels" if backward["none"]["gemm_kernels"] else "kernels")
    if (err > 1e-5 or backward["dots"][fewer] >= backward["nothing"][fewer]
            or [backward[k]["flash_fwd_launches"] for k in backward] != [0, layers, layers]):
        fail("diloco_options_small", f"remat: gradients off no-remat by {err:.3e}, "
                                     f"backward {backward}")
    return {"grad_max_rel_err_vs_no_remat": err, "backward": backward, "compared": fewer}


# the five runs at the train phase's 8B width
OPTIONS_8B = {
    "a_classic_dynamics": {},
    "b_quarantine_int8_integer_wire_offload": dict(
        quarantine_nonfinite=True, outer_comm_dtype="int8", outer_wire_collective=True,
        offload_snapshot=True),
    "c_async_delay1_hetero_2_1_int4": dict(
        async_outer=True, outer_delay=1, inner_steps_per_worker=(2, 1),
        outer_comm_dtype="int4"),
    "d_streaming_p1_delay1_alpha05": dict(streaming_fragments=1, streaming_delay=1,
                                          merge_alpha=0.5),
    "e_remat_dots": {},
}


def outer_bytes_per_param(name: str, workers: int) -> int:
    """Bytes per parameter the outer step must move, each input read once
    and each output written once: the workers (read, then reset),
    snapshot (read, written) and momentum (read, written) in float32;
    async also reads its pending head and writes its slot."""
    classic = 4 * workers * 2 + 4 * 2 + 4 * 2
    return classic + (8 if name.startswith("c_") else 0)


def phase_diloco_options_8b(smi: str) -> None:
    """The five option runs at the train phase's Llama-3-8B width (1 layer,
    W=2, H=2, grad_accum 2, S=2048, bf16 over f32 masters, flash), 3
    rounds each: tokens/s after the first round, t_sync per round beside
    the outer step's byte bound, peak memory, the kernels' launches (each
    must rise in every run) and the keys of the last sync record."""
    log_dir = WORK / "options_runs"
    shutil.rmtree(log_dir, ignore_errors=True)
    n = dataclasses.replace(LLAMA3_8B, num_hidden_layers=1).num_params()
    runs, total = {}, dict.fromkeys(fa.KERNEL_NAMES, 0)
    for name, opts in OPTIONS_8B.items():
        model = dataclasses.replace(LLAMA3_8B, num_hidden_layers=1,
                                    remat_policy="dots" if name == "e_remat_dots" else "nothing")
        cfg = TrainConfig(seed=0, batch_size=2, per_device_batch_size=1, seq_length=2048,
                          warmup_steps=1, total_steps=6, inner_steps=2, num_workers=2,
                          model=model, fit_vocab=False, quiet=True, log_dir=str(log_dir),
                          run_name=name, **opts)
        fa.reset_launch_counts()
        summary = train(cfg, device="cuda")
        launches = fa.launch_counts()
        if min(launches.values()) == 0:
            fail("diloco_options_8b", f"{name}: a kernel was not launched: {launches}")
        for k, v in launches.items():
            total[k] += v
        losses = summary["losses"]
        if len(losses) != 6 or not all(math.isfinite(x) for step in losses for x in step):
            fail("diloco_options_8b", f"{name}: losses {losses}")
        recs = [r for r in read_jsonl_records(str(log_dir / f"{name}.jsonl"))[0]]
        syncs = [r for r in recs if r.get("outer_synced")]
        bound_ms = outer_bytes_per_param(name, 2) * n / PEAK_BYTES * 1e3
        runs[name] = {
            "tokens_per_sec_after_first_round": summary["tokens_per_sec_after_first_round"],
            "round_seconds": summary["round_seconds"],
            "t_sync_s": [r.get("t_sync") for r in syncs],
            "outer_step_bound_ms": bound_ms,
            "outer_step_bytes_per_param": outer_bytes_per_param(name, 2),
            "peak_memory_bytes": summary["peak_memory_bytes"],
            "launches": launches,
            "sync_record_keys": sorted(syncs[-1]),
            "extra_records": [r for r in recs if "loss" not in r and "resume" not in r][:6],
            "final_loss": summary["final_loss"],
        }
        emit(phase="diloco_options_8b", run=name, ok=True, nvidia_smi=smi, **runs[name])
        del summary
        torch.cuda.empty_cache()
    a = runs["a_classic_dynamics"]
    if not all(k in a["sync_record_keys"] for k in ("drift_max", "pg_norm",
                                                    "wire_bytes_per_sync")):
        fail("diloco_options_8b", f"classic run lacks the dynamics/wire keys: {a}")
    emit(phase="diloco_options_8b", ok=True, nvidia_smi=smi, num_params=n,
         peak_memory_gb={k: v["peak_memory_bytes"] / 1e9 for k, v in runs.items()},
         tokens_per_sec={k: v["tokens_per_sec_after_first_round"] for k, v in runs.items()},
         launches=total)


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
    return {"exact": int((best == emitted).sum()), "n": len(stream), "gap": gap, "tol": tol,
            "max_gap": float(gap.max()), "gap_over_tol": float((gap / tol).max()),
            "ok": bool((gap <= tol).all()), "h": h, "logits": logits}


def phase_serve(smi: str) -> dict:
    """Returns the serving weights, which serve_paged reuses."""
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
    timing["kv_zero_slot"] = zero_cost(eng, 1, lambda: eng._zero_slot_rows(0))
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
    del eng
    torch.cuda.empty_cache()
    return sp


def zero_cost(eng: InferenceEngine, rows: int, zero) -> dict:
    """What a release's zeroing of KV rows costs: ``zero`` (one
    dense slot's rows, or ``rows`` blocks of a paged arena, in every layer
    and arena tensor) timed on the card beside the bytes it writes over
    the card's memory rate. Run on an idle engine: it overwrites them."""
    arena = list((eng.pool or eng.cache).values())
    nbytes = rows * arena[0].shape[0] * sum(t[0, 0].numel() * t.element_size() for t in arena)
    ms = cuda_ms(zero, runs=5)
    return {"ms": ms, "bytes": nbytes, "bound_ms": nbytes / PEAK_BYTES * 1e3}


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


# -- the serve engine's modes ---------------------------------------------------

MODES = {
    "dense": {},
    "paged": {"kv_block_size": 4},
    "paged_int8": {"kv_block_size": 4, "kv_dtype": "int8"},
    "paged_spec": {"kv_block_size": 4, "spec_k": 4},
}
# the int8 arena's bound on first-token logits: 5% of the fp logits' span,
# the JAX package's own bound (tests/test_kv_paging.py)
INT8_SPAN_TOL = 0.05


def modes_requests(prompt: torch.Tensor) -> list[GenRequest]:
    """serve_small's three requests plus two on a repeated prompt, where
    prompt lookup finds drafts."""
    rep = tuple(prompt[0, :6].tolist()) * 4
    return serve_small_requests(prompt) + [
        GenRequest(prompt=rep, max_new_tokens=12, seed=2),
        GenRequest(prompt=rep, max_new_tokens=10, temperature=0.8, seed=4),
    ]


def run_direct(eng: InferenceEngine, staged: dict[int, GenRequest], admit=None) -> dict:
    """Drive the engine without the scheduler: ``staged`` {slot: request}
    prefill at once; ``admit`` is (after_ticks, callback) run once. Each
    slot is released when its stream is complete. Returns {slot: tokens}."""
    out = {s: [eng.prefill(s, r)] for s, r in staged.items()}
    reqs = dict(staged)
    ticks = 0
    while any(len(out[s]) < reqs[s].max_new_tokens for s in reqs):
        if admit is not None and ticks == admit[0]:
            for s, r in admit[1]().items():
                reqs[s], out[s] = r, [eng.prefill(s, r)]
        emitted = eng.step()
        ticks += 1
        for s in reqs:
            if len(out[s]) < reqs[s].max_new_tokens:
                out[s] += emitted[s]
                if len(out[s]) >= reqs[s].max_new_tokens:
                    eng.release(s)
    return out


def ship_roundtrip(params, cfg, req: GenRequest, src: dict, dst: dict, device) -> list[int]:
    """Prefill ``req`` on an engine of layout ``src`` and park it, export it
    through the wire doc (JSON text and back), import it into an engine of
    layout ``dst`` and finish the stream there."""
    kw = dict(num_slots=2, max_len=64, chunk_size=8, device=device)
    sa = Scheduler(InferenceEngine(params, cfg, **kw, **src))
    ticket = sa.submit(dataclasses.replace(req, prefill_only=True, request_id="ship"))
    while not ticket.done():
        sa.tick()
    raw, parked = sa.export_parked("ship")
    doc = kvship.pack(kvship.ShippedKV(
        config=raw["config"], generation=raw["generation"], wire_dtype=raw["wire_dtype"],
        prompt_len=len(req.prompt), pos=raw["pos"], step_idx=len(parked.tokens) - 1,
        emitted=list(parked.tokens), k=raw["k"], v=raw["v"], ks=raw.get("ks"),
        vs=raw.get("vs"), request={}))
    shipped = kvship.unpack(json.loads(json.dumps(doc)))
    eng = InferenceEngine(params, cfg, **kw, **dst)
    sb = Scheduler(eng)
    ticket = sb.admit_import(req, shipped)
    while not ticket.done():
        sb.tick()
    if eng.kv_stats() and eng.kv_stats()["blocks_free"] != eng.kv_stats()["num_blocks"]:
        fail("serve_modes_small", f"KV import {src} -> {dst} leaked blocks: {eng.kv_stats()}")
    return ticket.result["tokens"]


def phase_serve_modes_small(smi: str) -> None:
    """The engine's modes at serve_small's size in float32, TF32 off, on
    the card and on the CPU: each mode's streams equal on both, and equal
    solo generate() (int8: its greedy streams, and first-token logits
    within INT8_SPAN_TOL of the fp span); a swap mid-stream; KV round
    trips dense -> paged and paged -> int8."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SERVE_SMALL
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    params2 = init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(1))
    reqs = modes_requests(prompt)
    streams, spec, logits_err, swap, ships = {}, {}, {}, {}, {}
    for d in ("cuda", "cpu"):
        want = [solo(params, cfg, r, d) for r in reqs]
        for mode, kw in MODES.items():
            eng = InferenceEngine(params, cfg, num_slots=2, max_len=64, chunk_size=8,
                                  prefix_cache_tokens=64, device=d, **kw)
            got = [t.result["tokens"] for t in drive(Scheduler(eng), reqs)]
            streams[mode, d] = got
            check = [(g, w) for g, w, r in zip(got, want, reqs)
                     if mode != "paged_int8" or not r.temperature]
            if any(g != w for g, w in check):
                fail("serve_modes_small", f"{mode} on {d}: {got} vs solo generate() {want}")
            if eng.paged:
                eng.prefix_cache.clear()
                if eng.block_pool.free_blocks != eng.block_pool.num_blocks:
                    fail("serve_modes_small", f"{mode} on {d} leaked blocks: {eng.kv_stats()}")
            if eng.spec_k:
                spec[d] = eng.spec_stats()
        # int8's first-token logits against the paged fp arena's
        first = {}
        for kv in ("model", "int8"):
            eng = InferenceEngine(params, cfg, num_slots=1, max_len=64, chunk_size=8,
                                  kv_block_size=4, kv_dtype=kv, device=d)
            eng.capture_prefill_logits = True
            first[kv] = []
            for r in reqs:
                eng.prefill(0, r)
                first[kv].append(eng.last_prefill_logits.copy())
                eng.release(0)
        logits_err[d] = max(float(np.abs(a - b).max() / max(a.max() - a.min(), 1e-6))
                            for a, b in zip(first["model"], first["int8"]))
        if logits_err[d] > INT8_SPAN_TOL:
            fail("serve_modes_small", f"int8 first-token logits on {d}: {logits_err[d]:.4f} "
                                      f"of the span > {INT8_SPAN_TOL}")
        # a swap mid-stream: request 0 keeps the old weights, request 1,
        # admitted after the swap, runs on the new ones
        eng = InferenceEngine(params, cfg, num_slots=2, max_len=64, chunk_size=8,
                              kv_block_size=4, device=d)
        mem = {}

        def do_swap():
            mem["before"] = torch.cuda.memory_allocated() if d == "cuda" else 0
            eng.swap_weights(params2)
            mem["both"] = torch.cuda.memory_allocated() if d == "cuda" else 0
            return {1: reqs[1]}

        old_bytes = tree_bytes(eng.params)
        got = run_direct(eng, {0: reqs[0]}, admit=(2, do_swap))
        mem["after"] = torch.cuda.memory_allocated() if d == "cuda" else 0
        if got[0] != want[0] or got[1] != solo(params2, cfg, reqs[1], d):
            fail("serve_modes_small", f"swap on {d}: the old stream {got[0]} (want {want[0]}) "
                                      f"or the new one {got[1]} left its weights")
        if d == "cuda" and mem["both"] - mem["after"] < old_bytes:
            fail("serve_modes_small", f"the old serving copy ({old_bytes} bytes) was not freed "
                                      f"when its last slot retired: {mem}")
        if set(eng._params_by_gen) != {1}:
            fail("serve_modes_small", f"generations left: {sorted(eng._params_by_gen)}")
        swap[d] = {"old_stream": got[0], "new_stream": got[1], "old_copy_bytes": old_bytes,
                   "memory_allocated": mem}
        # KV round trips: a sampled stream dense -> paged (bits kept), a
        # greedy one paged -> int8 (requantized on import)
        ships[d] = {
            "dense_to_paged": ship_roundtrip(params, cfg, reqs[1], {}, {"kv_block_size": 4}, d),
            "paged_to_int8": ship_roundtrip(params, cfg, reqs[0], {"kv_block_size": 4},
                                            {"kv_block_size": 4, "kv_dtype": "int8"}, d),
        }
        if ships[d]["dense_to_paged"] != want[1] or ships[d]["paged_to_int8"] != want[0]:
            fail("serve_modes_small", f"KV round trips on {d}: {ships[d]}, want {want[1]} and "
                                      f"{want[0]}")
    for mode in MODES:
        if streams[mode, "cuda"] != streams[mode, "cpu"]:
            fail("serve_modes_small", f"{mode}: card {streams[mode, 'cuda']} vs CPU "
                                      f"{streams[mode, 'cpu']}")
    if ships["cuda"] != ships["cpu"] or swap["cuda"]["new_stream"] != swap["cpu"]["new_stream"]:
        fail("serve_modes_small", f"card and CPU differ: ships {ships}, swap {swap}")
    if not spec["cuda"]["draft_tokens"]:
        fail("serve_modes_small", f"prompt lookup proposed nothing: {spec['cuda']}")
    emit(phase="serve_modes_small", ok=True, nvidia_smi=smi, modes=list(MODES),
         streams={m: streams[m, "cuda"] for m in MODES}, spec=spec["cuda"],
         int8_first_logits_err_of_span=logits_err, int8_tolerance=INT8_SPAN_TOL,
         swap=swap["cuda"], kv_ship=ships["cuda"])


# the 8B paged workload: 16 slots of max_len 4096, block 16, chunk 512;
# prompts over 512-3000 tokens, 64 new tokens each, greedy and sampled
PAGED = dict(num_slots=16, max_len=4096, kv_block_size=16, chunk_size=512)
PAGED_PROMPTS = tuple(int(n) for n in np.linspace(512, 3000, 16))
PAGED_NEW = 64
# paged against dense at a size that holds both: 16 slots of 1024
PAGED_VS_DENSE = dict(num_slots=16, max_len=1024, kv_block_size=16, chunk_size=512)
VS_DENSE_PROMPTS = tuple(int(n) for n in np.linspace(100, 900, 16))
VS_DENSE_NEW = 32


def random_prompts(cfg: LlamaConfig, lens, seed: int) -> list[tuple]:
    gen = torch.Generator().manual_seed(seed)
    return [tuple(torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()) for n in lens]


def near_tie(sp, cfg, req: GenRequest, a: list[int], b: list[int], phase: str, what: str,
             strict: bool = True) -> dict:
    """Where greedy streams ``a`` and ``b`` of ``req`` first part, the two
    tokens' logit gap in the training forward (through B1) over the prompt
    and the common prefix must be within NEAR_TIE; fails the phase if not
    (``strict``), else reports it ("near_tie": False)."""
    first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if first is None:
        return {"first_divergence": None}
    toks = torch.tensor([list(req.prompt) + a[:first]], device="cuda")
    with torch.no_grad():
        h = forward(sp, toks, dataclasses.replace(cfg, remat=False), return_hidden=True)[0, -1:]
        row = torch.matmul(h, sp["lm_head"]).float()
    ta, tb = torch.tensor([a[first]], device="cuda"), torch.tensor([b[first]], device="cuda")
    gap = (row[0, ta] - row[0, tb]).abs().item()
    tol = tie_tolerance(h, sp["lm_head"], row, ta, tb).item()
    if gap > tol and strict:
        fail(phase, f"{what}: streams part at {first} off a near-tie: gap {gap:.4g} > {tol:.4g}")
    return {"first_divergence": first, "gap": gap, "tol": tol, "near_tie": gap <= tol}


def tick_profile(eng: InferenceEngine, cfg: LlamaConfig, reqs, matmul_bytes: int) -> dict:
    """The decode tick with every slot live at the end of its prompt (the
    cursors held there): median host ms of 20 ticks (each ends in the host
    read of its tokens), the least time it could take (the matmul weights
    and each slot's K/V rows read once, over the HBM rate), and from 10
    profiled ticks the device's busy time, idle share and its heaviest
    kernels by name (the arena's gathers are among them)."""
    from torch.profiler import ProfilerActivity, profile

    for s, r in enumerate(reqs):
        eng.prefill(s, r)
    pos, steps = eng._pos.copy(), eng._step_idx.copy()

    def tick():
        eng.step()
        eng._pos[:], eng._step_idx[:] = pos, steps

    for _ in range(3):
        tick()
    times = []
    for _ in range(20):
        t0 = time.perf_counter()
        tick()
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    n = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            tick()
    busy_us, kernels = device_busy_us(prof)
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:100]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.end - e.time_range.start
    kv_read = int(sum(pos + 1)) * kv_bytes_per_token(cfg, eng.kv_dtype)
    bound = (matmul_bytes + kv_read) / PEAK_BYTES * 1e3
    for s in range(eng.num_slots):
        eng.release(s)
    out = {"live_slots": len(reqs), "ms": ms, "ms_min": min(times), "ms_max": max(times),
           "bound_ms": bound, "bound_by": "bytes", "bound_share": bound / ms,
           "kv_read_bytes": kv_read, "rows_attended_per_slot": (
               eng.table_blocks * eng.kv_block_size if eng.paged else eng.max_len)}
    if busy_us <= 0:
        out["idle_share"] = "not measured: the profiler showed no device time"
    else:
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        out.update(device_busy_ms=busy_us / 1e3 / n, kernels_per_tick=kernels / n,
                   idle_share=max(0.0, 1.0 - busy_us / 1e3 / n / ms),
                   top_kernels_ms={k: v / 1e3 / n for k, v in top})
    return out


def spec_tick_ms(sp, cfg: LlamaConfig, reqs) -> dict:
    """What a speculative tick costs against a plain one: every slot of a
    spec_k=4 engine live with its cursor held, the median host ms of 20
    ticks in which a scripted proposer offers each slot 4 drafts (one
    verify forward over 5 positions) and of 20 in which it offers none
    (the plain decode program)."""

    class Scripted:
        k = 4

        def propose(self, slot, cap):
            return [1] * min(self.k, cap)

        def begin(self, *a):
            pass

        observe = feedback = release = begin

    eng = InferenceEngine(sp, cfg, device="cuda", spec_k=4, **{**PAGED, "num_slots": len(reqs)})
    for s, r in enumerate(reqs):
        eng.prefill(s, r)
    eng.speculator = Scripted()
    pos, steps = eng._pos.copy(), eng._step_idx.copy()
    out = {}
    for k in (4, 0):
        eng.speculator.k = k
        times = []
        for i in range(23):
            t0 = time.perf_counter()
            eng.step()
            if i >= 3:
                times.append((time.perf_counter() - t0) * 1e3)
            eng._pos[:], eng._step_idx[:] = pos, steps
        out[f"drafts_{k}"] = statistics.median(times)
    del eng
    torch.cuda.empty_cache()
    return {"live_slots": len(reqs), **out}


def phase_serve_paged(sp, smi: str) -> None:
    """Llama-3-8B at full depth (32 layers, bf16), phase_serve's weights:
    one paged arena of 16 slots x 4096 serves 16 requests (prompts of
    512-3000 tokens, 64 new, greedy and sampled) with bf16 KV and with int8
    KV; the arena's bytes, peak memory, TTFT, decode tokens/s, the decode
    tick at 16 live slots against its bound, int8's agreement with bf16.
    Checks: paged bf16 against the dense engine (16 x 1024, greedy: streams
    part only at a near-tie), and spec_k=4 on repeated prompts against the
    same engine without speculation (likewise)."""
    cfg = LLAMA3_8B
    matmul_bytes = sum(tree_bytes(sp["layers"][k]) for k in MATMUL_KEYS) + tree_bytes(
        sp["lm_head"])
    prompts = random_prompts(cfg, PAGED_PROMPTS, seed=3)
    reqs = [GenRequest(prompt=p, max_new_tokens=PAGED_NEW, seed=20 + i,
                       temperature=0.0 if i % 2 == 0 else 0.8, top_k=0 if i % 4 != 1 else 50)
            for i, p in enumerate(prompts)]
    runs = {}
    for kv in ("model", "int8"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = InferenceEngine(sp, cfg, kv_dtype=kv, device="cuda", **PAGED)
        sched = Scheduler(eng)
        t0 = time.perf_counter()
        tickets = drive(sched, reqs, per_tick=len(reqs))
        seconds = time.perf_counter() - t0
        stats = sched.stats()
        runs[kv] = {"streams": [t.result["tokens"] for t in tickets],
                    "arena_bytes": eng.kv_bytes(),
                    "kv_bytes_per_token": kv_bytes_per_token(cfg, eng.kv_dtype),
                    "workload_seconds": seconds, "ttft_p50_s": stats["ttft_p50_s"],
                    "ttft_p95_s": stats["ttft_p95_s"],
                    "decode_tokens_per_sec": stats["decode_tokens_per_sec"],
                    "prefill_chunks": stats["prefill_chunks_total"],
                    "tick_16_slots": tick_profile(eng, cfg, reqs, matmul_bytes),
                    "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                    # the blocks of one 1024-token request (K, V and scales)
                    "kv_zero_blocks_1024_tokens": zero_cost(
                        eng, 1024 // eng.kv_block_size,
                        lambda: eng._zero_blocks(range(1024 // eng.kv_block_size)))}
        if any(len(s) != PAGED_NEW for s in runs[kv]["streams"]):
            fail("serve_paged", f"{kv}: stream lengths {[len(s) for s in runs[kv]['streams']]}")
        if eng.block_pool.free_blocks != eng.block_pool.num_blocks:
            fail("serve_paged", f"{kv}: blocks leaked: {eng.kv_stats()}")
        del eng, sched
    bf, i8 = runs["model"]["streams"], runs["int8"]["streams"]
    firsts = [next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), len(a))
              for a, b in zip(bf, i8)]
    agreement = {"streams_identical": sum(a == b for a, b in zip(bf, i8)),
                 "streams": len(bf),
                 "tokens_before_first_divergence_share": sum(firsts) / sum(map(len, bf)),
                 "greedy_streams_identical": sum(a == b for a, b, r in zip(bf, i8, reqs)
                                                 if not r.temperature)}

    # paged bf16 against the dense engine, 16 x 1024, greedy
    vs_reqs = [GenRequest(prompt=p, max_new_tokens=VS_DENSE_NEW, seed=i)
               for i, p in enumerate(random_prompts(cfg, VS_DENSE_PROMPTS, seed=4))]
    vs, vs_tick = {}, {}
    for layout, kw in (("dense", {"kv_block_size": 0}), ("paged", {})):
        eng = InferenceEngine(sp, cfg, device="cuda", **{**PAGED_VS_DENSE, **kw})
        vs[layout] = [t.result["tokens"] for t in drive(Scheduler(eng), vs_reqs,
                                                         per_tick=len(vs_reqs))]
        vs_tick[layout] = tick_profile(eng, cfg, vs_reqs, matmul_bytes)
        del eng
        torch.cuda.empty_cache()
    vs_checks = [near_tie(sp, cfg, r, a, b, "serve_paged", f"paged vs dense, prompt {len(r.prompt)}")
                 for r, a, b in zip(vs_reqs, vs["dense"], vs["paged"])]

    # spec_k = 4 against the same engine without it, on repetitive prompts
    # P + S + P, S the model's own greedy stream after P: prompt lookup
    # then proposes the rest of S, and the model may follow it
    heads = random_prompts(cfg, (224,) * 4, seed=5)
    eng = InferenceEngine(sp, cfg, device="cuda", **{**PAGED, "num_slots": len(heads)})
    firsts = [t.result["tokens"] for t in drive(Scheduler(eng), [
        GenRequest(prompt=h, max_new_tokens=64) for h in heads], per_tick=len(heads))]
    del eng
    spec_reqs = [GenRequest(prompt=h + tuple(f) + h, max_new_tokens=64, seed=i)
                 for i, (h, f) in enumerate(zip(heads, firsts))]
    spec = {}
    for k in (0, 4):
        eng = InferenceEngine(sp, cfg, device="cuda", spec_k=k,
                              **{**PAGED, "num_slots": len(spec_reqs)})
        eng.warm_spec()
        sched = Scheduler(eng)
        t0 = time.perf_counter()
        tickets = drive(sched, spec_reqs, per_tick=len(spec_reqs))
        spec[k] = {"streams": [t.result["tokens"] for t in tickets],
                   "seconds": time.perf_counter() - t0, "decode_ticks": eng.decode_ticks,
                   "stats": eng.spec_stats(),
                   "decode_tokens_per_sec": sched.stats()["decode_tokens_per_sec"]}
        del eng, sched
        torch.cuda.empty_cache()
    verify_tick = spec_tick_ms(sp, cfg, spec_reqs)
    if any(len(x) != 64 for x in firsts + spec[0]["streams"] + spec[4]["streams"]):
        fail("serve_paged", f"spec workload stream lengths: {spec}")
    spec_checks = [near_tie(sp, cfg, r, a, b, "serve_paged", f"spec vs plain, request {i}")
                   for i, (r, a, b) in enumerate(zip(spec_reqs, spec[0]["streams"],
                                                     spec[4]["streams"]))]
    for kv in runs:
        del runs[kv]["streams"]
    emit(phase="serve_paged", ok=True, nvidia_smi=smi, layers=cfg.num_hidden_layers,
         engine=PAGED, prompt_lens=list(PAGED_PROMPTS), new_tokens=PAGED_NEW,
         matmul_weight_bytes=matmul_bytes, runs=runs, int8_vs_bf16=agreement,
         paged_vs_dense={"engine": PAGED_VS_DENSE, "checks": vs_checks,
                         "identical": sum(a == b for a, b in zip(vs["dense"], vs["paged"])),
                         "tick_16_slots": vs_tick},
         spec={"spec_k": 4, "requests": len(spec_reqs), "prompt_len": len(spec_reqs[0].prompt),
               "stats": spec[4]["stats"], "decode_ticks": spec[4]["decode_ticks"],
               "decode_ticks_without": spec[0]["decode_ticks"], "seconds": spec[4]["seconds"],
               "seconds_without": spec[0]["seconds"],
               "decode_tokens_per_sec": spec[4]["decode_tokens_per_sec"],
               "decode_tokens_per_sec_without": spec[0]["decode_tokens_per_sec"],
               "tick_ms_drafts_4_vs_none": verify_tick, "checks": spec_checks,
               "near_tie_rule": NEAR_TIE})


# -- HF weights in and out, the training job's faults and its supervisor -----

HF_NEW = 32
HF_PROMPTS = (64, 300, 150, 500)
def rss_bytes() -> int:
    """This process's resident bytes now (/proc/self/statm; the card's
    machine has no VmHWM in /proc/self/status)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@contextlib.contextmanager
def rss_peak_sampler():
    """Yields a dict that holds, on exit, the resident bytes before the
    block and the peak during it, sampled every 2 ms."""
    out = {"before": rss_bytes()}
    out["peak"], done = out["before"], threading.Event()

    def sample():
        while not done.is_set():
            out["peak"] = max(out["peak"], rss_bytes())
            time.sleep(0.002)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        done.set()
        thread.join()
        out["peak"] = max(out["peak"], rss_bytes())


def bf16_tree(sp) -> dict:
    """phase_serve's weights as one bfloat16 tree (the serving copy keeps
    the embedding and the norms in float32)."""
    return tree_map(lambda t: t if t.dtype == torch.bfloat16 else t.to(torch.bfloat16), sp)


def greedy_streams(params, cfg, prompts) -> list[list[int]]:
    eng = InferenceEngine(params, cfg, num_slots=len(prompts), max_len=1024,
                          chunk_size=512, device="cuda")
    reqs = [GenRequest(prompt=p, max_new_tokens=HF_NEW, seed=i) for i, p in enumerate(prompts)]
    tickets = drive(Scheduler(eng), reqs, per_tick=len(reqs))
    out = [t.result["tokens"] for t in tickets]
    del eng
    torch.cuda.empty_cache()
    return out


def write_hf_bf16(params, cfg: LlamaConfig, out_dir: Path,
                  max_shard_bytes: int = 5 * 10**9) -> list[str]:
    """An HF checkpoint in bf16, as Meta ships Llama-3 (the package's
    writer exports float32, as the JAX package's does): the export plan's
    tensors cast back to bf16 (exact, since they were bf16), packed in
    order into shards of at most max_shard_bytes, the index when there
    is more than one shard, and config.json. Returns the file names."""
    shards: list[list] = [[]]
    acc = 0
    for key, _, shape, produce in _export_plan(params, cfg, include_tied_head=False):
        nbytes = 2 * math.prod(shape)
        if shards[-1] and acc + nbytes > max_shard_bytes:
            shards.append([])
            acc = 0
        shards[-1].append((key, torch.bfloat16, shape, lambda p=produce: p().bfloat16()))
        acc += nbytes
    out_dir.mkdir(parents=True, exist_ok=True)
    n = len(shards)
    names = (["model.safetensors"] if n == 1
             else [f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i in range(n)])
    weight_map, total = {}, 0
    for name, entries in zip(names, shards):
        total += safetensors_io.write_file(str(out_dir / name), entries, {"format": "pt"})
        weight_map.update(dict.fromkeys((e[0] for e in entries), name))
    if n > 1:
        index = {"metadata": {"total_size": total}, "weight_map": weight_map}
        (out_dir / "model.safetensors.index.json").write_text(json.dumps(index, indent=1))
        names.append("model.safetensors.index.json")
    (out_dir / "config.json").write_text(json.dumps(hf_config(cfg, "bfloat16"), indent=1))
    return names


def phase_hf_8b(sp, mem: Path, smi: str) -> dict:
    """Llama-3-8B at full depth (32 layers) in bf16, written as an HF
    checkpoint in Meta's layout (4 safetensors shards, the index, a
    config.json from the LLAMA3_8B preset) in ``mem``, and imported back
    with from_hf_pretrained onto the card: its seconds, GB/s and device
    bytes, and the host RSS it adds (sampled; it must stay under one
    stacked leaf plus one layer tensor); every leaf must equal the written
    one and the engine's greedy streams on the import must equal those on
    the originals. Returns the first layer's bf16 weights (the faults_8b
    fixture)."""
    cfg = dataclasses.replace(LLAMA3_8B, param_dtype="bfloat16")
    hf_dir = mem / "hf_8b"
    ref = bf16_tree(sp)
    nbytes = tree_bytes(ref)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = write_hf_bf16(ref, cfg, hf_dir)
    shards = sorted(hf_dir.glob("model-*.safetensors"))
    write_s = time.perf_counter() - t0
    want = [f"model-0000{i}-of-00004.safetensors" for i in range(1, 5)]
    if [p.name for p in shards] != want or "model.safetensors.index.json" not in written:
        fail("hf_8b", f"wrote {written}, want Meta's layout {want} and the index")
    file_bytes = sum(p.stat().st_size for p in shards)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    device_before = torch.cuda.memory_allocated()
    with rss_peak_sampler() as rss:
        t0 = time.perf_counter()
        imported = from_hf_pretrained(str(hf_dir), cfg, "cuda")
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
    import_device_peak = torch.cuda.max_memory_allocated() - device_before
    named_ref, named_imp = named_leaves(ref), named_leaves(imported)
    bad = [n for (n, a), (_, b) in zip(named_ref, named_imp)
           if a.shape != b.shape or a.dtype != b.dtype or not b.is_contiguous()
           or not torch.equal(a, b)]
    if bad or [n for n, _ in named_ref] != [n for n, _ in named_imp]:
        fail("hf_8b", f"imported leaves differ from the written ones: {bad[:5]}")
    prompts = random_prompts(cfg, HF_PROMPTS, seed=5)
    streams_ref = greedy_streams(ref, cfg, prompts)
    streams_imp = greedy_streams(imported, cfg, prompts)
    device_peak = torch.cuda.max_memory_allocated()
    if streams_ref != streams_imp or any(len(s) != HF_NEW for s in streams_imp):
        fail("hf_8b", "greedy streams on the imported weights differ from the originals")
    # the host-memory bound: one stacked leaf in the param dtype plus one
    # layer tensor (the leaves are built on the card, so the import's own
    # rise is one tensor's map)
    largest_leaf = max(t.numel() * t.element_size() for t in tree_leaves(imported))
    layer_tensor = cfg.hidden_size * cfg.intermediate_size * 2
    rss_rise = rss["peak"] - rss["before"]
    if rss_rise >= largest_leaf + layer_tensor:
        fail("hf_8b", f"the import raised host RSS by {rss_rise} bytes, over the bound "
                      f"{largest_leaf + layer_tensor}")
    fixture = {"embed": ref["embed"].clone(), "final_norm": ref["final_norm"].clone(),
               "lm_head": ref["lm_head"].clone(),
               "layers": {k: v[:1].clone() for k, v in ref["layers"].items()}}
    del imported, ref
    torch.cuda.empty_cache()
    shutil.rmtree(hf_dir)
    emit(phase="hf_8b", ok=True, nvidia_smi=smi, layers=cfg.num_hidden_layers,
         param_bytes=nbytes, file_bytes=file_bytes, files=written, write_s=write_s,
         write_gb_per_s=file_bytes / write_s / 1e9,
         files_in=str(mem), import_s=import_s,
         import_gb_per_s=file_bytes / import_s / 1e9, host_rss_before_import_bytes=rss["before"],
         host_peak_rss_bytes=rss["peak"], host_rss_rise_bytes=rss_rise,
         rss_bound_bytes=largest_leaf + layer_tensor, largest_leaf_bytes=largest_leaf,
         import_device_peak_bytes=import_device_peak,
         leaves_equal=len(named_imp), greedy_requests=len(prompts), new_tokens=HF_NEW,
         streams_identical=True, device_peak_two_copies_and_cache_bytes=device_peak)
    return fixture


FAULTS_ROUNDS = 5
# the watchdog calls no silence under its floor a stall (30 s, as in the
# JAX package) and looks every poll_s (2 s): the injected stall outlasts both
WATCH = WatchdogConfig()
STALL_S = WATCH.min_stall_s + 2 * WATCH.poll_s
# nan_params fires at round 2's top; the stall in round 3's prefetch,
# after round 2's heartbeat; the straggle inside round 4 (2 s, far under
# the floor), and round 5 restores the worker
FAULT_PLAN_8B = [
    {"kind": "nan_params", "step": 3, "worker": 1},
    {"kind": "io_error", "step": 1, "op": "save", "count": 2},
    {"kind": "stall", "step": 3, "seconds": STALL_S},
    {"kind": "straggler", "step": 7, "worker": 0, "seconds": 2.0, "rounds": 1},
]


def faults_8b_args(hf_dir: Path, work: Path) -> list[str]:
    return ["--init-hf", str(hf_dir), "--dtype", "bfloat16", "--attention", "flash",
            "--seed", "0", "--batch-size", "2", "--per-device-batch-size", "1",
            "--seq-length", "2048", "--warmup-steps", "1", "--inner-steps", "2",
            "--total-steps", str(2 * FAULTS_ROUNDS), "--num-workers", "2",
            "--quarantine-nonfinite", "--straggler-factor", "1.5",
            "--watch-stall-factor", "2", "--metrics-port", "0",
            "--status-file", str(work / "status.json"),
            "--checkpoint-dir", str(work / "ck"), "--checkpoint-every", "1000",
            "--log-dir", str(work / "runs"), "--run-name", "faults"]


def wait_for(pred, proc: subprocess.Popen, what: str, log: Path, timeout: float = 600):
    t0 = time.perf_counter()
    while not pred():
        if proc.poll() is not None or time.perf_counter() - t0 > timeout:
            fail(what, f"the child ended (rc {proc.returncode}) or stalled: "
                       f"{log.read_text()[-3000:]}")
        time.sleep(0.02)


def phase_faults_8b(fixture: dict, mem: Path, smi: str) -> dict:
    """Train from an HF checkpoint under a fault plan, then export: one
    CLI run at the train phase's 8B width (1 layer) from a bf16 HF
    fixture, with quarantine, the straggler policy, a /metrics port, a
    status file and FAULT_PLAN_8B; its first step against an in-process
    train() on the same weights held in memory (bit for bit); its fault,
    retry, alarm, elastic and goodput records; a /metrics scrape against
    the JSONL; then `export-hf --max-shard-gb 2` of its checkpoint,
    re-imported and held leaf by leaf against the checkpoint's snapshot.
    Returns the CLI run's kernel launches by shape (``kernel_shapes``)."""
    work = mem / "faults_8b"
    hf_dir = work / "hf"
    model = dataclasses.replace(LLAMA3_8B, num_hidden_layers=1)
    t0 = time.perf_counter()
    write_hf_bf16(fixture, model, hf_dir)
    fixture_bytes = os.path.getsize(hf_dir / "model.safetensors")
    fixture_s = time.perf_counter() - t0
    plan = work / "plan.json"
    plan.write_text(json.dumps({"faults": FAULT_PLAN_8B}))
    args = faults_8b_args(hf_dir, work)
    jsonl, log = work / "runs" / "faults.jsonl", work / "faults.log"

    def records() -> list[dict]:
        return read_jsonl_records(str(jsonl))[0] if jsonl.exists() else []

    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen([sys.executable, "-m", "nanodiloco_tpu_torch", *args,
                                 "--fault-plan", str(plan)],
                                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    try:
        last = 2 * FAULTS_ROUNDS
        wait_for(lambda: any(r.get("goodput") and r.get("step") == last for r in records()),
                 proc, "faults_8b", log)
        port = int(re.search(r"telemetry: port (\d+)", log.read_text()).group(1))
        code, body = http_get(f"http://127.0.0.1:{port}/metrics")
        scraped = parse_metrics_text(body)
        recs = records()
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    run_s = time.perf_counter() - t0
    text = log.read_text()
    if rc != 0:
        fail("faults_8b", f"the CLI run exited {rc}: {text[-3000:]}")
    summary = json.loads(text.strip().splitlines()[-1])
    final = read_jsonl_records(str(jsonl))[0]
    steps = [r for r in final if "loss" in r]
    # the scrape, taken once the last round's records were written
    last_step = [r for r in recs if "loss" in r][-1]
    last_gp = [r["goodput"] for r in recs if r.get("goodput")][-1]
    scrape = {"loss": scraped.get("nanodiloco_loss"), "jsonl_loss": last_step["loss"],
              "step": scraped.get("nanodiloco_step"), "jsonl_step": last_step["step"],
              "goodput_fraction": scraped.get("nanodiloco_goodput_fraction"),
              "jsonl_goodput_fraction": last_gp["goodput_fraction"],
              "outer_syncs": scraped.get("nanodiloco_outer_syncs_total"),
              "faults": scraped.get("nanodiloco_faults_total")}
    if (code != 200 or scrape["loss"] != scrape["jsonl_loss"]
            or scrape["step"] != scrape["jsonl_step"]
            or scrape["goodput_fraction"] != scrape["jsonl_goodput_fraction"]
            or scrape["outer_syncs"] != FAULTS_ROUNDS):
        fail("faults_8b", f"/metrics disagrees with the JSONL: {scrape}")
    fault_recs = {r["fault"]: r for r in final if r.get("fault")}
    if set(fault_recs) != {"nan_params", "io_error", "stall", "straggler"}:
        fail("faults_8b", f"fault records {sorted(fault_recs)}")
    syncs = {r["step"]: r for r in steps if r["outer_synced"]}
    nan_sync = syncs[4]
    if nan_sync.get("quarantined_workers") != 1 or fault_recs["nan_params"]["worker"] != 1:
        fail("faults_8b", f"the NaN round's sync quarantined {nan_sync.get('quarantined_workers')}")
    if not all(math.isfinite(r["loss"]) for r in steps):
        fail("faults_8b", f"non-finite losses: {[r['loss'] for r in steps]}")
    retries = [r for r in final if r.get("retry") == "ckpt_save"]
    latest = CheckpointManager(str(work / "ck")).latest_step
    if len(retries) != 2 or latest != last or any(r.get("alarm") == "ckpt_save_failed"
                                                  for r in final):
        fail("faults_8b", f"save: {len(retries)} retries, checkpoint at {latest}")
    # one alarm for the stall, after round 2's heartbeat; the only other a
    # sentinel may raise is the final save's (40.6 GB, written while no
    # round beats, for longer than the floor)
    stall_alarms = [r for r in final if r.get("alarm") == "stall"]
    after_stall = [r for r in stall_alarms if r["step"] == 4]
    if (len(after_stall) != 1 or after_stall[0]["limit_s"] != WATCH.min_stall_s
            or any(r["step"] not in (4, last) for r in stall_alarms)
            or len(stall_alarms) > 2):
        fail("faults_8b", f"want one stall alarm after the round-2 heartbeat at the "
                          f"{WATCH.min_stall_s} s floor: {stall_alarms}")
    elastic = [(r["elastic"], r["step"], r.get("worker")) for r in final if r.get("elastic")]
    if elastic != [("straggler_demote", 8, 0), ("straggler_restore", 10, 0)]:
        fail("faults_8b", f"elastic records {elastic}")
    gp = [r["goodput"] for r in final if r.get("goodput")][-1]
    cause_sum = sum(gp[f"{c}_s"] for c in GOODPUT_CAUSES)
    if (not gp.get("final") or abs(cause_sum - gp["elapsed_s"]) > 0.01 * gp["elapsed_s"]
            or not 1.9 <= gp["straggler_wait_s"] <= 2.5
            or not STALL_S - 2 <= gp["stall_s"] <= STALL_S + 0.5):
        fail("faults_8b", f"goodput snapshot {gp} (causes sum to {cause_sum})")
    launches = summary["kernel_launches"]
    if min(launches.values()) == 0:
        fail("faults_8b", f"a kernel was not launched in the fault run: {launches}")
    cost = next(r["cost_analysis"] for r in final if r.get("cost_analysis"))
    tps = summary["tokens_per_sec_after_first_round"]

    # the first step against an in-process train() on the same weights
    with contextlib.ExitStack() as stack:
        import nanodiloco_tpu_torch.parallel.diloco as diloco_mod

        held = tree_map(lambda t: t.to(torch.float32), fixture)
        stack.callback(setattr, diloco_mod, "init_params", diloco_mod.init_params)
        diloco_mod.init_params = lambda generator, cfg, device: held
        tcfg = cli.config_from_args(cli.parse_args(args))
        tcfg = dataclasses.replace(tcfg, init_hf=None, fit_vocab=False, total_steps=2,
                                   checkpoint_dir=None, metrics_port=None, status_file=None,
                                   log_dir=str(work / "inproc"), run_name="inproc",
                                   quiet=True)
        ref = train(tcfg, device="cuda")
        del held
    ref_first = read_jsonl_records(str(work / "inproc" / "inproc.jsonl"))[0]
    ref_loss = next(r["loss"] for r in ref_first if r.get("step") == 1 and "loss" in r)
    if steps[0]["loss"] != ref_loss:
        fail("faults_8b", f"first-step loss {steps[0]['loss']!r} != in-process {ref_loss!r}")
    del ref
    torch.cuda.empty_cache()

    # export the checkpoint's snapshot, re-import it, hold it leaf by leaf
    out = work / "export"
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["export-hf", "--checkpoint-dir", str(work / "ck"), "--out", str(out),
                  "--max-shard-gb", "2"])
    exported = sorted(p.name for p in out.iterdir())
    export_s = time.perf_counter() - t0
    export_bytes = sum(p.stat().st_size for p in out.glob("*.safetensors"))
    ck_cfg, _, snapshot = cli._load_checkpoint_snapshot(str(work / "ck"), None)
    back = from_hf_pretrained(str(out), ck_cfg, "cuda")
    diff = [n for (n, a), (_, b) in zip(named_leaves(snapshot), named_leaves(back))
            if not torch.equal(a.to("cuda"), b)]
    n_shards = len(list(out.glob("model-*-of-*.safetensors")))
    if diff or n_shards != 3 or not (out / "model.safetensors.index.json").exists():
        fail("faults_8b", f"export: {n_shards} shards, leaves differing {diff[:5]}")
    del back, snapshot
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    emit(phase="faults_8b", ok=True, nvidia_smi=smi, fixture_bytes=fixture_bytes,
         fixture_write_s=fixture_s, cli_run_s=run_s, plan=FAULT_PLAN_8B,
         first_step_loss=steps[0]["loss"], in_process_first_step_loss=ref_loss,
         losses=[r["loss"] for r in steps], nan_sync=nan_sync.get("quarantined_workers"),
         fault_records=list(fault_recs.values()), save_retries=len(retries),
         checkpoint_step=latest, stall_alarms=stall_alarms, elastic=elastic,
         goodput=gp, goodput_cause_sum_s=cause_sum, scrape=scrape,
         cost_analysis=cost, tokens_per_sec=summary["tokens_per_sec"],
         tokens_per_sec_after_first_round=tps,
         mfu_analytic=analytic_mfu(cost, tps), alarms=summary["alarms"],
         launches=launches, export_files=exported, export_bytes=export_bytes,
         export_s=export_s, reimport_leaves_equal=True)
    return summary["kernel_shapes"]


SUPERVISE_ROUNDS = 8


def child_pids(pid: int) -> list[int]:
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                stat = open(f"/proc/{entry}/stat").read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                out.append(int(entry))
    return out


def phase_supervise_small(mem: Path, smi: str) -> None:
    """`supervise` over the CLI at the resume phase's size: a crash fault at
    step 5 (exit 71, restart from the step-4 checkpoint after a backoff),
    then SIGTERM to the second child once it has trained past its resume
    (exit 75, an immediate restart), then the third child finishes. The
    final snapshot must equal an uninterrupted run's, run beside it, bit
    for bit; `report faults` and `report goodput` must show the three
    lifetimes and restart_downtime > 0."""
    work = mem / "supervise"
    work.mkdir(parents=True)
    model_file = work / "model.json"
    model_file.write_text(json.dumps(RESUME_MODEL.to_dict()))
    total = 2 * SUPERVISE_ROUNDS
    plan = work / "plan.json"
    plan.write_text(json.dumps({"faults": [{"kind": "crash", "step": 5}]}))

    def args(name: str) -> list[str]:
        return ["--llama-config-file", str(model_file), "--seed", "0", "--batch-size", "2",
                "--per-device-batch-size", "1", "--seq-length", "512", "--warmup-steps", "1",
                "--inner-steps", "2", "--total-steps", str(total), "--num-workers", "2",
                "--checkpoint-dir", str(work / f"ck_{name}"), "--checkpoint-every", "2",
                "--log-dir", str(work / "runs"),
                "--run-name", name, "--quiet"]

    jsonl = work / "runs" / "sup.jsonl"

    def records() -> list[dict]:
        return read_jsonl_records(str(jsonl))[0] if jsonl.exists() else []

    log, twin_log = work / "sup.log", work / "twin.log"
    t0 = time.perf_counter()
    with open(twin_log, "w") as out:
        twin = subprocess.Popen([sys.executable, "-m", "nanodiloco_tpu_torch", *args("twin")],
                                cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
    with open(log, "w") as out:
        # its own process group: a failed check kills the supervisor's
        # child with it
        sup = subprocess.Popen(
            [sys.executable, "-m", "nanodiloco_tpu_torch", "supervise", "--backoff-base",
             "0.5", "--events-jsonl", str(work / "events.jsonl"), "--",
             *args("sup"), "--fault-plan", str(plan)],
            cwd=ROOT, stdout=out, stderr=subprocess.STDOUT, start_new_session=True)
    try:
        # the second lifetime: resumed, and one round past its resume
        def second_running() -> bool:
            recs = records()
            resumes = [i for i, r in enumerate(recs) if "resume" in r]
            return bool(resumes) and any(r.get("outer_synced") for r in recs[resumes[-1]:])

        wait_for(second_running, sup, "supervise_small", log)
        kids = child_pids(sup.pid)
        if len(kids) != 1:
            fail("supervise_small", f"supervisor children {kids}")
        os.kill(kids[0], signal.SIGTERM)
        rc = sup.wait(timeout=600)
        twin_rc = twin.wait(timeout=600)
    finally:
        if sup.poll() is None:
            os.killpg(sup.pid, signal.SIGKILL)
        if twin.poll() is None:
            twin.kill()
    seconds = time.perf_counter() - t0
    if rc != 0 or twin_rc != 0:
        fail("supervise_small", f"supervise exited {rc}, the twin {twin_rc}: "
                                f"{log.read_text()[-2000:]} {twin_log.read_text()[-1000:]}")
    events = [json.loads(line) for line in open(work / "events.jsonl")]
    kinds = [e["event"] for e in events]
    crash = [e for e in events if e["event"] == "crash"]
    if (kinds != ["launch", "crash", "backoff", "launch", "preempt_resume", "launch",
                  "finished"] or crash[0]["exit_code"] != 71):
        fail("supervise_small", f"supervisor events {events}")
    recs = records()
    resumes = [r for r in recs if "resume" in r]
    preempts = [r for r in recs if r.get("preempt")]
    if ([r["restart_count"] for r in resumes] != [1, 2] or resumes[0]["resume"] != 4
            or [(p["preempt"], p["exit_code"]) for p in preempts] != [("preempt", 75)]):
        fail("supervise_small", f"resume records {resumes}, preempt records {preempts}")
    snap = CheckpointManager(str(work / "ck_sup")).restore_raw(total, only={"snapshot"})
    twin_snap = CheckpointManager(str(work / "ck_twin")).restore_raw(total, only={"snapshot"})
    diff = [n for (n, a), (_, b) in zip(named_leaves(snap["snapshot"]),
                                        named_leaves(twin_snap["snapshot"]))
            if not torch.equal(a, b)]
    if diff:
        fail("supervise_small", f"the supervised run's final snapshot differs from the "
                                f"uninterrupted one at {diff[:5]}")
    faults_out, goodput_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(faults_out):
        cli.main(["report", "faults", str(jsonl)])
    with contextlib.redirect_stdout(goodput_out):
        cli.main(["report", "goodput", str(jsonl), "--json"])
    goodput = json.loads(goodput_out.getvalue())
    if (goodput["lifetimes"] != 3 or not goodput["restart_downtime_s"] > 0
            or "crash" not in faults_out.getvalue() or "resume" not in faults_out.getvalue()):
        fail("supervise_small", f"report: {faults_out.getvalue()} {goodput}")
    shutil.rmtree(work)
    emit(phase="supervise_small", ok=True, nvidia_smi=smi, seconds=seconds,
         rounds=SUPERVISE_ROUNDS, events=events, exit_codes=[71, 75],
         restart_count=resumes[-1]["restart_count"], snapshot_bit_identical=True,
         report_faults=faults_out.getvalue().splitlines(), goodput=goodput)


# -- the serving fleet (phases 16-17) ------------------------------------------

FLEET_NEW = 64
FLEET_DRILL_NEW = 32
FLEET_SLOTS = 4


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def fire(url, docs: list[dict], concurrency: int, timeout: float = 300.0) -> list:
    """POST every doc to ``url``/v1/generate (or doc i to ``url[i %
    len(url)]``) from ``concurrency`` client threads: per doc (code,
    reply, client seconds), or ("dropped", error) when the client's
    connection failed (a dropped stream)."""
    urls = [url] if isinstance(url, str) else list(url)

    def one(i_doc):
        i, doc = i_doc
        t0 = time.perf_counter()
        try:
            code, out = http_post_json(urls[i % len(urls)] + "/v1/generate", doc,
                                       timeout=timeout)
        except Exception as e:  # a transport failure IS a dropped stream
            return "dropped", f"{type(e).__name__}: {e}"
        return code, out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=concurrency) as pool:
        return list(pool.map(one, enumerate(docs)))


def pctl(vals, p: float):
    vals = sorted(v for v in vals if v is not None)
    return vals[min(len(vals) - 1, max(0, math.ceil(p * len(vals)) - 1))] if vals else None


def fleet_docs(prompts, new: int, tag: str, n: int) -> list[dict]:
    return [{"token_ids": list(prompts[i % len(prompts)]), "max_new_tokens": new,
             "temperature": 0.0, "stop": False, "prefix_cache": False,
             "request_id": f"{tag}-{i}"} for i in range(n)]


def fleet_streams(sp, cfg, prompts, refs, docs, results, phase: str, what: str) -> dict:
    """Every reply must be a 200 whose greedy stream equals the solo
    stream of its prompt (a prefix of it for a shorter request) or parts
    from it first at a near-tie; returns the partings and the clients'
    seconds."""
    partings, walls = [], []
    for doc, res in zip(docs, results):
        if res[0] == "dropped":
            fail(phase, f"{what}: request {doc['request_id']} dropped: {res[1]}")
        code, out, wall = res
        if code != 200:
            fail(phase, f"{what}: request {doc['request_id']} answered {code}: {out}")
        i = next(j for j, p in enumerate(prompts) if list(p) == doc["token_ids"])
        stream, ref = out["token_ids"], refs[i][:doc["max_new_tokens"]]
        if len(stream) != doc["max_new_tokens"]:
            fail(phase, f"{what}: request {doc['request_id']} gave {len(stream)} tokens")
        if stream != ref:
            req = GenRequest(prompt=tuple(prompts[i]), max_new_tokens=len(stream))
            partings.append({"request_id": doc["request_id"],
                             **near_tie(sp, cfg, req, ref, stream, phase, what)})
        walls.append(wall)
    return {"partings": partings, "client_s": walls}


def replica(eng, *, role: str = "both", tracer=None):
    sched = Scheduler(eng, tracer=tracer, park_ttl_s=60.0)
    srv = ServeServer(sched, port=0, host="127.0.0.1", max_new_tokens_cap=1024,
                      role=role).start()
    return sched, srv


def wait_until(pred, phase: str, what: str, timeout: float = 60.0) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > timeout:
            fail(phase, f"timed out after {timeout} s waiting for {what}")
        time.sleep(0.01)
    return time.perf_counter() - t0


def stop_loop(server: ServeServer, sched: Scheduler) -> None:
    """The replica's engine loop dies (its next tick raises): /healthz
    answers 503 from then on."""
    def dead():
        raise RuntimeError("engine loop stopped by the fleet drill")
    sched.tick = dead
    wait_until(lambda: not server.loop_alive(), "fleet_8b", "the engine loop to stop")


def hedged(router_tr) -> set:
    """Request ids with a hedge attempt among the router's forward spans
    (a forward span is recorded when its attempt's answer comes back)."""
    return {e["args"]["request_id"] for e in router_tr.events
            if e["name"] == "forward" and e.get("args", {}).get("hedge")}


def hedge_fates(router_tr, replica_tr: dict, cancels: dict) -> dict:
    """What became of each hedged request's losing attempt on its
    replica, by request id. "cancelled": the replica's own outcome, or
    the replica took the router's cancel while the attempt was in flight
    (it then stops at its next tick, or has just produced its last
    token). "done first": its run ended before the cancel reached the
    replica, or, where the router sent none, before the winner's answer.
    "never ran": the replica has no run of it (the chaos proxy answered
    in its place). "ran on": its run ended after that, the fault. The
    spans of the router and the replicas and the cancels' arrival times
    are on one clock, time.monotonic."""
    route = {e["args"]["request_id"]: e for e in router_tr.events if e["name"] == "route"}
    fates = {}
    for rid in hedged(router_tr):
        winner = route[rid]["args"].get("served_by") if rid in route else None
        if winner not in replica_tr:
            fates[rid] = "no winner"
            continue
        loser = next(n for n in replica_tr if n != winner)
        runs = [e for e in replica_tr[loser].events
                if e.get("args", {}).get("request_id") == rid and "outcome" in e["args"]]
        t_cancel, code = cancels[loser].get(rid, (None, None))
        t_stop = t_cancel if t_cancel is not None else route[rid]["t0"] + route[rid]["dur"]
        if not runs:
            fates[rid] = "never ran"
        elif runs[-1]["args"]["outcome"] == "cancelled" or code == 200:
            fates[rid] = "cancelled"
        elif runs[-1]["t0"] + runs[-1]["dur"] <= t_stop:
            fates[rid] = "done first"
        else:
            fates[rid] = "ran on"
    return fates


def log_cancels(server: ServeServer) -> dict:
    """Record when each POST /v1/cancel reached ``server`` and its answer
    code, by request id."""
    log: dict = {}
    handle = server.handle_cancel

    def logged(doc):
        code, body = handle(doc)
        log[doc.get("request_id")] = (time.monotonic(), code)
        return code, body
    server.handle_cancel = logged
    return log


def phase_fleet_8b(mem: Path, smi: str) -> None:
    """Serve's Llama-3-8B weights (32 layers, bf16, seed 0, made again on
    the card) behind the port's fleet: two replicas (r0 paged, r1 dense,
    4 slots x 1024 each) over one params tree, each behind the port's
    HTTP server. (1) 16 greedy requests (prompts of 64-600 tokens, 64
    new) straight to the replicas, then through the FleetRouter's front
    door: every stream equals solo generate() or parts from it first at
    a near-tie, each token is the training forward's argmax (through B1)
    within the same tolerance, and both replicas serve; the router's
    added latency from 8 sequential one-token requests each way, with
    obs-watch scraping both replicas' /metrics throughout. (2) chaos:
    DRILL_PLAN through a ChaosProxy in front of r1 (its slow drip and
    500s), a lone long request hedged after 30% of its time alone, 8
    requests in pairs under the same hedge delay:
    no client connection drops, every stream solo's or a near-tie, the
    breaker opens on r1, each hedge's loser is cancelled on its replica,
    or ended there before the cancel came, or never reached it (from the
    router's and the replicas' spans and the cancels' arrival times:
    `hedge_fates`), and r0's block pool is whole again; then r1's engine
    loop stops, r1 is ejected and the fleet answers on r0. (3) disagg:
    a prefill and a decode replica behind the DisaggRouter: every stream
    crosses the KV ship and is solo's or a near-tie; ship bytes per
    prompt token, ship seconds, TTFT with and without the tiers. (4)
    the router's and both tiers' trace shards through `report
    merge-trace` and `report trace`: the critical path's segments sum to
    the request's wall time; `report timeseries` and `report dashboard`
    of obs-watch's series."""
    from nanodiloco_tpu_torch.fleet import DisaggRouter, FleetRouter, Replica
    from nanodiloco_tpu_torch.fleet.chaos import DRILL_PLAN, ChaosPlan, ChaosProxy
    from nanodiloco_tpu_torch.obs.tracer import SpanTracer

    phase, t_phase = "fleet_8b", time.perf_counter()
    work = mem / "fleet"
    work.mkdir()
    cfg = LLAMA3_8B
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    sp = serve_weights(cfg)
    prompts = random_prompts(cfg, SERVE_PROMPTS, seed=2)
    t0 = time.perf_counter()
    refs = [solo(sp, cfg, GenRequest(prompt=p, max_new_tokens=FLEET_NEW), "cuda")
            for p in prompts]
    solo_s = time.perf_counter() - t0
    eng0 = InferenceEngine(sp, cfg, num_slots=FLEET_SLOTS, max_len=1024, chunk_size=512,
                           kv_block_size=16, prefix_cache_tokens=0, device="cuda")
    eng1 = InferenceEngine(sp, cfg, num_slots=FLEET_SLOTS, max_len=1024, chunk_size=512,
                           prefix_cache_tokens=0, device="cuda")
    # the replicas' spans (time.monotonic, the schedulers' clock) say
    # what became of each hedge loser
    rep_tr = {name: SpanTracer(clock=time.monotonic, process_name=f"serve {name}")
              for name in ("r0", "r1")}
    (sched0, s0), (sched1, s1) = (replica(eng0, tracer=rep_tr["r0"]),
                                  replica(eng1, tracer=rep_tr["r1"]))
    cancels = {"r0": log_cancels(s0), "r1": log_cancels(s1)}
    url0, url1 = f"http://127.0.0.1:{s0.port}", f"http://127.0.0.1:{s1.port}"
    series, alerts = work / "series.jsonl", work / "alerts.jsonl"
    watch_log = open(work / "obs_watch.log", "w")
    watch = subprocess.Popen(
        [sys.executable, "-m", "nanodiloco_tpu_torch", "obs-watch", "--target", f"r0={url0}",
         "--target", f"r1={url1}", "--interval-s", "0.5", "--series-jsonl", str(series),
         "--alerts-jsonl", str(alerts), "--ttft-p95-max", "30", "--kv-blocks-free-min", "1",
         "--quiet"], cwd=ROOT, stdout=watch_log, stderr=subprocess.STDOUT)
    proxy = router = None
    out: dict = {}
    try:
        load = fleet_docs(prompts, FLEET_NEW, "load", 16)
        direct = fire([url0, url1], load, 2 * FLEET_SLOTS)
        d_check = fleet_streams(sp, cfg, prompts, refs, load, direct, phase, "direct")
        router = FleetRouter([Replica("r0", url0), Replica("r1", url1)], host="127.0.0.1",
                             health_interval_s=0.2, hedge_after_s=0, quiet=True,
                             events_jsonl=str(work / "router.jsonl")).start()
        rurl = f"http://127.0.0.1:{router.port}"
        wait_until(lambda: router.fleet_stats()["replicas_ready"] == 2, phase, "2 ready")
        routed = fire(rurl, load, 2 * FLEET_SLOTS)
        r_check = fleet_streams(sp, cfg, prompts, refs, load, routed, phase, "routed")
        served = sorted({r[1]["served_by"] for r in routed})
        if served != ["r0", "r1"]:
            fail(phase, f"the router sent every request to {served}")
        tf = [teacher_forcing(sp, cfg, GenRequest(prompt=p, max_new_tokens=FLEET_NEW),
                              routed[i][1]["token_ids"]) for i, p in enumerate(prompts)]
        if not all(t["ok"] for t in tf):
            fail(phase, "a routed greedy token is not the training forward's argmax within "
                        "the near-tie tolerance")
        one = [{"token_ids": list(prompts[0]), "max_new_tokens": 1, "temperature": 0.0,
                "stop": False, "prefix_cache": False}] * 8
        hop = {name: [r[2] for r in fire(u, one, 1)] for name, u in (("direct", url0),
                                                                       ("router", rurl))}
        out["fleet"] = {
            "requests": len(load), "served_by": served, "partings": r_check["partings"],
            "direct_partings": d_check["partings"],
            "teacher_forcing_exact_share": sum(t["exact"] for t in tf) / sum(t["n"] for t in tf),
            "client_s_p50": {"direct": pctl(d_check["client_s"], 0.5),
                             "router": pctl(r_check["client_s"], 0.5)},
            "ttft_p50_s": {"direct": pctl([r[1]["timing"]["ttft_s"] for r in direct], 0.5),
                           "router": pctl([r[1]["timing"]["ttft_s"] for r in routed], 0.5)},
            "ttft_p95_s": {"direct": pctl([r[1]["timing"]["ttft_s"] for r in direct], 0.95),
                           "router": pctl([r[1]["timing"]["ttft_s"] for r in routed], 0.95)},
            "one_token_p50_s": {k: pctl(v, 0.5) for k, v in hop.items()},
            "router_added_s_p50": pctl(hop["router"], 0.5) - pctl(hop["direct"], 0.5),
        }
        router.stop()

        # (2) chaos: DRILL_PLAN on r1's wire. The hedge delay is 30% of
        # the lone long request's own time, alone on r0
        lone = fleet_docs([prompts[1]], FLEET_NEW, "hedge", 1)  # the 600-token prompt
        lone_s = fire(url0, lone, 1)[0][2]
        plan = ChaosPlan.from_dict(DRILL_PLAN)
        proxy = ChaosProxy(url1, plan, "r1", host="127.0.0.1").start()
        router_tr = SpanTracer(clock=time.monotonic, process_name="router")
        router = FleetRouter([Replica("r0", url0), Replica("r1", proxy.url)], host="127.0.0.1",
                             tracer=router_tr,
                             health_interval_s=0.2, hedge_after_s=0.3 * lone_s,
                             retry_budget_min=20.0,
                             retry_budget_cap=40.0, breaker_window=4, breaker_min_samples=3,
                             breaker_failure_rate=0.5, breaker_open_s=600.0, quiet=True,
                             events_jsonl=str(work / "chaos.jsonl")).start()
        rurl = f"http://127.0.0.1:{router.port}"
        wait_until(lambda: router.fleet_stats()["replicas_ready"] == 2, phase, "2 ready")
        cancelled0 = sched0.stats()["cancelled"] + sched1.stats()["cancelled"]
        lone_res = fire(rurl, lone, 1)
        fleet_streams(sp, cfg, prompts, refs, lone, lone_res, phase, "hedged")
        if router.fleet_stats()["hedges"] != 1:
            fail(phase, f"the lone long request was not hedged: {router.fleet_stats()}")
        wait_until(lambda: sched0.stats()["cancelled"] + sched1.stats()["cancelled"]
                   == cancelled0 + 1, phase, "the losing hedge's cancel")
        drill = fleet_docs(prompts, FLEET_DRILL_NEW, "drill", 8)
        drill_res = []
        for k in range(0, len(drill), 2):
            drill_res += fire(rurl, drill[k:k + 2], 2)
        c_check = fleet_streams(sp, cfg, prompts, refs, drill, drill_res, phase, "chaos")
        stats = router.fleet_stats()
        events = [json.loads(line) for line in open(work / "chaos.jsonl")]
        opened = [e["replica"] for e in events if e.get("deploy_event") == "breaker_open"]
        if "r1" not in opened or stats["replicas_ejected"]:
            fail(phase, f"chaos: hedges {stats['hedges']}, breaker opened on {opened}, "
                        f"ejected {stats['replicas_ejected']}")
        wait_until(lambda: sched0.stats()["slots_busy"] == 0
                   and sched1.stats()["slots_busy"] == 0, phase, "idle slots")
        wait_until(lambda: eng0.kv_stats()["blocks_free"] == eng0.kv_stats()["num_blocks"],
                   phase, "r0's block pool to be whole")
        replica_cancels = (sched0.stats()["cancelled"] + sched1.stats()["cancelled"]
                           - cancelled0)
        wait_until(lambda: len(hedged(router_tr)) == router.fleet_stats()["hedges"], phase,
                   "every hedge attempt's answer")
        fates = hedge_fates(router_tr, rep_tr, cancels)
        if (len(fates) != router.fleet_stats()["hedges"]
                or any(f in ("ran on", "no winner") for f in fates.values())):
            fail(phase, f"hedge losers: {fates}")
        stop_loop(s1, sched1)
        eject_s = wait_until(lambda: router.state_of("r1")["status"] == "ejected", phase,
                             "r1's ejection")
        after = fleet_docs(prompts, FLEET_DRILL_NEW, "ejected", 2)
        after_res = fire(rurl, after, 2)
        fleet_streams(sp, cfg, prompts, refs, after, after_res, phase, "after the ejection")
        if {r[1]["served_by"] for r in after_res} != {"r0"}:
            fail(phase, "requests after r1's ejection were not all served by r0")
        stats = router.fleet_stats()
        out["chaos"] = {
            "plan": "DRILL_PLAN on r1's wire", "injected": plan.counts(),
            "lone_request_s": lone_s, "hedge_after_s": 0.3 * lone_s,
            "requests": len(drill) + 1 + len(after), "dropped": 0,
            "partings": c_check["partings"], "hedges": stats["hedges"],
            "hedge_wins": stats["hedge_wins"], "replica_cancels": replica_cancels,
            "hedge_losers": {f: sum(v == f for v in fates.values())
                             for f in sorted(set(fates.values()))},
            "retries": stats["retries"], "breaker_opened_on": opened,
            "breaker_state": stats["breaker_state"], "eject_seconds": eject_s,
            "blocks_free_r0": eng0.kv_stats()["blocks_free"],
            "num_blocks_r0": eng0.kv_stats()["num_blocks"],
            "fleet_goodput_fraction": stats["fleet_goodput_fraction"],
        }
    finally:
        if router is not None:
            router.stop()
        if proxy is not None:
            proxy.stop()
        s0.stop()
        s1.stop()
        watch.send_signal(signal.SIGTERM)
        try:
            watch.wait(timeout=60)
        except subprocess.TimeoutExpired:
            watch.kill()
        watch_log.close()
    if watch.returncode != 0:
        fail(phase, f"obs-watch exited {watch.returncode}: "
                    f"{(work / 'obs_watch.log').read_text()[-2000:]}")
    del eng0, eng1
    torch.cuda.empty_cache()

    # (3) disaggregated prefill/decode with traces on every tier
    tr = {name: SpanTracer(clock=time.monotonic, process_name=name)
          for name in ("router", "serve prefill", "serve decode")}
    pf_eng = InferenceEngine(sp, cfg, num_slots=FLEET_SLOTS, max_len=1024, chunk_size=512,
                             kv_block_size=16, prefix_cache_tokens=0, device="cuda")
    de_eng = InferenceEngine(sp, cfg, num_slots=FLEET_SLOTS, max_len=1024, chunk_size=512,
                             kv_block_size=16, prefix_cache_tokens=0, device="cuda")
    (_, pf), (_, de) = (replica(pf_eng, role="prefill", tracer=tr["serve prefill"]),
                        replica(de_eng, role="decode", tracer=tr["serve decode"]))
    router = DisaggRouter([Replica("pf", f"http://127.0.0.1:{pf.port}"),
                           Replica("d0", f"http://127.0.0.1:{de.port}")], host="127.0.0.1",
                          health_interval_s=0.2, tracer=tr["router"], quiet=True)
    router.start()
    try:
        rurl = f"http://127.0.0.1:{router.port}"
        wait_until(lambda: router.fleet_stats()["replicas_ready"] == 2, phase, "the tiers")
        docs = fleet_docs(prompts, FLEET_NEW, "disagg", len(prompts))
        res = fire(rurl, docs, FLEET_SLOTS)
        g_check = fleet_streams(sp, cfg, prompts, refs, docs, res, phase, "disagg")
        if any(r[1].get("disagg") != "handoff" for r in res):
            fail(phase, f"not every request was handed off: {[r[1].get('disagg') for r in res]}")
        d = router.fleet_stats()["disagg"]
        prompt_tokens = sum(len(p) for p in prompts)
        ship = [r[1]["handoff_phases"]["ship_s"] for r in res]
        out["disagg"] = {
            "requests": len(docs), "handoffs": d["handoffs"], "fallbacks": d["fallbacks"],
            "partings": g_check["partings"], "ship_bytes": d["ship_bytes"],
            "ship_bytes_per_prompt_token": d["ship_bytes"] / prompt_tokens,
            "kv_bytes_per_token": kv_bytes_per_token(cfg),
            "ship_bytes_600_token_prompt": d["ship_bytes"] / prompt_tokens * 600,
            "ship_s_p50": pctl(ship, 0.5), "ship_s_max": max(ship),
            "handoff_ttft_p50_s": pctl([r[1]["handoff_ttft_s"] for r in res], 0.5),
            "handoff_ttft_p95_s": pctl([r[1]["handoff_ttft_s"] for r in res], 0.95),
            "client_s_p50": pctl(g_check["client_s"], 0.5),
        }
        if d["handoffs"] != len(docs) or d["fallbacks"]:
            fail(phase, f"disagg accounting {d}")
        for eng in (pf_eng, de_eng):
            wait_until(lambda: eng.kv_stats()["blocks_free"] == eng.kv_stats()["num_blocks"],
                       phase, "the tiers' block pools to be whole")
    finally:
        router.stop()
        pf.stop()
        de.stop()

    # (4) the trace shards and the series through the report verbs
    shards = []
    for name, t in tr.items():
        path = work / f"{name.replace(' ', '_')}.json"
        t.export_chrome(str(path))
        shards.append(str(path))
    rid = max(docs, key=lambda doc: len(doc["token_ids"]))["request_id"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["report", "merge-trace", *shards, "-o", str(work / "merged.json")])
        cli.main(["report", "trace", rid, *shards, "--json"])
    merged_line, trace_json = buf.getvalue().splitlines()[0], buf.getvalue().splitlines()[-1]
    stitched = json.loads(trace_json)
    root, segs = stitched["root"], stitched["critical_path"]
    wall = root["end_s"] - root["start_s"]
    if (abs(sum(s["seconds"] for s in segs) - wall) > 1e-6 * max(wall, 1.0)
            or {n["process"] for n in stitched["spans"]} != set(tr)
            or root["name"] != "route"):
        fail(phase, f"report trace {rid}: {stitched['root']['name']}, segments "
                    f"{sum(s['seconds'] for s in segs)} s against {wall} s")
    by_kind: dict = {}
    for s in segs:
        by_kind[s["kind"]] = by_kind.get(s["kind"], 0.0) + s["seconds"]
    out["trace"] = {
        "request_id": rid, "merge": merged_line, "spans": len(stitched["spans"]),
        "processes": sorted({n["process"] for n in stitched["spans"]}),
        "wall_s": wall, "segments_sum_s": sum(s["seconds"] for s in segs),
        "seconds_by_kind": by_kind, "client_s": next(
            r[2] for doc, r in zip(docs, res) if doc["request_id"] == rid),
        "critical_path": [(s["span"], s["process"], s["kind"], s["seconds"]) for s in segs],
    }
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["report", "timeseries", str(series), "--json"])
        cli.main(["report", "dashboard", str(series), "-o", str(work / "fleet.html")])
    ts = json.loads(buf.getvalue().splitlines()[0])
    scraped = {k.split(":", 1)[0] for k in ts}
    if scraped != {"r0", "r1"} or not (work / "fleet.html").stat().st_size:
        fail(phase, f"obs-watch series cover {scraped}; dashboard "
                    f"{(work / 'fleet.html').stat().st_size} bytes")
    out["observability"] = {"series_records": sum(1 for _ in open(series)),
                            "moving_series": len(ts), "dashboard_bytes":
                            (work / "fleet.html").stat().st_size,
                            "alert_records": sum(1 for _ in open(alerts))}
    launches = fa.launch_counts()
    if launches["flash_fwd"] <= 0:
        fail(phase, f"B1 never launched in this phase: {launches}")
    peak = torch.cuda.max_memory_allocated()
    del sp
    torch.cuda.empty_cache()
    shutil.rmtree(work)
    emit(phase=phase, ok=True, nvidia_smi=smi, layers=cfg.num_hidden_layers,
         prompt_lens=list(SERVE_PROMPTS), new_tokens=FLEET_NEW, solo_seconds=solo_s,
         near_tie_rule=NEAR_TIE, b1_launches=launches["flash_fwd"],
         peak_memory_bytes=peak, seconds=time.perf_counter() - t_phase, **out)


DEPLOY_RUN = dict(RESUME_RUN, total_steps=6, checkpoint_every=1, log_dir=None)
# the shape of the canary bench's own requests (fleet/deploy.py canary_bench)
WARM_DOC = {"token_ids": list(range(2, 14)), "max_new_tokens": 16, "temperature": 0.0,
            "stop": False, "prefix_cache": False}


def serve_cmd(watch: Path, step: int) -> str:
    return (f"{sys.executable} -m nanodiloco_tpu_torch serve --checkpoint-dir {watch} "
            f"--step {step} --device cuda --host 127.0.0.1 --port {{port}} --slots 2 "
            "--max-len 512")


def fleet_events(path: Path) -> list[dict]:
    return read_jsonl_records(str(path))[0] if path.exists() else []


def phase_deploy_small(mem: Path, smi: str) -> dict:
    """The train -> serve loop through the CLI at the resume size (a
    checkpoint at 8B width is 40.6 GB). train() writes a checkpoint every
    round (steps 2, 4, 6) into this run's /dev/shm directory; two `serve`
    replicas of step 2 on the card, each warmed by one request;
    `fleet --watch-checkpoint-dir` over them, its canary gate at the
    CLI's defaults, canaries step 4 (its held-out loss on the card
    through B1) and promotes it; then a step 6 whose snapshot is NaN,
    written through the CheckpointManager, is rolled back and never
    canaried again; `report faults` of the events JSONL lists the
    promotion then the rollback; the fleet-goodput record's state
    seconds sum to the tracked replica-seconds within 1%; the CLI's
    canary losses equal the same function's in this process; each of
    the fleet process's three canary records launched B1. Then
    `fleet --autoscale-template` over
    one `serve` replica: a burst of clients takes the fleet from 1 to 2
    replicas (the child serves), and idle drains it back to 1. Returns the
    fleet process's kernel launches by shape (its canary records'
    ``kernel_shapes``)."""
    from nanodiloco_tpu_torch.fleet.autoscaler import ProcessReplicaProvider
    from nanodiloco_tpu_torch.fleet.deploy import canary_eval_loss

    phase, t_phase = "deploy_small", time.perf_counter()
    work = mem / "deploy"
    watch = work / "watch"
    watch.mkdir(parents=True)
    t0 = time.perf_counter()
    summary = train(TrainConfig(**{**DEPLOY_RUN, "checkpoint_dir": str(work / "ck")}),
                    device="cuda")
    train_s = time.perf_counter() - t0
    state = summary.pop("state")
    shutil.copy(work / "ck" / "model_config.json", watch)
    for s in (2, 4):
        shutil.copy(work / "ck" / f"step_{s}.pt", watch)
    log = open(work / "children.log", "w")
    # the children import the package from this checkout wherever they run
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT)] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p])}
    provider = ProcessReplicaProvider(serve_cmd(watch, 2), stdout=log, env=env)
    procs: list[subprocess.Popen] = []
    out: dict = {}
    try:
        reps = [provider.launch(), provider.launch()]
        for r in reps:
            wait_until(lambda: _healthy(r.url), phase, f"replica {r.name}", timeout=180)
            # one throwaway request, so that the canary's baseline bench
            # is not the replica's first traffic: the gate runs at the
            # CLI's defaults (its benches at 2 clients x 8 requests, so
            # that a TTFT p50 of ~10 ms rests on 16 requests)
            code, _ = http_post_json(r.url + "/v1/generate", WARM_DOC, timeout=120)
            if code != 200:
                fail(phase, f"replica {r.name} answered the warm-up request {code}")
        events = work / "events.jsonl"
        port = free_port()
        fleet = subprocess.Popen(
            [sys.executable, "-m", "nanodiloco_tpu_torch", "fleet", "--host", "127.0.0.1",
             "--port", str(port), *[a for r in reps for a in ("--replica", r.url)],
             "--watch-checkpoint-dir", str(watch), "--initial-step", "2", "--device", "cuda",
             "--poll-interval-s", "0.5", "--health-interval-s", "0.2",
             "--drain-timeout-s", "10", "--canary-requests", "8",
             "--events-jsonl", str(events), "--quiet"],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        procs.append(fleet)

        def kinds():
            return [e.get("deploy_event") for e in fleet_events(events)]
        wait_until(lambda: "promote" in kinds() or fleet.poll() is not None, phase,
                   "the promotion of step 4", timeout=300)
        for t in tree_leaves(state.snapshot):
            t.fill_(float("nan"))
        CheckpointManager(str(watch), max_to_keep=10).save(6, state)
        wait_until(lambda: "rollback" in kinds() or "rollback_failed" in kinds()
                   or fleet.poll() is not None, phase, "the rollback of step 6", timeout=300)
        time.sleep(2.0)  # four more polls of the watch dir: step 6 must not be canaried again
        fleet.send_signal(signal.SIGTERM)
        rc = fleet.wait(timeout=120)
        recs = fleet_events(events)
        deploys = [e for e in recs if "deploy_event" in e]
        starts = [e for e in deploys if e["deploy_event"] == "canary_start"]
        verdicts = [e for e in deploys if e["deploy_event"] == "canary_verdict"]
        order = [e["deploy_event"] for e in deploys
                 if e["deploy_event"] in ("promote", "rollback", "rollback_failed")]
        if (rc != 0 or order != ["promote", "rollback"]
                or [e["step"] for e in starts] != [4, 6]
                or [v["ok"] for v in verdicts] != [True, False]
                or verdicts[1]["regressions"] != ["canary_eval_loss_nonfinite"]):
            fail(phase, f"fleet exited {rc}; deploy events {deploys}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["report", "faults", str(events), "--json"])
        listed = [(e["event"], e.get("step")) for e in json.loads(buf.getvalue())]
        if listed != [("promote", 4), ("rollback", 6)]:
            fail(phase, f"report faults lists {listed}")
        good = recs[-1].get("fleet_goodput") or {}
        tracked = sum(sum(v.values()) for v in good.get("replica_seconds", {}).values())
        by_state = sum(good.get("seconds_by_state", {}).values())
        if not tracked or abs(by_state - tracked) > 0.01 * tracked:
            fail(phase, f"fleet goodput: states {by_state} s against {tracked} s tracked")
        ours = {s: canary_eval_loss(str(watch), s, device="cuda") for s in (2, 4, 6)}
        benches = {e["step"]: e["record"] for e in deploys
                   if e["deploy_event"] in ("canary_baseline", "canary_verdict")}
        cli_loss = {s: b["canary_eval_loss"] for s, b in benches.items()}
        # the fleet process's own counts: each canary loss went through B1
        launches = {k: sum(b["kernel_launches"][k] for b in benches.values())
                    for k in fa.launch_counts()}
        child_shapes = {k: {} for k in fa.KERNEL_NAMES}
        for b in benches.values():
            for k, shapes in b["kernel_shapes"].items():
                for key, n in shapes.items():
                    child_shapes[k][key] = child_shapes[k].get(key, 0) + n
        if sorted(benches) != [2, 4, 6] or any(
                b["kernel_launches"]["flash_fwd"] <= 0 for b in benches.values()):
            fail(phase, f"a canary loss of the fleet process did not launch B1: "
                        f"{ {s: b.get('kernel_launches') for s, b in benches.items()} }")
        # the record keeps 6 decimals; the same kernels on the same card
        if (any(abs(cli_loss[s] - ours[s]) > 2e-6 + 1e-5 * abs(ours[s]) for s in (2, 4))
                or not math.isnan(ours[6]) or not math.isnan(cli_loss[6])):
            fail(phase, f"canary losses: the CLI's {cli_loss}, in process {ours}")
        # the canary (the first replica) served step 6's NaN weights in both
        # of its slots and was swapped back to step 4: its own streams now
        # (shorter than the canary bench's rows, in both slots at once) must
        # equal the other replica's, which never took the poisoned weights
        # (same weights, engine and card: the same bits)
        docs = [{"token_ids": [(5 * i + j) % 300 + 2 for j in range(n)],
                 "max_new_tokens": 8, "temperature": 0.0, "stop": False,
                 "prefix_cache": False} for i, n in enumerate((4, 7, 5, 9))]
        after = {}
        for r in reps:
            http_post_json(r.url + "/admin/resume", {}, timeout=60)
            replies = fire(r.url, docs, concurrency=2)
            if any(rep[0] != 200 for rep in replies):
                fail(phase, f"replica {r.name} after the rollback: {replies}")
            after[r.name] = [rep[1]["token_ids"] for rep in replies]
        canary_streams, clean_streams = after[reps[0].name], after[reps[1].name]
        if canary_streams != clean_streams:
            fail(phase, f"the rolled-back canary's streams {canary_streams} differ from the "
                        f"clean replica's {clean_streams}")

        def at(kind, step):
            return next(e["t_unix"] for e in deploys
                        if e["deploy_event"] == kind and e.get("step") == step)
        out["deploy"] = {
            "train_s": train_s, "steps": [2, 4, 6],
            "checkpoint_bytes": os.path.getsize(watch / "step_4.pt"),
            "canary_losses": ours, "cli_canary_losses": cli_loss,
            "canary_benches": {s: {k: b[k] for k in ("ttft_p50_s", "client_tokens_per_sec",
                                                     "wall_s", "requests", "errors")}
                               for s, b in benches.items()},
            "canary_s": at("promote", 4) - at("canary_start", 4),
            "rollback_s": at("rollback", 6) - at("canary_start", 6),
            "report_faults": listed, "fleet_goodput_fraction": good["fleet_goodput_fraction"],
            "goodput_state_s": by_state, "goodput_tracked_s": tracked,
            "seconds_by_state": good["seconds_by_state"],
            "canary_streams_after_rollback": canary_streams,
            "canary_streams_equal_clean_replica": True,
        }
        provider.stop_all()
        del state, summary
        torch.cuda.empty_cache()

        # autoscale: 1 -> 2 under a burst, back to 1 when idle
        seed = ProcessReplicaProvider(serve_cmd(watch, 4), name_prefix="seed", stdout=log,
                                      env=env)
        provider = seed
        r0 = seed.launch()
        wait_until(lambda: _healthy(r0.url), phase, "the seed replica", timeout=180)
        events2 = work / "autoscale.jsonl"
        port = free_port()
        scaler = subprocess.Popen(
            [sys.executable, "-m", "nanodiloco_tpu_torch", "fleet", "--host", "127.0.0.1",
             "--port", str(port), "--replica", r0.url, "--health-interval-s", "0.2",
             "--autoscale-template", serve_cmd(watch, 4), "--autoscale-min", "1",
             "--autoscale-max", "2", "--autoscale-interval-s", "0.5",
             "--autoscale-cooldown-s", "2", "--autoscale-hysteresis", "2",
             "--autoscale-idle-ticks", "4", "--autoscale-window-s", "10",
             "--autoscale-horizon-s", "60", "--events-jsonl", str(events2), "--quiet"],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        procs.append(scaler)
        furl = f"http://127.0.0.1:{port}"
        wait_until(lambda: _healthy(furl), phase, "the autoscaling fleet", timeout=120)
        stop_burst = threading.Event()
        served: dict = {}

        def client(k):
            # class 0: the shed ladder never sheds it
            doc = {"token_ids": [(7 * k + j) % 300 + 2 for j in range(128)],
                   "max_new_tokens": 96, "temperature": 0.0, "stop": False, "priority": 0}
            while not stop_burst.is_set():
                try:
                    code, rep = http_post_json(furl + "/v1/generate", doc, timeout=120)
                except OSError:
                    continue
                if code == 200:
                    served[rep["served_by"]] = served.get(rep["served_by"], 0) + 1

        t_burst = time.perf_counter()
        clients = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(8)]
        for c in clients:
            c.start()
        try:
            wait_until(lambda: any(n.startswith("auto") for n in served) or
                       scaler.poll() is not None, phase, "a request served by the scaled-out "
                       "replica", timeout=180)
        finally:
            stop_burst.set()
            for c in clients:
                c.join(timeout=180)
        burst_s = time.perf_counter() - t_burst
        wait_until(lambda: any(e.get("deploy_event") == "scale_down"
                               for e in fleet_events(events2)) or scaler.poll() is not None,
                   phase, "the scale-in when idle", timeout=180)
        wait_until(lambda: any(e.get("deploy_event") == "replica_removed"
                               for e in fleet_events(events2)), phase, "the drained replica",
                   timeout=120)
        scaler.send_signal(signal.SIGTERM)
        rc = scaler.wait(timeout=120)
        recs = fleet_events(events2)
        kinds2 = [e.get("deploy_event") for e in recs if "deploy_event" in e]
        removed = next(e for e in recs if e.get("deploy_event") == "replica_removed")
        good = recs[-1].get("fleet_goodput") or {}
        tracked = (sum(sum(v.values()) for v in good.get("replica_seconds", {}).values())
                   + sum(e["seconds"][k] for e in recs if e.get("deploy_event")
                         == "replica_removed" for k in e["seconds"]))
        by_state = sum(good.get("seconds_by_state", {}).values())
        if (rc != 0 or kinds2.count("scale_up") != 1 or kinds2.count("scale_down") != 1
                or good.get("replicas_total") != 1
                or abs(by_state - tracked) > 0.01 * tracked):
            fail(phase, f"autoscale: exit {rc}, events {kinds2}, goodput {good}, "
                        f"tracked {tracked} s")
        scale_up = next(e for e in recs if e.get("deploy_event") == "scale_up")
        scale_down = next(e for e in recs if e.get("deploy_event") == "scale_down")
        out["autoscale"] = {
            "burst_s": burst_s, "served_by": served, "events": kinds2,
            "scale_up_reason": scale_up.get("reason"),
            "scaling_up_s": removed["seconds"]["scaling_up"],
            "scaling_down_s": removed["seconds"]["scaling_down"],
            "scale_up_to_down_s": scale_down["t_unix"] - scale_up["t_unix"],
            "fleet_goodput_fraction": good["fleet_goodput_fraction"],
            "goodput_state_s": by_state, "goodput_tracked_s": tracked,
        }
    finally:
        for p in procs:
            if p.poll() is None:
                # the fleet stops the replicas it launched on SIGTERM; the
                # ones a killed fleet leaves behind are killed here
                kids = child_pids(p.pid)
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait(timeout=30)
                for pid in kids:
                    with contextlib.suppress(OSError):
                        os.kill(pid, signal.SIGKILL)
        provider.stop_all()
        log.close()
    shutil.rmtree(work)
    emit(phase=phase, ok=True, nvidia_smi=smi, model=RESUME_MODEL.to_dict(),
         b1_launches=launches["flash_fwd"], seconds=time.perf_counter() - t_phase, **out)
    return child_shapes


# -- Mixture-of-Experts --------------------------------------------------------

# moe_small's size: float32, TF32 off, hidden 64 over 4/2 heads (hd 16,
# the FMA kernels), 4 experts top-2
MOE_SMALL = dataclasses.replace(SMALL_MODEL, hidden_size=64, intermediate_size=128,
                                num_experts=4, num_experts_per_tok=2)
MOE_SMALL_MODES = {
    "dense_cf1.25": dict(expert_capacity_factor=1.25),
    "dense_cf0.25": dict(expert_capacity_factor=0.25),  # the capacity binds
    "ragged": dict(moe_dispatch="ragged"),
    "expert_choice": dict(router_type="experts_choose"),
}
# bench.py's moe-8x-top2 (its single / single_ragged entries) at full width
# and depth, with flash attention: hd 64 in bf16 runs B1 and B3 on the
# tensor cores and B2 on the FMA kernel
MOE_8X = LlamaConfig(vocab_size=32000, hidden_size=512, intermediate_size=1408,
                     num_hidden_layers=6, num_attention_heads=8, num_key_value_heads=4,
                     max_position_embeddings=1024, dtype="bfloat16", loss_chunk=256,
                     num_experts=8, num_experts_per_tok=2, attention_impl="flash")
# its bench shape: S 1024 x B 8 per worker, one microbatch, W 2, H 2
MOE_RUN = dict(seed=0, batch_size=8, per_device_batch_size=8, seq_length=1024,
               warmup_steps=1, inner_steps=2, num_workers=2, total_steps=6, fit_vocab=False,
               quiet=True)
MOE_64E_FILE = ROOT / "configs" / "llama_moe_64e.json"
DISPATCH_KERNEL = re.compile(r"sort|scan|cumsum|index|gather|scatter|histogram|bincount",
                             re.IGNORECASE)


def tree_copy(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


ROUTER_NEAR_TIE = ("an MoE layer's top-k boundary is a near-tie when the router logits of the "
                   "k-th and (k+1)-th experts a, b differ by at most 2**-8 * sum_i |x_i (R_ia - "
                   "R_ib)| plus one bf16 ulp of each (NEAR_TIE's argument for the router's "
                   "product): two bf16 computations of the same network may route such a token "
                   "to different experts, and every later layer at that and later tokens may "
                   "then route and part by more than NEAR_TIE; the first such flips (no flip "
                   "in an earlier layer at the same or an earlier token) must be near-ties")


@contextlib.contextmanager
def moe_routes(log: list):
    """Record, in call order, every MoE layer's normed input rows [n, d],
    router [d, E] (one worker) and router logits [n, E], from the training
    forward and from generate(). The logits are the layer's own product
    again (the same shapes, so the same bits on the card)."""
    import nanodiloco_tpu_torch.models.generate as gen_mod
    import nanodiloco_tpu_torch.models.llama as llama_mod

    orig = llama_mod.moe_mlp

    def spy(cfg, h, layer, **kw):
        x, router = h[0].reshape(-1, h.shape[-1]).detach(), layer["router"][0].to(h.dtype)
        log.append((x, router, moe_mm(x, router).float()))
        return orig(cfg, h, layer, **kw)

    llama_mod.moe_mlp = gen_mod.moe_mlp = spy
    try:
        yield log
    finally:
        llama_mod.moe_mlp = gen_mod.moe_mlp = orig


def router_flips(sp, cfg, req: GenRequest, stream: list[int], upto: int) -> dict:
    """Where the training forward over prompt + stream and solo generate()
    (which emits ``stream``) route a token at or before stream position
    ``upto`` to different top-k experts: the count of such (layer, token)
    pairs, the root ones (no flip in an earlier layer at the same or an
    earlier token explains them), and whether every root is a router
    near-tie (ROUTER_NEAR_TIE) in the forward's logits."""
    fwd, gen = [], []
    toks = torch.tensor([list(req.prompt) + stream[:-1]], device="cuda")
    with torch.no_grad(), moe_routes(fwd):
        forward(sp, toks, dataclasses.replace(cfg, remat=False), return_hidden=True)
    with moe_routes(gen):
        ref = solo(sp, cfg, req, "cuda")
    if ref[:upto] != stream[:upto]:
        return {"route_flips": None, "all_router_near_ties": False,
                "solo_parts_before": upto}
    n_layers, k = cfg.num_hidden_layers, cfg.num_experts_per_tok
    last = len(req.prompt) + upto  # the rows that can reach stream position upto
    flips = []
    for layer in range(n_layers):
        x, router, lf = fwd[layer]
        calls = [layer] + list(range(n_layers + layer, len(gen), n_layers))
        lf, lg = lf[:last], torch.cat([gen[i][2] for i in calls])[:last]
        # routed as moe_mlp routes: top-k of the softmax
        ef, eg = (moe_top(torch.softmax(lx, -1), k)[1].sort(-1)[0] for lx in (lf, lg))
        for row in (ef != eg).any(-1).nonzero()[:, 0].tolist():
            idx = moe_top(torch.softmax(lf[row], -1), k + 1)[1]
            a, b = int(idx[k - 1]), int(idx[k])
            vals = lf[row, idx]
            gap = float(vals[k - 1] - vals[k])
            ulp = sum(float(torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(1e-30))) - 7))
                      for v in (vals[k - 1], vals[k]))
            tol = float((x[row].float() * (router[:, a].float() - router[:, b].float())).abs()
                        .sum()) * BF16_U + ulp
            flips.append({"layer": layer, "row": row, "gap": gap, "tol": tol})
    # a flip at (layer l, row r) changes the input of every later layer at
    # rows >= r (the residual stream, then attention): the roots, flips no
    # earlier-layer flip at a row <= r explains, must be router near-ties
    roots = [f for f in flips if not any(g["layer"] < f["layer"] and g["row"] <= f["row"]
                                         for g in flips)]
    worst = max((f["gap"] / f["tol"] for f in roots), default=0.0)
    return {"route_flips": len(flips), "root_flips": roots[:6],
            "all_router_near_ties": bool(roots) and worst <= 1.0,
            "worst_root_gap_over_tol": worst}


def moe_small_run(model, device, params, rounds) -> dict:
    """Two DiLoCo rounds of ``model`` from a copy of ``params`` on
    ``device``: the [H, W] losses and the snapshot, on the CPU."""
    dl = Diloco(model, DilocoConfig(**SMALL_DILOCO), device=device)
    state = dl.init_state(params=tree_copy(params))
    losses = torch.cat([dl.round_step(state, t, m)[1].cpu() for t, m in rounds])
    return {"losses": losses, "snapshot": tree_map(lambda t: t.detach().cpu().clone(),
                                                   state.snapshot)}


def phase_moe_small(smi: str) -> None:
    """Every MoE mode at a small float32 size from one parameter tree: two
    DiLoCo rounds on the card (twice) and on the CPU; the router probe on
    the CPU's final snapshot on both; forced top-k ties on both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rounds = small_rounds()
    probe_tokens = torch.as_tensor(rounds[-1][0][-1, 0, 0]).long()       # [B, S]
    n_assign = MOE_SMALL.num_experts_per_tok * probe_tokens.numel()
    params = init_params(torch.Generator().manual_seed(0), MOE_SMALL, device="cpu")
    # ties: equal values must come out lower index first, as jax.lax.top_k has it
    x = torch.tensor([[0.5, 1.0, 1.0, 0.2, 1.0, 0.0, 0.0, 1.0]]).repeat(3, 1)
    ties = {d: [t.cpu().tolist() for t in moe_top(x.to(d), 5)] for d in ("cuda", "cpu")}
    if ties["cuda"] != ties["cpu"] or ties["cpu"][1][0] != [1, 2, 4, 7, 0]:
        fail("moe_small", f"top-k tie order: card {ties['cuda']}, CPU {ties['cpu']}")
    launches = dict.fromkeys(fa.KERNEL_NAMES, 0)
    out = {}
    for mode, change in MOE_SMALL_MODES.items():
        model = dataclasses.replace(MOE_SMALL, **change)
        fa.reset_launch_counts()
        card = [moe_small_run(model, "cuda", params, rounds) for _ in range(2)]
        for k, v in fa.launch_counts().items():
            launches[k] += v
        check_routes("moe_small", torch.float32, model.head_dim)
        cpu = moe_small_run(model, "cpu", params, rounds)
        same = torch.equal(card[0]["losses"], card[1]["losses"]) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(card[0]["snapshot"]),
                                              tree_leaves(card[1]["snapshot"])))
        if not same:
            fail("moe_small", f"{mode}: two card runs differ")
        got, want = card[0]["losses"], cpu["losses"]
        err = ((got - want).abs() / want.abs()).max().item()
        snap_err = max(rel_err(a, b) for a, b in zip(tree_leaves(card[0]["snapshot"]),
                                                     tree_leaves(cpu["snapshot"])))
        if not torch.isfinite(got).all() or max(err, snap_err) > SMALL_TOL:
            fail("moe_small", f"{mode}: card vs CPU losses {got.tolist()} vs {want.tolist()}, "
                              f"snapshot rel err {snap_err:.3e}")
        # the probe on ONE snapshot (the CPU's) on both devices
        probe = {d: make_router_stats_fn(model)(tree_map(lambda t: t.to(d), cpu["snapshot"]),
                                                probe_tokens.to(d)) for d in ("cuda", "cpu")}
        d_drop = abs(probe["cuda"]["moe_dropped_frac"] - probe["cpu"]["moe_dropped_frac"])
        e_err = (abs(probe["cuda"]["moe_router_entropy"] - probe["cpu"]["moe_router_entropy"])
                 / probe["cpu"]["moe_router_entropy"])
        if d_drop > 1.0 / n_assign or e_err > 1e-5:
            fail("moe_small", f"{mode}: router probe card {probe['cuda']} vs CPU {probe['cpu']}")
        # cf 0.25: E*C = 100 slots for 400 assignments, at least 3/4 drop
        dropped = probe["cpu"]["moe_dropped_frac"]
        if ((mode == "dense_cf0.25" and dropped < 0.75 - 1e-6)
                or (mode == "ragged" and dropped != 0.0)):
            fail("moe_small", f"{mode}: dropped fraction {probe['cpu']}")
        out[mode] = {"losses": got.tolist(), "cpu_losses": want.tolist(), "max_rel_err": err,
                     "snapshot_max_rel_err": snap_err, "card_runs_bit_identical": same,
                     "probe_card": probe["cuda"], "probe_cpu": probe["cpu"]}
    emit(phase="moe_small", ok=True, nvidia_smi=smi, model=MOE_SMALL.to_dict(), modes=out,
         tolerance={"losses_and_snapshot_rel": SMALL_TOL,
                    "dropped_frac_abs": f"one assignment of {n_assign}",
                    "router_entropy_rel": 1e-5},
         top_k_ties=ties["cuda"], launches=launches)


def moe_step_profile(model: LlamaConfig) -> dict:
    """One inner step of ``model`` at MOE_RUN's shape (W 2, one microbatch
    of 8 x 1024) under torch.profiler, after one warm step: host ms, the
    device's busy ms and idle share, kernel ms by class (GEMMs, the flash
    kernels, the dispatch's sort/scan/index/gather/scatter kernels, the
    rest) and the host syncs (device-to-host copies and their seconds)."""
    from torch.profiler import ProfilerActivity, profile

    dl = Diloco(model, DilocoConfig(num_workers=2, inner_steps=2, warmup_steps=1,
                                    total_steps=4, lr=1e-3), device="cuda")
    state = dl.init_state(torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, 384, (2, 1, 8, 1024), generator=gen)
    dl.inner_step(state, toks, torch.ones_like(toks))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dl.inner_step(state, toks, torch.ones_like(toks))
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    busy_us, n_kernels = device_busy_us(prof)
    by_class = dict.fromkeys(("gemm", "flash", "dispatch", "other"), 0.0)
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            name = e.name
            cls = ("flash" if "flash" in name else "gemm" if GEMM_KERNEL.search(name)
                   else "dispatch" if DISPATCH_KERNEL.search(name) else "other")
            by_class[cls] += us / 1e3
            by_name[name[:90]] = by_name.get(name[:90], 0.0) + us / 1e3
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    d2h = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU
           and e.name in ("cudaMemcpyAsync", "cudaStreamSynchronize")]
    del dl, state
    torch.cuda.empty_cache()
    if busy_us <= 0:
        return {"host_ms": host_ms, "idle_share": "not measured: no device time in the profile"}
    return {"host_ms": host_ms, "device_busy_ms": busy_us / 1e3, "kernels": n_kernels,
            "idle_share": max(0.0, 1.0 - busy_us / 1e3 / host_ms), "kernel_ms": by_class,
            "top_kernels_ms": top,
            "host_sync_calls": len(d2h),
            "host_sync_ms": sum(e.time_range.end - e.time_range.start for e in d2h) / 1e3}


def moe_run_line(name: str, summary: dict, jsonl: Path, n_params: int,
                 allocated_before: int = 0) -> dict:
    recs = read_jsonl_records(str(jsonl))[0]
    syncs = [r for r in recs if r.get("outer_synced")]
    cost = next((r["cost_analysis"] for r in recs if r.get("cost_analysis")), None)
    tps = summary["tokens_per_sec_after_first_round"]
    return {
        "tokens_per_sec_after_first_round": tps,
        "round_seconds": summary["round_seconds"],
        "peak_memory_bytes": summary["peak_memory_bytes"],
        # the run's own: its peak above what was allocated when it started
        "run_peak_memory_bytes": (summary["peak_memory_bytes"] or 0) - allocated_before,
        "t_inner_s": [r.get("t_inner") for r in syncs],
        "t_sync_s": [r.get("t_sync") for r in syncs],
        "outer_step_bound_ms": outer_bytes_per_param(name, 2) * n_params / PEAK_BYTES * 1e3,
        "flops_per_token": None if cost is None else cost.get("flops_per_token"),
        "mfu_analytic_after_first_round": None if cost is None else analytic_mfu(cost, tps),
        "router_stats": [{k: r[k] for k in ("step", "moe_dropped_frac", "moe_router_entropy")}
                         for r in syncs],
        "final_loss": summary["final_loss"],
    }


def phase_moe_train(mem: Path, smi: str) -> tuple[dict, dict]:
    """train() on moe-8x-top2 at its bench shape, dense and ragged, 3
    rounds each; the ragged run checkpointed after round 1 and resumed
    must equal the uninterrupted one bit for bit; a torch.profiler step
    of each dispatch; `python -m nanodiloco_tpu_torch --llama-config-file
    configs/llama_moe_64e.json` (ragged, 64 experts, hd 32) in a
    subprocess, whose B1 and B3 must launch only on the tensor cores and B2
    only on the FMA kernel. Returns that run's kernel launches by shape
    and what moe_serve needs (the ragged checkpoint's directory and final
    snapshot)."""
    t_phase = time.perf_counter()
    log_dir = mem / "moe_runs"
    ck_dir = mem / "moe_ck"
    n = MOE_8X.num_params()
    launches = dict.fromkeys(fa.KERNEL_NAMES, 0)
    runs = {}
    # what earlier phases still hold in this process: device memory every
    # run's absolute peak includes, and threads that share the host
    gc.collect()
    torch.cuda.empty_cache()
    held = {"allocated_at_start_bytes": torch.cuda.memory_allocated(),
            "threads_at_start": sorted(t.name for t in threading.enumerate())}
    emit(phase="moe_train", run="start", ok=True, **held)
    before = {}

    def run(name: str, model: LlamaConfig, **kw) -> dict:
        cfg = TrainConfig(**{**MOE_RUN, "model": model, "log_dir": str(log_dir),
                             "run_name": name, **kw})
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        before[name] = torch.cuda.memory_allocated()
        summary = train(cfg, device="cuda")
        got = fa.launch_counts()
        check_routes("moe_train", torch.bfloat16, model.head_dim)
        for k, v in got.items():
            launches[k] += v
        if not all(math.isfinite(x) for step in summary["losses"] for x in step):
            fail("moe_train", f"{name}: losses {summary['losses']}")
        return summary

    dense = dataclasses.replace(MOE_8X, expert_capacity_factor=1.25)
    ragged = dataclasses.replace(MOE_8X, moe_dispatch="ragged")
    for name, model in (("dense", dense), ("ragged", ragged)):
        summary = run(name, model)
        runs[name] = moe_run_line(name, summary, log_dir / f"{name}.jsonl", n, before[name])
        if len(runs[name]["router_stats"]) != 3:
            fail("moe_train", f"{name}: router stats on {runs[name]['router_stats']}")
        emit(phase="moe_train", run=name, ok=True, nvidia_smi=smi, num_params=n, **runs[name])
        # only the ragged state stays (for the resume check): no run's peak
        # carries an earlier run's state
        full = summary if name == "ragged" else None
        del summary
        torch.cuda.empty_cache()
    # the ragged run again: one round with a checkpoint, then resumed to 3
    run("ragged_first", ragged, total_steps=2, checkpoint_dir=str(ck_dir))
    resumed = run("ragged_resumed", ragged, checkpoint_dir=str(ck_dir))
    resume_diff = None
    if resumed["losses"] != full["losses"][2:]:
        resume_diff = "losses"
    for (name, a), (_, b) in zip(state_leaves(resumed["state"]), state_leaves(full["state"])):
        if resume_diff is None and not torch.equal(a, b):
            resume_diff = name
    if resume_diff is not None:
        fail("moe_train", f"the resumed ragged run differs from the uninterrupted one first "
                          f"at {resume_diff}")
    snapshot = tree_map(lambda t: t.detach().clone(), full["state"].snapshot)
    del full, resumed
    torch.cuda.empty_cache()
    profiles = {name: moe_step_profile(model) for name, model in (("dense", dense),
                                                                  ("ragged", ragged))}
    # llama_moe_64e through the CLI in bf16 (hd 32: B1 and B3 on the tensor
    # cores), 3 rounds at the bench shape
    cmd = [sys.executable, "-m", "nanodiloco_tpu_torch", "--llama-config-file",
           str(MOE_64E_FILE), "--attention", "flash", "--dtype", "bfloat16",
           "--seed", "0", "--batch-size", "8",
           "--per-device-batch-size", "8", "--seq-length", "1024", "--warmup-steps", "1",
           "--total-steps", "6", "--inner-steps", "2", "--num-workers", "2",
           "--log-dir", str(log_dir), "--run-name", "moe64e", "--quiet"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail("moe_train", f"the llama_moe_64e CLI run exited {proc.returncode}: "
                          f"{proc.stderr[-2000:]}")
    cli_summary = json.loads(proc.stdout.strip().splitlines()[-1])
    model64 = LlamaConfig(**cli_summary["model"])
    check_variants("moe_train", cli_summary["kernel_variants"], torch.bfloat16,
                   model64.head_dim)
    runs["llama_moe_64e_cli"] = moe_run_line("cli", cli_summary, log_dir / "moe64e.jsonl",
                                             model64.num_params())
    emit(phase="moe_train", run="llama_moe_64e_cli", ok=True, nvidia_smi=smi,
         model=cli_summary["model"], launches=cli_summary["kernel_launches"],
         variants=cli_summary["kernel_variants"],
         **runs["llama_moe_64e_cli"])
    dense_tps = runs["dense"]["tokens_per_sec_after_first_round"]
    emit(phase="moe_train", ok=True, nvidia_smi=smi, model=MOE_8X.to_dict(), num_params=n,
         tokens_per_sec={k: v["tokens_per_sec_after_first_round"] for k, v in runs.items()},
         ragged_over_dense_tokens_per_sec=(
             runs["ragged"]["tokens_per_sec_after_first_round"] / dense_tps),
         peak_memory_gb={k: (v["peak_memory_bytes"] or 0) / 1e9 for k, v in runs.items()},
         run_peak_memory_gb={k: v["run_peak_memory_bytes"] / 1e9 for k, v in runs.items()},
         **held,
         resumed_bit_exact=True, step_profile=profiles, launches=launches,
         seconds=time.perf_counter() - t_phase)
    return (cli_summary["kernel_shapes"],
            {"checkpoint_dir": ck_dir, "snapshot": snapshot, "model": ragged})


def phase_moe_serve(ragged_run: dict, smi: str) -> None:
    """moe-8x-top2 weights (seed 0, bf16 serving copy) behind the dense
    and the paged engine (4 slots x 1024, chunk 512, 8 greedy requests of
    64 new tokens). Ragged dispatch: every stream equals solo generate()
    or parts from it first at a near-tie, and each token is the training
    forward's argmax within NEAR_TIE. Dense dispatch at cf 1.25: the
    streams that part from solo generate() beyond a near-tie are the
    documented capacity divergence, counted, not failed. Then `generate`
    from the CLI on moe_train's ragged checkpoint equals generate() on
    its snapshot."""
    t_phase = time.perf_counter()
    fa.reset_launch_counts()
    gen = torch.Generator().manual_seed(2)
    reqs = [GenRequest(prompt=tuple(torch.randint(0, MOE_8X.vocab_size, (n,),
                                                  generator=gen).tolist()),
                       max_new_tokens=SERVE_NEW, seed=10 + i)
            for i, n in enumerate(SERVE_PROMPTS)]
    out = {}
    for mode, change in (("ragged", dict(moe_dispatch="ragged")),
                         ("dense_cf1.25", dict(expert_capacity_factor=1.25))):
        cfg = dataclasses.replace(MOE_8X, **change)
        params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
        sp = serving_params(params, cfg)
        del params
        refs = [solo(sp, cfg, r, "cuda") for r in reqs]
        for engine, kw in (("dense", {}), ("paged", {"kv_block_size": 16})):
            torch.cuda.reset_peak_memory_stats()
            eng = InferenceEngine(sp, cfg, num_slots=4, max_len=1024, chunk_size=512,
                                  device="cuda", **kw)
            sched = Scheduler(eng)
            t0 = time.perf_counter()
            streams = [t.result["tokens"] for t in drive(sched, reqs, per_tick=2)]
            wall = time.perf_counter() - t0
            stats = sched.stats()
            checks, parted, routed_ties = [], 0, 0
            for req, stream, ref in zip(reqs, streams, refs):
                if len(stream) != SERVE_NEW:
                    fail("moe_serve", f"{mode}/{engine}: stream of {len(stream)} tokens")
                tie = near_tie(sp, cfg, req, stream, ref, "moe_serve",
                               f"{mode}/{engine} vs solo generate()", strict=mode == "ragged")
                parted += not tie.get("near_tie", True)
                entry = {"prompt_len": len(req.prompt), **tie}
                if mode == "ragged":
                    tf = teacher_forcing(sp, cfg, req, stream)
                    entry.update(teacher_forcing_exact=tf["exact"],
                                 teacher_forcing_gap_over_tol=tf["gap_over_tol"])
                    if not tf["ok"]:
                        # past NEAR_TIE only behind a routing difference at a router near-tie
                        first_bad = int((tf["gap"] > tf["tol"]).nonzero()[0, 0])
                        flips = router_flips(sp, cfg, req, stream, first_bad)
                        entry.update(teacher_forcing_first_beyond_near_tie=first_bad, **flips)
                        if not flips["all_router_near_ties"]:
                            fail("moe_serve", f"ragged/{engine}: a token is not the training "
                                              f"forward's argmax within NEAR_TIE, and no "
                                              f"router near-tie explains it: {entry}")
                        routed_ties += 1
                checks.append(entry)
            out[f"{mode}/{engine}"] = {
                "streams_equal_to_solo": sum(c["first_divergence"] is None for c in checks),
                "streams_parted_beyond_near_tie": parted,
                "streams_past_near_tie_behind_router_near_ties": routed_ties, "checks": checks,
                "workload_seconds": wall, "decode_tokens_per_sec": stats["decode_tokens_per_sec"],
                "ttft_p50_s": stats["ttft_p50_s"], "ttft_p95_s": stats["ttft_p95_s"],
                "peak_memory_bytes": torch.cuda.max_memory_allocated()}
            emit(phase="moe_serve", run=f"{mode}/{engine}", ok=True, nvidia_smi=smi,
                 **out[f"{mode}/{engine}"])
            del eng, sched
        del sp
        torch.cuda.empty_cache()
    launches = fa.launch_counts()
    if launches["flash_fwd"] == 0:
        fail("moe_serve", f"B1 did not launch in the teacher-forcing forwards: {launches}")
    # `generate` from the CLI on moe_train's ragged checkpoint
    tok = ByteTokenizer()
    prompt = "The experts"
    proc = subprocess.run(
        [sys.executable, "-m", "nanodiloco_tpu_torch", "generate", "--checkpoint-dir",
         str(ragged_run["checkpoint_dir"]), "--prompt", prompt, "--max-new-tokens", "16",
         "--temperature", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600)
    want = generate(ragged_run["snapshot"], [tok.encode(prompt)], ragged_run["model"], 16,
                    device="cuda")[0].tolist()
    if proc.returncode != 0 or proc.stdout != prompt + tok.decode(want) + "\n":
        fail("moe_serve", f"CLI generate exited {proc.returncode}: {proc.stdout!r} vs "
                          f"{prompt + tok.decode(want)!r}: {proc.stderr[-2000:]}")
    emit(phase="moe_serve", ok=True, nvidia_smi=smi, model=MOE_8X.to_dict(),
         requests=len(reqs), prompt_lens=list(SERVE_PROMPTS), new_tokens=SERVE_NEW,
         near_tie_rule=NEAR_TIE, router_near_tie_rule=ROUTER_NEAR_TIE,
         cli_generate_tokens=want, b1_launches=launches["flash_fwd"],
         seconds=time.perf_counter() - t_phase)


def _healthy(url: str) -> bool:
    try:
        return http_get(url + "/healthz", timeout=2.0)[0] == 200
    except OSError:
        return False


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

    phase_kernels()
    # the main path: every launch from here on is counted by shape, and each
    # phase's share (with what its child processes report) goes to `path`
    fa.reset_shape_counts()
    path, seen = {}, fa.shape_counts()

    def took(phase: str, child: dict | None = None) -> None:
        nonlocal seen
        now = fa.shape_counts()
        got = {k: {key: n - seen[k].get(key, 0) for key, n in shapes.items()
                   if n > seen[k].get(key, 0)} for k, shapes in now.items()}
        for k, shapes in (child or {}).items():
            for key, n in shapes.items():
                got[k][key] = got[k].get(key, 0) + n
        path[phase], seen = got, now

    phase_train_small()
    took("train_small")
    phase_resume()
    took("resume")
    summary = phase_train(smi)
    took("train")
    phase_checkpoint_full(summary, smi)
    del summary
    torch.cuda.empty_cache()
    phase_diloco_options_small(smi)
    took("diloco_options_small")
    phase_diloco_options_8b(smi)
    took("diloco_options_8b")
    phase_serve_small(smi)
    phase_serve_modes_small(smi)
    took("serve_small")
    sp = phase_serve(smi)
    took("serve")
    phase_serve_paged(sp, smi)
    took("serve_paged")
    # this run's own directory: a second run on the same machine never
    # shares (or removes) its files
    mem = Path(tempfile.mkdtemp(prefix="nanodiloco_chip_smoke_", dir=MEM_PARENT))
    try:
        fixture = phase_hf_8b(sp, mem, smi)
        del sp
        torch.cuda.empty_cache()
        took("hf_8b")
        took("faults_8b", phase_faults_8b(fixture, mem, smi))
        del fixture
        torch.cuda.empty_cache()
        phase_supervise_small(mem, smi)
        took("supervise_small")
        phase_fleet_8b(mem, smi)
        took("fleet_8b")
        took("deploy_small", phase_deploy_small(mem, smi))
        phase_moe_small(smi)
        took("moe_small")
        moe64e_shapes, ragged_run = phase_moe_train(mem, smi)
        took("moe_train", moe64e_shapes)
        phase_moe_serve(ragged_run, smi)
        took("moe_serve")
        del ragged_run
    finally:
        shutil.rmtree(mem, ignore_errors=True)
    shutil.rmtree(WORK, ignore_errors=True)

    emit(kernels=phase_kernels_main(path))
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})


if __name__ == "__main__":
    main()
