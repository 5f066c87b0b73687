"""Train at Llama-3-8B width, depth cut to one layer, with each DiLoCo
worker spanning several cards (``--fsdp``, ``--tp``; ROADMAP item 7b),
and print one JSON line per rank: the losses, round seconds, the outer
sync's seconds, tokens/s, peak device memory, the flash kernels'
launches by shape and what the rank put on each collective.

One rank a card over NCCL, for example on four cards:

    python -m torch.distributed.run --nproc-per-node 4 scripts/torch_dist_shard.py --fsdp 2 --tp 2
    python -m torch.distributed.run --nproc-per-node 4 scripts/torch_dist_shard.py --tp 2

The first holds W 2 workers in one worker group of four ranks; the second
one worker in each of two groups of two, so its merge crosses the groups.
``--device cpu --tiny`` runs a small float32 model over gloo instead.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from nanodiloco_tpu_torch.models.config import LLAMA3_8B, LlamaConfig  # noqa: E402
from nanodiloco_tpu_torch.ops.cuda import flash_attention as fa  # noqa: E402
from nanodiloco_tpu_torch.parallel.mesh import init_from_env, record_collectives  # noqa: E402
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train  # noqa: E402

TINY = LlamaConfig(vocab_size=384, hidden_size=64, intermediate_size=128,
                   num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=1,
                   max_position_embeddings=64, attention_impl="flash", loss_chunk=16)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fsdp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--per-device-batch-size", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="a small float32 model")
    p.add_argument("--out", default=str(ROOT / "runs" / "dist_shard"),
                   help="directory of the run's JSONL and each rank's JSON")
    a = p.parse_args(argv)
    device = init_from_env(a.device)
    rank = dist.get_rank()
    if device.type == "cuda":
        from nanodiloco_tpu_torch.ops.cuda import build

        if rank == 0:
            build.build_all()
        dist.barrier()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    model = TINY if a.tiny else dataclasses.replace(LLAMA3_8B, num_hidden_layers=1)
    layout = f"g{dist.get_world_size() // (a.fsdp * a.tp)}_fsdp{a.fsdp}_tp{a.tp}"
    shapes0 = fa.shape_counts()
    with record_collectives() as rec:
        summary = train(TrainConfig(
            seed=0, batch_size=a.per_device_batch_size,
            per_device_batch_size=a.per_device_batch_size,
            seq_length=64 if a.tiny else 2048, warmup_steps=1, inner_steps=2,
            total_steps=2 * a.rounds, num_workers=a.workers, fsdp=a.fsdp, tp=a.tp,
            model=model, fit_vocab=False, quiet=True, dynamics_metrics=False,
            cost_analysis=False, preempt_signals=False, log_dir=a.out, run_name=layout),
            device=device)
    by_tag: dict = {}
    for r in rec:
        key = f"{r['op']}/{r['tag']}/{r.get('group', 'all')}"
        by_tag[key] = by_tag.get(key, 0) + r["bytes"]
    out = {"layout": layout, "rank": rank, "coords": summary["coords"],
           "device_name": summary["device_name"],
           "losses": summary["losses"], "round_seconds": summary["round_seconds"],
           "avg_sync_time_s": summary["avg_sync_time_s"],
           "tokens_per_sec": summary["tokens_per_sec"],
           "tokens_per_sec_after_first_round": summary["tokens_per_sec_after_first_round"],
           "peak_memory_bytes": summary["peak_memory_bytes"],
           "flash_shapes": {k: {key: n - shapes0[k].get(key, 0) for key, n in v.items()
                                if n > shapes0[k].get(key, 0)}
                            for k, v in fa.shape_counts().items()},
           "collective_bytes": by_tag}
    if rank == 0 and device.type == "cuda":
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip().splitlines()
    os.makedirs(a.out, exist_ok=True)
    Path(a.out, f"{layout}_rank{rank}.json").write_text(json.dumps(out))
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
