"""``python -m nanodiloco_tpu_torch``: classic DiLoCo training with the
JAX CLI's flag names (the classic-path subset). Prints one JSON line per
round and the run summary last. Runs on the CUDA card unless
``--device cpu``."""

from __future__ import annotations

import argparse
import json

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m nanodiloco_tpu_torch")
    p.add_argument("--seed", type=int, default=1337)
    p.add_argument("--batch-size", type=int, default=256,
                   help="per-worker global batch (microbatches x per-device)")
    p.add_argument("--per-device-batch-size", type=int, default=8)
    p.add_argument("--seq-length", type=int, default=1024)
    p.add_argument("--warmup-steps", type=int, default=100)
    p.add_argument("--total-steps", type=int, default=10_000)
    p.add_argument("--inner-steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=4e-4)
    p.add_argument("--outer-lr", type=float, default=0.7)
    p.add_argument("--llama-config-file", type=str, default=None,
                   help="HF-style model config JSON (configs/*.json)")
    p.add_argument("--num-workers", type=int, default=1)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    a = parse_args(argv)
    model = (LlamaConfig.from_json(a.llama_config_file) if a.llama_config_file
             else LlamaConfig())
    summary = train(TrainConfig(
        seed=a.seed, batch_size=a.batch_size,
        per_device_batch_size=a.per_device_batch_size, seq_length=a.seq_length,
        warmup_steps=a.warmup_steps, total_steps=a.total_steps,
        inner_steps=a.inner_steps, lr=a.lr, outer_lr=a.outer_lr,
        num_workers=a.num_workers, model=model,
    ), device=a.device)
    print(json.dumps({k: v for k, v in summary.items() if k != "losses"}))
    return summary


if __name__ == "__main__":
    main()
