"""Classic DiLoCo training run: port of the classic path of
``nanodiloco_tpu/training/train_loop.py::train``.

Synthetic corpus -> packed rows -> ``DilocoBatcher`` -> rounds of
``Diloco.round_step`` until ``total_steps`` inner steps. Returns a summary
with the per-step [W] losses, throughput, peak device memory and the
flash kernels' launch counts over the run. Checkpointing, evaluation, the
metrics JSONL, telemetry and fault injection are not ported yet
(ROADMAP.md, Queue A item 1).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any

import numpy as np
import torch

from nanodiloco_tpu_torch.data.pipeline import DilocoBatcher, pack_corpus, synthetic_corpus
from nanodiloco_tpu_torch.data.tokenizer import ByteTokenizer
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import Params, resolve_device, tree_leaves
from nanodiloco_tpu_torch.ops.cuda.flash_attention import launch_counts
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig


@dataclasses.dataclass
class TrainConfig:
    """The classic-path subset of the JAX ``TrainConfig`` (same names and
    defaults)."""

    seed: int = 1337
    batch_size: int = 256           # per-worker batch (microbatches x B)
    per_device_batch_size: int = 8
    seq_length: int = 1024
    warmup_steps: int = 100
    total_steps: int = 10_000
    inner_steps: int = 100
    lr: float = 4e-4
    outer_lr: float = 0.7
    num_workers: int = 1
    model: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    # shrink vocab_size to the tokenizer's vocabulary (rounded up to 128)
    fit_vocab: bool = True
    quiet: bool = False

    @property
    def grad_accum(self) -> int:
        if self.batch_size % self.per_device_batch_size:
            raise ValueError("batch_size must divide evenly by per_device_batch_size")
        return self.batch_size // self.per_device_batch_size


def _fingerprint(tree: Params) -> list[float]:
    """One float64 sum per tensor: cheap evidence that a tensor changed."""
    return [float(p.sum(dtype=torch.float64)) for p in tree_leaves(tree)]


def _fit_model(cfg: TrainConfig, vocab: int, quiet: bool) -> LlamaConfig:
    model_cfg = cfg.model
    if model_cfg.vocab_size < vocab:
        return dataclasses.replace(model_cfg, vocab_size=vocab)
    fitted = ((vocab + 127) // 128) * 128
    if cfg.fit_vocab and fitted < model_cfg.vocab_size:
        if not quiet:
            print(f"[nanodiloco] vocab_size {model_cfg.vocab_size} -> {fitted} "
                  f"(tokenizer has {vocab} tokens; fit_vocab=False keeps it)")
        return dataclasses.replace(model_cfg, vocab_size=fitted)
    return model_cfg


def train(cfg: TrainConfig, device: str | torch.device = "cuda") -> dict[str, Any]:
    """Run classic DiLoCo for ``cfg.total_steps`` inner steps on one
    device; returns the run summary."""
    device = resolve_device(device)
    if cfg.total_steps % cfg.inner_steps:
        raise ValueError("total_steps must divide evenly by inner_steps")
    tokenizer = ByteTokenizer()
    model_cfg = _fit_model(cfg, tokenizer.vocab_size, cfg.quiet)
    rows = pack_corpus(synthetic_corpus(seed=cfg.seed), tokenizer, cfg.seq_length)
    batches = iter(DilocoBatcher(
        rows, num_workers=cfg.num_workers, grad_accum=cfg.grad_accum,
        per_device_batch=cfg.per_device_batch_size, seed=cfg.seed,
    ))
    dl = Diloco(model_cfg, DilocoConfig(
        num_workers=cfg.num_workers, inner_steps=cfg.inner_steps,
        warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps, lr=cfg.lr,
        outer_lr=cfg.outer_lr, grad_accum=cfg.grad_accum,
    ), device)
    on_cuda = device.type == "cuda"
    state = dl.init_state(torch.Generator(device=device).manual_seed(cfg.seed))
    if on_cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    launches0 = launch_counts()

    losses: list[list[float]] = []
    round_seconds: list[float] = []
    snapshot_changed: list[bool] = []
    for r in range(cfg.total_steps // cfg.inner_steps):
        before = _fingerprint(state.snapshot)
        t0 = time.perf_counter()
        round_batches = [next(batches) for _ in range(cfg.inner_steps)]
        tokens = np.stack([b[0] for b in round_batches])
        mask = np.stack([b[1] for b in round_batches])
        state, round_losses = dl.round_step(state, tokens, mask)
        round_losses = round_losses.cpu().tolist()  # waits for the device
        round_seconds.append(time.perf_counter() - t0)
        snapshot_changed.append(_fingerprint(state.snapshot) != before)
        losses.extend(round_losses)
        if not cfg.quiet:
            print(json.dumps({"round": r, "step": state.inner_step_count,
                              "loss": round_losses[-1], "seconds": round_seconds[-1]}),
                  flush=True)

    tokens_per_step = (cfg.num_workers * cfg.grad_accum * cfg.per_device_batch_size
                       * cfg.seq_length)
    n_tokens = tokens_per_step * cfg.total_steps
    after_first = round_seconds[1:]
    return {
        "device": str(device),
        "device_name": torch.cuda.get_device_name(device) if on_cuda else "cpu",
        "model": model_cfg.to_dict(),
        "num_params": model_cfg.num_params(),
        "steps": cfg.total_steps,
        "rounds": len(round_seconds),
        "losses": losses,
        "snapshot_changed": snapshot_changed,
        "tokens": n_tokens,
        "seconds": sum(round_seconds),
        "round_seconds": round_seconds,
        "tokens_per_sec": n_tokens / sum(round_seconds),
        "tokens_per_sec_after_first_round": (
            tokens_per_step * cfg.inner_steps * len(after_first) / sum(after_first)
            if after_first else None
        ),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if on_cuda else None,
        "kernel_launches": {
            k: v - launches0[k] for k, v in launch_counts().items()
        },
    }
