"""Held-out evaluation of the DiLoCo snapshot (the merged global model):
port of ``nanodiloco_tpu/training/evaluate.py``.

Token-weighted cross-entropy over a held-out slice of the corpus,
computed on the snapshot — the parameters the outer optimizer maintains,
i.e. "the model" DiLoCo produces — not any single worker's replica. The
snapshot is unstacked; ``causal_lm_loss`` runs it as a worker axis of 1
(a view, no copy) through the same forward as training, in training's
compute dtype, so on the card every layer launches the flash forward
(B1) once per batch. The JAX module's ring-attention branch has no
counterpart: the port has no ring attention.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import Params, causal_lm_loss, resolve_device


class Evaluator:
    """Loss-only pass over held-out batches, reusable across evals."""

    def __init__(self, model_cfg: LlamaConfig, device: str | torch.device = "cuda"):
        self.cfg = model_cfg
        self.device = resolve_device(device)

    @torch.no_grad()
    def __call__(self, params: Params, batches) -> dict[str, float]:
        """``batches``: iterable of ([B, S] tokens, [B, S] mask) pairs.
        Returns {"eval_loss", "eval_perplexity", "eval_tokens"}."""
        total_loss, total_n = 0.0, 0.0
        for tokens, mask in batches:
            tokens = torch.as_tensor(tokens).to(self.device, torch.long)
            mask = torch.as_tensor(mask).to(self.device, torch.long)
            _, aux = causal_lm_loss(params, tokens, self.cfg, loss_mask=mask)
            total_loss += float(aux["sum_loss"])
            total_n += float(aux["n_tokens"])
        loss = total_loss / max(total_n, 1.0)
        return {
            "eval_loss": loss,
            "eval_perplexity": math.exp(min(loss, 50.0)),
            "eval_tokens": total_n,
        }


def holdout_batches(
    rows: np.ndarray, batch_size: int, mask_rows: np.ndarray | None = None
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Chunk held-out rows [N, S] into full [B, S] eval batches.
    ``mask_rows`` carries pad masks for the padded data layout; packed
    rows default to all-ones."""
    n = (len(rows) // batch_size) * batch_size
    return [
        (
            rows[i : i + batch_size],
            mask_rows[i : i + batch_size]
            if mask_rows is not None
            else np.ones((batch_size, rows.shape[1]), np.int32),
        )
        for i in range(0, n, batch_size)
    ]
