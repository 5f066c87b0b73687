"""Memory-efficient causal attention: the framework-facing dispatcher.

Port of ``nanodiloco_tpu/ops/flash_attention.py``. A CUDA tensor goes
through the hand-written kernels (``ops/cuda/flash_attention.py``); if a
kernel cannot take it, that raises. A CPU tensor runs the same autograd
``Function`` with each kernel's plain PyTorch version (blockwise online
softmax, O(S x block) memory). There is no other path.

The JAX package's Pallas tile knobs (``NANODILOCO_PALLAS_BLOCK_Q/K``)
tune TPU tiles and are not ported: the CUDA tiles are the kernel's own
constants.
"""

from __future__ import annotations

import torch

from nanodiloco_tpu_torch.ops.cuda.flash_attention import cuda_flash_attention


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    block_size: int = 512,
    impl: str | None = None,
) -> torch.Tensor:
    """q: [B, S, H, hd]; k, v: [B, S, Hkv, hd] with H % Hkv == 0 (GQA:
    K/V are not expanded). Returns [B, S, H, hd].

    ``block_size`` and ``impl`` keep the JAX signature: ``impl`` may be
    None or "cuda" (the kernels), and the kernels' tiles are fixed, so
    ``block_size`` only has to be positive."""
    if q.shape[2] % k.shape[2]:
        raise ValueError(
            f"query heads {q.shape[2]} must divide by kv heads {k.shape[2]}"
        )
    if impl not in (None, "cuda"):
        raise ValueError(f"unknown flash attention impl: {impl!r}")
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    return cuda_flash_attention(q, k, v, causal=causal)
