"""Model configuration: a copy of ``nanodiloco_tpu/models/config.py``.

The same fields and defaults, so the repository's ``configs/*.json`` and
the ``TINY_LLAMA`` / ``LLAMA3_8B`` presets load unchanged. ``dtype`` is
the compute dtype and ``param_dtype`` the master-weight dtype, both as
names ("float32", "bfloat16"). ``num_experts > 0`` makes every MLP a
Mixture-of-Experts layer (``models/moe.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 128
    intermediate_size: int = 512
    num_hidden_layers: int = 6
    num_attention_heads: int = 4
    num_key_value_heads: int | None = None  # None -> MHA (== num_attention_heads)
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    dtype: str = "float32"          # activation/compute dtype
    param_dtype: str = "float32"    # master parameter dtype
    remat: bool = False             # recompute each decoder layer in backward
    remat_policy: str = "nothing"   # "nothing" | "dots"
    attention_impl: str = "dense"   # "dense" | "flash" | "ring"
    # rows per chunk of the blockwise cross-entropy (ops/fused_ce.py);
    # 0 = materialize the full logits
    loss_chunk: int = 512
    num_experts: int = 0
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_type: str = "tokens_choose"
    moe_dispatch: str = "dense"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_heads(self) -> int:
        if self.num_key_value_heads is None:
            return self.num_attention_heads
        return self.num_key_value_heads

    def __post_init__(self) -> None:
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide evenly by num_attention_heads")
        if self.num_key_value_heads is not None and self.num_key_value_heads < 1:
            raise ValueError("num_key_value_heads must be >= 1 (or None for MHA)")
        if self.num_attention_heads % self.kv_heads:
            raise ValueError("num_attention_heads must divide evenly by num_key_value_heads")
        if self.remat_policy not in ("nothing", "dots"):
            raise ValueError(
                f"remat_policy must be 'nothing' or 'dots'; got {self.remat_policy!r}"
            )
        if self.router_type not in ("tokens_choose", "experts_choose"):
            raise ValueError(
                "router_type must be 'tokens_choose' or 'experts_choose'; "
                f"got {self.router_type!r}"
            )
        if self.num_experts and self.num_experts_per_tok > self.num_experts:
            raise ValueError(
                f"num_experts_per_tok ({self.num_experts_per_tok}) cannot "
                f"exceed num_experts ({self.num_experts})"
            )
        if self.moe_dispatch not in ("dense", "ragged"):
            raise ValueError(
                f"moe_dispatch must be 'dense' or 'ragged'; got {self.moe_dispatch!r}"
            )
        if self.moe_dispatch == "ragged" and self.router_type != "tokens_choose":
            raise ValueError("moe_dispatch='ragged' supports tokens_choose routing only")

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LlamaConfig":
        """Build from an HF-style config dict, ignoring unknown keys."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, path: str) -> "LlamaConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def num_params(self) -> int:
        """Exact parameter count (embedding + layers + final norm + head)."""
        d, f, v, l = (self.hidden_size, self.intermediate_size,
                      self.vocab_size, self.num_hidden_layers)
        hd, nh, nkv = self.head_dim, self.num_attention_heads, self.kv_heads
        if self.num_experts:
            mlp = d * self.num_experts + 3 * self.num_experts * d * f
        else:
            mlp = 3 * d * f
        per_layer = d * nh * hd + 2 * d * nkv * hd + nh * hd * d + mlp + 2 * d
        head = 0 if self.tie_word_embeddings else d * v
        return v * d + l * per_layer + d + head


TINY_LLAMA = LlamaConfig()

LARGE_LLAMA = LlamaConfig(
    hidden_size=256, intermediate_size=1024, num_attention_heads=8, num_hidden_layers=12
)

# Llama-3-8B width with the memory-lean policy: bf16 compute over f32
# master weights, per-layer recompute, flash attention (GQA-native, 32
# query / 8 KV heads never expanded) and chunked cross-entropy over the
# 128k vocabulary.
LLAMA3_8B = LlamaConfig(
    vocab_size=128256,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    max_position_embeddings=8192,
    rope_theta=500000.0,
    dtype="bfloat16",
    remat=True,
    attention_impl="flash",
)
