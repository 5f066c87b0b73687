"""Continuous-batching inference serving: port of ``nanodiloco_tpu/serve``.

- ``InferenceEngine`` (engine.py): the slot engine over a dense KV cache
  or a paged block arena (float or int8) — chunked prefill bucketed to
  powers of two, one decode tick for every live slot, prompt-lookup
  speculative decoding, the shared-prefix cache, hot weight swap and KV
  shipping.
- ``Scheduler`` (scheduler.py): admission queue, priorities and
  deadlines, the tick loop's bookkeeping; jax-free, copied.
- ``ServeServer`` (server.py): the stdlib HTTP front end —
  ``POST /v1/generate``, ``GET /healthz``, ``GET /metrics``.
- ``PrefixCache``, ``BlockPool``, ``PromptLookupProposer``
  (speculation.py), ``kvship`` and the client helpers, copied.

Tensor-parallel serving is not ported yet (ROADMAP.md, Queue A item 7).
"""

from nanodiloco_tpu_torch.serve.block_pool import BlockPool, BlocksExhausted
from nanodiloco_tpu_torch.serve.client import http_get, http_post_json
from nanodiloco_tpu_torch.serve.engine import InferenceEngine
from nanodiloco_tpu_torch.serve.kvship import ShipFormatError, ShipMismatchError, ShippedKV
from nanodiloco_tpu_torch.serve.prefix_cache import PrefixCache
from nanodiloco_tpu_torch.serve.scheduler import (
    ControlHandle,
    GenRequest,
    QueueFull,
    Scheduler,
    Ticket,
)
from nanodiloco_tpu_torch.serve.server import ServeServer

__all__ = [
    "BlockPool", "BlocksExhausted", "ControlHandle", "GenRequest", "InferenceEngine",
    "PrefixCache", "QueueFull", "Scheduler", "ServeServer", "ShipFormatError",
    "ShipMismatchError", "ShippedKV", "Ticket", "http_get", "http_post_json",
]
