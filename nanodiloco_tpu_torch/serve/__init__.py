"""Continuous-batching inference serving: port of the dense half of
``nanodiloco_tpu/serve``.

- ``InferenceEngine`` (engine.py): the slot engine over one dense KV
  cache — chunked prefill bucketed to powers of two, one decode tick for
  every live slot, the shared-prefix cache.
- ``Scheduler`` (scheduler.py): admission queue, priorities and
  deadlines, the tick loop's bookkeeping; jax-free, copied.
- ``ServeServer`` (server.py): the stdlib HTTP front end —
  ``POST /v1/generate``, ``GET /healthz``, ``GET /metrics``.
- ``PrefixCache``, ``BlockPool``, ``kvship`` and the client helpers,
  copied.

The paged arena, int8 KV, speculative decoding, tensor parallelism,
weight swaps and KV shipping are not ported yet (ROADMAP.md, Queue A).
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
