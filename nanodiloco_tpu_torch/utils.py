"""Run naming and device memory readout: the parts of
``nanodiloco_tpu/utils/utils.py`` the training loop uses.

``create_run_name`` is copied. ``device_memory_stats`` reads
``torch.cuda.memory_stats`` under the JAX package's key names, and is
empty on the CPU, as the JAX one is on a backend without memory stats.
"""

from __future__ import annotations

import uuid
from datetime import datetime

import torch


def device_memory_stats(device: torch.device) -> dict[str, int]:
    """{"hbm_bytes_in_use": ..., "hbm_peak_bytes": ...} of ``device``'s
    caching allocator (bytes held by live tensors, and their peak since
    the last ``reset_peak_memory_stats``), or {} on the CPU."""
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "hbm_bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "hbm_peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
    }


def create_run_name(
    experiment_type: str, node_config: dict | None = None, is_debug: bool = False
) -> str:
    """Hierarchical run name ``{type}_n{N}_{loc}_{MMDD_HHMM}_{uuid8}``."""
    node_config = node_config or {}
    parts = [experiment_type]
    if node_config.get("nodes"):
        parts.append(f"n{node_config['nodes']}")
    if node_config.get("location"):
        parts.append(str(node_config["location"]))
    parts.append(datetime.now().strftime("%m%d_%H%M"))
    if is_debug:
        parts.insert(0, "debug")
    return "_".join(parts) + f"_{str(uuid.uuid4())[:8]}"
