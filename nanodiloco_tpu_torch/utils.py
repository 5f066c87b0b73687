"""Run naming and device memory readout: the parts of
``nanodiloco_tpu/utils/utils.py`` the training loop uses.

``create_run_name`` is copied; ``resolve_run_name`` makes the ranks of a
process group agree on rank 0's. ``device_memory_stats`` reads
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


def resolve_run_name(local_name: str, max_len: int = 128) -> str:
    """One run name for every rank of a process group: rank 0's name
    bytes, broadcast as a ``uint8`` tensor (``create_run_name`` embeds a
    per-process timestamp and uuid, so each rank would derive its own: N
    JSONL files for one job). Without a group: ``local_name``.

    The buffer is read back as ``uint8`` whatever the collective returns
    (the JAX package saw a backend return it upcast to int32, whose bytes
    interleave three NULs per character and make the name an invalid
    filename)."""
    import torch.distributed as dist

    from nanodiloco_tpu_torch.parallel.mesh import WorkerMesh

    if not (dist.is_available() and dist.is_initialized()):
        return local_name
    enc = local_name.encode()[:max_len]
    buf = torch.zeros(max_len, dtype=torch.uint8)
    buf[: len(enc)] = torch.frombuffer(bytearray(enc), dtype=torch.uint8)
    mesh = WorkerMesh.current(dist.get_world_size())
    out = mesh.broadcast_(buf, tag="run_name").to(torch.uint8)
    return bytes(out.tolist()).rstrip(b"\x00").decode(errors="replace")
