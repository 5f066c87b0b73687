"""Analytic MFU from a run's cost record: what ``summarize_run`` reads.

The reader half of ``nanodiloco_tpu/obs/costs.py`` (jax-free; the JAX
package's ``__init__`` imports jax, so the port keeps its own). The port
writes no ``cost_analysis`` record yet (the analytic FLOPs from shapes
wait for ROADMAP Queue A item 5), so this only summarizes a JAX run's
JSONL the same way through either package.
"""

from __future__ import annotations

from typing import Any


def analytic_mfu(
    cost: dict[str, Any], tokens_per_sec: float
) -> float | None:
    """Measured global tokens/sec x the program's analytic FLOPs/token,
    against the captured per-chip peak x device count. None when the
    record lacks a peak (CPU mesh, unknown kind) — no fake ceilings."""
    fpt = cost.get("flops_per_token")
    peak = cost.get("peak_tflops")
    n_dev = cost.get("num_devices") or 1
    if not (fpt and peak and tokens_per_sec and tokens_per_sec > 0):
        return None
    return tokens_per_sec * fpt / (n_dev * peak * 1e12)
