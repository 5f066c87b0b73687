"""Cost analytics: what one training step should cost, in FLOPs per token.

Port of ``nanodiloco_tpu/obs/costs.py``. The train loop logs one
``{"cost_analysis": {...}}`` JSONL record at startup, and ``report
cost``, ``summarize_run`` and the ``mfu_analytic`` gate of ``report
compare`` read it back against the measured tokens/s.

Where the JAX package asks XLA's cost model about the lowered program,
the port counts one microbatch's forward and backward with
``torch.utils.flop_counter.FlopCounterMode`` on the ``meta`` device
(``microbatch_flops``): no memory is allocated and nothing runs on the
card, so the probe stays off the training peak. Attention goes through
its plain PyTorch version (dense): the flash kernels are a custom
autograd Function whose CUDA launches the counter cannot see. The count
covers what the step executes: the per-layer recompute under ``remat``
included, as XLA's count of the JAX program does. Eager PyTorch has no
compiled round to bill, so the record has no ``flops_billed`` /
``bytes_accessed_billed``.

The card's peak is the data-sheet dense bf16 tensor-core rate, by the
name ``torch.cuda.get_device_name`` gives; ``BENCH_PEAK_TFLOPS``
overrides it. The CPU, or a card not in the table, gives None: no MFU
is reported against a made-up ceiling.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

# dense bf16 tensor-core TFLOP/s by device-name substring, lowercase;
# the first match wins, so the PCIe card comes before the SXM one
PEAK_TFLOPS_BY_KIND = [
    ("h100 pcie", 756.0),
    ("h100", 989.0),
]


def detect_peak_tflops(device: str | torch.device | None = None) -> tuple[float | None, str]:
    """(bf16 peak TFLOP/s of one device or None, its name) for ``device``
    (the current CUDA device when None and a card is present, else the
    CPU)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    if env:
        return float(env), kind
    low = kind.lower()
    for sub, peak in PEAK_TFLOPS_BY_KIND:
        if sub in low:
            return peak, kind
    return None, kind


def train_flops_per_token(cfg, seq: int, moe_tokens: int | None = None) -> float:
    """Matmul FLOPs per trained token, fwd+bwd (3x fwd): 6 x matmul
    params (embedding lookup excluded, lm_head included) plus attention
    scores/values 12*L*S*d (non-causal convention). For MoE, executed
    FLOPs means (a) the expert FFN counts the slots actually COMPUTED
    (dense dispatch runs E x C = k x capacity_factor slot-passes per
    token), not all E experts' parameters, and (b) the dense
    dispatch/combine one-hot einsums are counted too (``moe_tokens`` =
    the T = batch x seq the [T, E, C] routing tensors span; defaults to
    ``seq``)."""
    matmul_params = cfg.num_params() - cfg.vocab_size * cfg.hidden_size
    out = 12.0 * cfg.num_hidden_layers * seq * cfg.hidden_size
    if cfg.num_experts:
        d, f = cfg.hidden_size, cfg.intermediate_size
        kcf = cfg.num_experts_per_tok * cfg.expert_capacity_factor
        all_experts = 3 * cfg.num_experts * d * f
        matmul_params += cfg.num_hidden_layers * (3 * d * f * kcf - all_experts)
        t = moe_tokens if moe_tokens is not None else seq
        out += 12.0 * cfg.num_hidden_layers * kcf * t * d
    return 6.0 * matmul_params + out


def microbatch_flops(params, model_cfg, batch_shape: tuple[int, int]) -> float:
    """FLOPs of one microbatch's forward and backward (``causal_lm_loss``
    on ``batch_shape`` = [B, S] tokens) counted on the ``meta`` device,
    with the parameter shapes and dtypes of ``params`` (one worker's
    tree) and attention through its plain version. An MoE layer counts
    what it runs: dense dispatch its E x C slots; ragged dispatch its k·T
    rows, spread evenly over the experts (the meta device has no data to
    route by, and the grouped matmuls' FLOPs depend only on the row
    count)."""
    from torch.utils.flop_counter import FlopCounterMode

    from nanodiloco_tpu_torch.models.llama import causal_lm_loss, tree_map

    cfg = dataclasses.replace(model_cfg, attention_impl="dense")
    meta = tree_map(lambda p: torch.empty(tuple(p.shape), dtype=p.dtype, device="meta",
                                          requires_grad=True), params)
    tokens = torch.zeros(batch_shape, dtype=torch.long, device="meta")
    counter = FlopCounterMode(display=False)
    with counter:
        loss, _ = causal_lm_loss(meta, tokens, cfg)
        loss.backward()
    return float(counter.get_total_flops())


def build_cost_record(
    *,
    program: str,
    probe: dict[str, float] | None = None,
    probe_tokens: int = 0,
    num_devices: int = 1,
    model_cfg=None,
    seq: int | None = None,
    moe_tokens: int | None = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """The one-time ``cost_analysis`` JSONL record (the JAX keys the port
    has): the probe's ``flops`` over ``tokens_counted`` tokens and their
    ratio ``flops_per_token``, the hand formula at the same shapes
    (``flops_per_token_hand``), and the device's peak and name known at
    capture time (a JSONL read elsewhere must not need the card to
    compute MFU)."""
    rec: dict[str, Any] = {"program": program, "num_devices": int(num_devices)}
    if probe and probe_tokens > 0 and "flops" in probe:
        rec["flops"] = probe["flops"]
        rec["tokens_counted"] = int(probe_tokens)
        rec["flops_per_token"] = probe["flops"] / probe_tokens
    if model_cfg is not None and seq:
        rec["flops_per_token_hand"] = train_flops_per_token(model_cfg, seq,
                                                            moe_tokens=moe_tokens)
    try:
        peak, kind = detect_peak_tflops(device)
    except Exception:
        peak, kind = None, "unknown"
    if peak:
        rec["peak_tflops"] = peak
    rec["device_kind"] = kind
    return rec


def analytic_mfu(
    cost: dict[str, Any], tokens_per_sec: float
) -> float | None:
    """Measured global tokens/sec x the program's analytic FLOPs/token,
    against the captured per-device peak x device count. None when the
    record lacks a peak (CPU, unknown card) — no fake ceilings."""
    fpt = cost.get("flops_per_token")
    peak = cost.get("peak_tflops")
    n_dev = cost.get("num_devices") or 1
    if not (fpt and peak and tokens_per_sec and tokens_per_sec > 0):
        return None
    return tokens_per_sec * fpt / (n_dev * peak * 1e12)
