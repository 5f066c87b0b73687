"""Mixture-of-Experts MLP: port of ``nanodiloco_tpu/models/moe.py``.

The same routing functions under the same names, in the port's worker
layout: hidden states ``[W, B, S, d]``, ``router [W, d, E]`` and the
expert weights ``w_gate``/``w_up [W, E, d, f]``, ``w_down [W, E, f, d]``
of one layer. Routing, capacity, the dropped tokens and the load-balance
statistics are per worker: T = B·S of ONE worker, never W·B·S, so each
worker routes exactly as a JAX call on its own batch does.

- Token-choice (Switch) routing, top-k per token, the router in float32
  and the load-balance term ``E · Σ_e f_e · P_e``. Dense dispatch gives
  each expert ``C = ceil(k·T/E · capacity_factor)`` slots, filled in
  slot-major arrival order (every token's first choice before any second
  choice); an assignment past its expert's capacity is dropped and the
  residual stream carries the token.
- Ragged dispatch (``moe_dispatch="ragged"``): the (token, slot)
  assignments sorted by expert, the SwiGLU as grouped matmuls over each
  expert's contiguous run. No capacity, nothing dropped.
- Expert-choice routing (``router_type="experts_choose"``): each expert
  takes its top-C tokens by affinity.

The JAX module routes through one-hot einsums (``[T, k, E, C]`` and
``[T, E, C]``) that XLA fuses away; eager PyTorch would build them and
keep them for the backward (1.3 GB and 0.7 GB per layer and worker at
T = 8192, E 8, C 2560). This module keeps the semantics and moves rows by
index instead: the arrival positions come from an integer cumsum, each
kept assignment names one slot of ``[E, C, d]``, and the combine gathers
each token's k slots back. Every row move is a gather in both directions
(``_Rows``: its backward gathers with the inverse map), so nothing here
adds with atomics and a run repeats bit for bit on the card.

``torch.topk`` promises no order among equal values; ``jax.lax.top_k``
puts the lower index first. ``_top`` is a stable descending sort, which
gives JAX's order: equal bf16 router logits do occur among 8 experts,
and expert-choice pads all tie at affinity 0.

``jax.lax.ragged_dot`` is an XLA op, not a Pallas kernel: its port is a
loop of ``torch.matmul`` over the groups, whose sizes come to the host
(one sync per layer and microbatch).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from nanodiloco_tpu_torch.models.config import LlamaConfig


def expert_capacity(cfg: LlamaConfig, n_tokens: int) -> int:
    """Static per-expert token capacity, ceil(k*T/E * capacity_factor)."""
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    return max(1, math.ceil(n_tokens * k / e * cfg.expert_capacity_factor))


def make_router_stats_fn(cfg: LlamaConfig):
    """The diagnostics probe ``(params, tokens [B, S]) ->
    {"moe_dropped_frac", "moe_router_entropy"}`` (floats, layer means) on
    an unstacked parameter tree: the training loop runs it on the
    snapshot once per outer sync, on one microbatch, so capacity-bound
    dropping or a collapsed router shows in the JSONL. One forward
    without the vocabulary head; the training step is untouched."""

    @torch.no_grad()
    def fn(params, tokens):
        from nanodiloco_tpu_torch.models.llama import forward

        _, _, stats = forward(params, tokens, cfg, with_aux=True, collect_stats=True,
                              return_hidden=True)
        stats = stats.tolist()
        return {"moe_dropped_frac": stats[0], "moe_router_entropy": stats[1]}

    return fn


# ---------------------------------------------------------------------------
# Row moves and grouped matmuls
# ---------------------------------------------------------------------------

def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``src [W, N, D]``, ``idx [W, M]`` in ``[0, N]`` -> ``[W, M, D]``,
    row ``idx`` of each worker's ``src`` and a zero row where ``idx == N``."""
    w, n, d = src.shape
    m = idx.shape[1]
    flat = (idx.clamp(max=n - 1) + n * torch.arange(w, device=idx.device)[:, None]).reshape(-1)
    rows = src.reshape(w * n, d).index_select(0, flat).reshape(w, m, d)
    return torch.where((idx < n)[..., None], rows, torch.zeros((), dtype=src.dtype,
                                                               device=src.device))


class _Rows(torch.autograd.Function):
    """``out[w, m] = src[w, idx[w, m]]`` (a zero row where ``idx == N``);
    ``inv [W, N, R]`` lists the (at most R) rows of ``out`` that read row
    n of ``src`` (``M`` = none). The backward is a gather too,
    ``grad_src[w, n] = Σ_r grad_out[w, inv[w, n, r]]`` summed over r in
    order, where autograd's own backward of a gather would add with
    atomics on the card."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _take(src, idx)

    @staticmethod
    def backward(ctx, grad):
        (inv,) = ctx.saved_tensors
        w, n, r = inv.shape
        g = _take(grad.contiguous(), inv.reshape(w, n * r)).reshape(w, n, r, -1)
        return (g[:, :, 0] if r == 1 else g.sum(2)), None, None


def _mm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``a @ b`` of 2-D tensors. On the CPU a product of one row goes to
    BLAS's matrix-vector routine, which sums in another order than the
    matrix-matrix one: a zero row is added there, so a row's bits do not
    depend on how many rows share its expert (``models/generate.py``'s
    ``_linear`` does the same for the dense layers)."""
    if a.shape[0] == 1 and a.device.type == "cpu":
        r = torch.matmul(torch.cat([a, torch.zeros_like(a)]), b)[:1]
        return r if out is None else out.copy_(r)
    return torch.matmul(a, b) if out is None else torch.matmul(a, b, out=out)


class _GroupedMM(torch.autograd.Function):
    """``x [N, din]`` in contiguous groups of ``sizes`` rows (host ints),
    group g times ``w[g] [din, dout]`` -> ``[N, dout]``: the port of
    ``jax.lax.ragged_dot``, one matmul per non-empty group, in both
    directions (an empty group's weight gradient is zero)."""

    @staticmethod
    def forward(ctx, x, w, sizes):
        ctx.save_for_backward(x, w)
        ctx.sizes = sizes
        out = x.new_empty((x.shape[0], w.shape[2]))
        lo = 0
        for g, n in enumerate(sizes):
            if n:
                _mm(x[lo:lo + n], w[g], out=out[lo:lo + n])
            lo += n
        return out

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        grad = grad.contiguous()
        gx = torch.empty_like(x) if ctx.needs_input_grad[0] else None
        gw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        lo = 0
        for g, n in enumerate(ctx.sizes):
            if n:
                go = grad[lo:lo + n]
                if gx is not None:
                    torch.matmul(go, w[g].transpose(0, 1), out=gx[lo:lo + n])
                if gw is not None:
                    torch.matmul(x[lo:lo + n].transpose(0, 1), go, out=gw[g])
            lo += n
        return gx, gw, None


def _top(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, largest first and the lower
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot of ``idx`` over n classes (built by comparison,
    which the meta device can run; ``F.one_hot`` reads the data)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _router_entropy(probs: torch.Tensor, valid_t: torch.Tensor | None) -> torch.Tensor:
    """Mean per-token router entropy in nats over real tokens, per worker
    ([W, T, E] -> [W]). A healthy router sits well above 0; a collapsed
    one (all mass on one expert) drives it to ~0."""
    ent = -(probs * torch.log(probs.clamp_min(1e-20))).sum(-1)       # [W, T]
    if valid_t is not None:
        v = valid_t.float()
        num, den = (ent * v).sum(-1), v.sum(-1)
    else:
        num, den = ent.sum(-1), torch.full_like(ent[:, 0], ent.shape[1])
    return num / den.clamp_min(1.0)


def _expert_ffn(expert_in: torch.Tensor, layer: dict) -> torch.Tensor:
    """Per-expert SwiGLU over dispatched slots [W, E, C, d] -> [W, E, C, d],
    the FFN body both router types share."""
    wn, e, c, d = expert_in.shape
    cdt = expert_in.dtype

    def bmm(x, w):
        return torch.matmul(x.reshape(wn * e, c, -1), w.to(cdt).reshape(wn * e, *w.shape[2:]))

    gate = F.silu(bmm(expert_in, layer["w_gate"]))
    up = bmm(expert_in, layer["w_up"])
    return bmm(gate * up, layer["w_down"]).reshape(wn, e, c, d)


def _experts_choose(cfg: LlamaConfig, x: torch.Tensor, probs: torch.Tensor, layer: dict,
                    valid_t: torch.Tensor | None):
    """Expert-choice routing (arXiv:2202.09368): each expert selects its
    top-C tokens by router affinity, so every expert runs exactly C slots.
    A token may be picked by several experts (their outputs add) or by
    none (the residual stream carries it). x [W, T, d]; probs [W, T, E];
    valid_t [W, T] or None. Returns (y [W, T, d], aux zeros [W], the
    fraction of real tokens no expert picked [W])."""
    wn, t, d = x.shape
    e = cfg.num_experts
    cap = min(expert_capacity(cfg, t), t)  # an expert can't pick a token twice
    cdt = x.dtype
    dev = x.device
    if valid_t is not None:
        # pad tokens: zero affinity, so sorted last (lowest index first
        # among them) and a zero combine weight when slots outnumber
        # real tokens
        probs = probs * valid_t.float()[..., None]
    g, idx = _top(probs.transpose(1, 2), cap)                        # [W, E, C]
    slot = torch.arange(e * cap, device=dev).reshape(1, e, cap).expand(wn, e, cap)
    # token t's slot under expert e, or E*C where e did not pick it
    inv = torch.full((wn, e, t), e * cap, dtype=torch.long, device=dev)
    inv = inv.scatter(2, idx, slot).transpose(1, 2)                   # [W, T, E]
    expert_in = _Rows.apply(x, idx.reshape(wn, e * cap), inv)
    out_e = _expert_ffn(expert_in.reshape(wn, e, cap, d), layer)
    weighted = (out_e * g.to(cdt)[..., None]).reshape(wn, e * cap, d)
    back = (idx * e + torch.arange(e, device=dev)[:, None]).reshape(wn, e * cap, 1)
    y = _Rows.apply(weighted, inv.reshape(wn, t * e), back).reshape(wn, t, e, d).sum(2)
    # dropped = real tokens picked by NO expert (the residual path carries
    # them); expert-choice's analog of capacity overflow
    picked = (inv < e * cap).any(-1).float()                           # [W, T]
    if valid_t is not None:
        v = valid_t.float()
        dropped = ((1.0 - picked) * v).sum(-1) / v.sum(-1).clamp_min(1.0)
    else:
        dropped = 1.0 - picked.sum(-1) / t
    return y, torch.zeros(wn, device=dev), dropped


def _group_sizes(group: torch.Tensor, n_groups: int) -> list[int]:
    """Rows per group id, on the host (one sync). On the meta device the
    ids hold no data: the rows are spread evenly, which gives the grouped
    matmuls' FLOPs exactly (they depend only on the row count)."""
    n = group.numel()
    if group.device.type == "meta":
        return [n // n_groups + (g < n % n_groups) for g in range(n_groups)]
    return torch.bincount(group, minlength=n_groups).tolist()


def _ragged_mlp(cfg: LlamaConfig, x: torch.Tensor, topk_p: torch.Tensor,
                topk_e: torch.Tensor, layer: dict, valid_t: torch.Tensor | None) -> torch.Tensor:
    """Sorted (ragged) token-choice dispatch, the Mixtral/megablocks
    shape: the [T, k] (token, slot) assignments stable-sorted by expert
    so each expert's rows are one contiguous run, and the SwiGLU as
    grouped matmuls with exact group sizes: no capacity, nothing dropped,
    no padding slots. x [W, T, d]; topk_p / topk_e [W, T, k] normalized
    weights / expert ids. Returns y [W, T, d].

    Every worker's groups come in one sort: the sort key is
    ``w * E + expert``. Pad tokens (valid_t 0) keep their assignment and
    ride through the matmuls with a zero combine weight, as in dense
    dispatch. Against dense dispatch at ample capacity the routing and
    weights are identical; only the order of summation differs."""
    wn, t, d = x.shape
    k, e = topk_e.shape[2], cfg.num_experts
    cdt = x.dtype
    n = wn * t * k
    w_flat = topk_p.reshape(wn, t * k)
    if valid_t is not None:
        w_flat = w_flat * valid_t.to(w_flat.dtype).repeat_interleave(k, dim=1)
    group = (topk_e + e * torch.arange(wn, device=x.device)[:, None, None]).reshape(n)
    order = torch.sort(group, stable=True)[1]                         # expert-contiguous
    pos = torch.empty_like(order).scatter_(0, order, torch.arange(n, device=x.device))
    sizes = _group_sizes(group, wn * e)
    # assignment i reads token row i // k; token row r's k assignments sit
    # at pos[r * k + j] of the sorted order
    xg = _Rows.apply(x.reshape(1, wn * t, d), (order // k)[None], pos.reshape(1, wn * t, k))[0]

    def weights(name):
        w = layer[name].to(cdt)
        return w.reshape(wn * e, *w.shape[2:])

    gate = F.silu(_GroupedMM.apply(xg, weights("w_gate"), sizes))
    up = _GroupedMM.apply(xg, weights("w_up"), sizes)
    out = _GroupedMM.apply(gate * up, weights("w_down"), sizes)       # [kT, d] sorted
    out = _Rows.apply(out[None], pos[None], order.reshape(1, n, 1))[0]      # back to (token, slot)
    return (out.reshape(wn, t, k, d) * w_flat.to(cdt).reshape(wn, t, k, 1)).sum(2)


def moe_mlp(cfg: LlamaConfig, h: torch.Tensor, layer: dict, valid: torch.Tensor | None = None,
            sp_axis: str | None = None, with_stats: bool = False):
    """h [W, B, S, d] normed hidden states; ``layer`` carries ``router``
    [W, d, E] and the expert weights ``w_gate``/``w_up`` [W, E, d, f],
    ``w_down`` [W, E, f, d]; ``valid`` [W, B, S] 0/1 marks real tokens:
    padding claims no expert capacity and leaves the aux statistics.
    Returns (mlp_out [W, B, S, d], aux [W]) and, with ``with_stats``,
    also stats [W, 2] = [dropped_frac, router_entropy] (the diagnostics
    channel; dropped is exact: it counts assignments). Routing is top-k
    per token, or expert-choice with ``cfg.router_type ==
    "experts_choose"``; every quantity is per worker.

    ``sp_axis`` (routing over a sequence-sharded region) waits for the
    port's sequence parallelism, ROADMAP Queue A item 7."""
    if sp_axis is not None:
        raise NotImplementedError(
            "MoE under sequence parallelism is not ported yet (ROADMAP.md, Queue A item 7)")
    wn, b, s, d = h.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cdt = h.dtype
    t = b * s
    dev = h.device
    x = h.reshape(wn, t, d)
    v_t = None if valid is None else valid.reshape(wn, t)

    router = layer["router"].to(cdt)
    # one worker (the serving path): a 2-D product, row-count invariant
    logits = (_mm(x[0], router[0])[None] if wn == 1
              else torch.matmul(x, router)).float()                   # [W, T, E]
    probs = torch.softmax(logits, dim=-1)
    if cfg.router_type == "experts_choose":
        y, aux, dropped = _experts_choose(cfg, x, probs, layer, v_t)
        if with_stats:
            stats = torch.stack([dropped, _router_entropy(probs, v_t)], dim=-1)
            return y.reshape(wn, b, s, d), aux, stats
        return y.reshape(wn, b, s, d), aux
    topk_p, topk_e = _top(probs, k)                                   # [W, T, k]
    topk_p = topk_p / topk_p.sum(-1, keepdim=True)
    v = None if v_t is None else (v_t > 0)

    if cfg.moe_dispatch == "ragged":
        y = _ragged_mlp(cfg, x, topk_p, topk_e, layer, v_t)
        kept = None                                                   # every assignment
    else:
        cap = expert_capacity(cfg, t)
        # slot-major assignments a = j*T + t (slot 0 claims capacity
        # first); its position in its expert's queue is the count of
        # earlier assignments to that expert, an integer cumsum
        e_sm = topk_e.transpose(1, 2).reshape(wn, k * t)
        live = torch.ones_like(e_sm, dtype=torch.bool) if v is None else v.repeat(1, k)
        # [W, E, kT]: the scan runs along the innermost axis (an outer-axis
        # scan of [W, kT, E] took 17 ms a step on the card)
        onehot = (e_sm[:, None, :] == torch.arange(e, device=dev)[:, None]) & live[:, None, :]
        pos = onehot.cumsum(-1, dtype=torch.int32).gather(1, e_sm[:, None, :])[:, 0] - 1
        keep = live & (pos < cap)
        kept = keep.sum(-1)
        # the kept assignment's slot in [E*C]; E*C marks a dropped one
        dest = torch.where(keep, e_sm * cap + pos, e * cap)           # [W, kT]
        arrival = torch.full((wn, e * cap + 1), k * t, dtype=torch.long, device=dev)
        arrival = arrival.scatter(1, dest, torch.arange(k * t, device=dev).expand(wn, k * t))
        arrival = arrival[:, :e * cap]                                # slot -> a, or kT
        tok_of_slot = torch.where(arrival < k * t, arrival % t, t)
        inv_tok = dest.reshape(wn, k, t).transpose(1, 2)              # token -> its k slots
        expert_in = _Rows.apply(x, tok_of_slot, inv_tok)
        out_e = _expert_ffn(expert_in.reshape(wn, e, cap, d), layer).reshape(wn, e * cap, d)
        y_sm = _Rows.apply(out_e, dest, arrival[..., None])                 # [W, kT, d]
        comb = (topk_p.transpose(1, 2).reshape(wn, k * t) * keep).to(cdt)
        y = (y_sm * comb[..., None]).reshape(wn, k, t, d).sum(1)

    # Switch load-balance loss on the top-1 assignment (pre-capacity),
    # statistics over real tokens only
    top1 = _one_hot(topk_e[..., 0], e)                                # [W, T, E]
    if v is not None:
        vf = v.float()
        num_f = (top1 * vf[..., None]).sum(1)
        num_p = (probs * vf[..., None]).sum(1)
        den = vf.sum(1)
    else:
        num_f, num_p = top1.sum(1), probs.sum(1)
        den = torch.full((wn,), float(t), device=dev)
    den = den.clamp_min(1.0)[:, None]
    aux = e * ((num_f / den) * (num_p / den)).sum(-1)
    if with_stats:
        # dropped = (token, slot) assignments past their expert's capacity
        assigned = k * (torch.full((wn,), float(t), device=dev) if v is None
                        else v.float().sum(-1))
        kept_f = assigned if kept is None else kept.float()
        dropped = 1.0 - kept_f / assigned.clamp_min(1.0)
        stats = torch.stack([dropped, _router_entropy(probs, v_t)], dim=-1)
        return y.reshape(wn, b, s, d), aux, stats
    return y.reshape(wn, b, s, d), aux
