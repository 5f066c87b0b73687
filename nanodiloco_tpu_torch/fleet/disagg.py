"""Disaggregated prefill/decode serving: the tiered fleet layer.

DistServe (arXiv:2401.09670) and Splitwise (arXiv:2311.18677) observed
that prefill and decode are different workloads — prefill is one big
compute-bound batch, decode is thousands of tiny latency-bound ticks —
and co-locating them makes every long prompt stretch every live
stream's inter-token latency (the engine's
``decode_interference_ratio`` gauge measures exactly this). The
structural fix: run them on SEPARATE replicas and ship the prefilled
KV cache between them. This module is that fleet layer, built on the
pieces that already exist:

- replicas declare a role (``serve --role prefill|decode|both``) in
  their health bodies; the base router's picker and capacity census
  are tier-aware (``FleetRouter.pick(tier=...)``,
  ``tier_capacity_names``);
- ``DisaggRouter`` reroutes ``/v1/generate``: admission goes to the
  least-loaded PREFILL replica as ``prefill_only`` (the stream
  finishes at its first token and the slot parks), the parked KV rows
  come back through ``/admin/kv/export`` (serve/kvship.py wire
  format), and the payload lands on the least-loaded DECODE replica
  via ``/admin/kv/import``, which resumes the stream mid-request and
  answers with the finished result. Any failure along the handoff —
  prefill unreachable, export 404 (park TTL fired), import 409/429 —
  degrades to ONE honest fallback: a plain monolithic generate on the
  decode tier (re-prefilling there), so a blackholed prefill replica
  costs latency, never a dropped stream;
- ``TierAutoscaler`` / ``DisaggAutoscaler`` scale the tiers
  INDEPENDENTLY: each tier gets its own ``CapacityModel`` pinned every
  tick to that tier's usable replicas (``set_targets`` — an
  open-breaker or draining prefill replica never counts toward decode
  capacity), and the PR-15 fleet burn signals route by name: a TTFT
  burn votes the prefill tier out, a decode-throughput burn votes the
  decode tier out.

Parity bar (pinned by tests/test_disagg.py and the chip_agenda disagg
phase): a disaggregated stream is bit-identical to solo ``generate()``
— the ship format moves the same bits attention would have read
locally, and the PRNG schedule is seed-derived so no sampler state is
lost at the boundary.
"""

from __future__ import annotations

import http.client

from nanodiloco_tpu_torch.fleet.autoscaler import Autoscaler
from nanodiloco_tpu_torch.fleet.router import FleetRouter
from nanodiloco_tpu_torch.obs.forecast import CapacityEstimate
from nanodiloco_tpu_torch.obs.telemetry import Histogram

__all__ = ["DisaggRouter", "TierAutoscaler", "DisaggAutoscaler"]

#: fleet-scope SLO rule-name keywords that vote a tier out: a TTFT burn
#: is prefill starvation (admissions waiting on prompt compute), a
#: decode-throughput burn is decode starvation (ticks behind demand)
PREFILL_BURN_KEYWORDS = ("ttft",)
DECODE_BURN_KEYWORDS = ("decode", "tokens_per_sec")

_WIRE_ERRORS = (OSError, ValueError, http.client.HTTPException)


def _ship_payload_bytes(ship: dict) -> int:
    """Raw (pre-base64) KV bytes in a packed ship doc — the router's
    side of the ship-bytes meter, without decoding the payload."""
    n = 0
    for f in ("k", "v", "ks", "vs"):
        v = ship.get(f)
        if isinstance(v, str):
            n += (len(v) * 3) // 4
    return n


class DisaggRouter(FleetRouter):
    """FleetRouter that splits each request across the tiers.

    Drop-in: with no prefill-tier replica ready (or no decode tier),
    every request takes the base monolithic path unchanged — a fleet
    of ``role=both`` replicas behind a DisaggRouter behaves exactly
    like one behind a FleetRouter. ``handoff_timeout_s`` bounds the
    prefill and export legs (the decode leg runs under the normal
    request timeout: it IS the request)."""

    def __init__(self, replicas, *, handoff_timeout_s: float = 60.0,
                 **kw) -> None:
        super().__init__(replicas, **kw)
        if handoff_timeout_s <= 0:
            raise ValueError(
                f"handoff_timeout_s must be > 0; got {handoff_timeout_s}"
            )
        self.handoff_timeout_s = float(handoff_timeout_s)
        # handoff accounting (under the router lock): completed
        # handoffs, honest fallbacks (and why), and shipped bytes
        self._disagg = {
            "handoffs": 0,
            "fallbacks": 0,
            "ship_bytes": 0,
        }
        self._fallback_reasons: dict[str, int] = {}
        # prefill-done -> payload-on-decode-replica latency (export
        # round-trip + decode-tier pick; the decode stream itself is
        # excluded — it is the request, not the handoff)
        self.hist_handoff = Histogram()

    # -- the two-phase request path ------------------------------------------

    def handle_generate(self, doc: dict) -> tuple[int, dict]:
        # a client explicitly driving the prefill-only protocol (e.g.
        # the chip_agenda harness exporting by hand) bypasses the
        # router's own handoff
        if doc.get("prefill_only"):
            return super().handle_generate(doc)
        rid = doc.get("request_id")
        if not isinstance(rid, str) or not rid:
            with self._lock:
                self._req_seq += 1
                rid = f"rtr-{self._req_seq}"
        # disaggregate only when a replica DECLARED the prefill role and
        # a decode tier is live: a fleet of role=both replicas behaves
        # exactly like one behind a FleetRouter (drop-in), and a prefill
        # pick with no decode tier would park KV nobody will ever import
        pf = (self._pick_excluding(set(), tier="prefill")
              if self.tier_counts().get("prefill") else None)
        if pf is None or not self.tier_capacity_names("decode"):
            return super().handle_generate({**doc, "request_id": rid})

        # the disagg route span's causal context: every handoff leg,
        # the fallback, and (through the injected wire context) the
        # replicas' own spans hang under it — one tree per request
        route_ctx = self._accept_trace(doc)

        # phase 1 — prefill-only admission on the prefill tier. The
        # client's timeout_s stays OFF this leg (it is the base
        # router's deadline machinery; the handoff legs run under
        # handoff_timeout_s and any failure falls back honestly).
        fwd = {k: v for k, v in doc.items() if k != "timeout_s"}
        fwd["request_id"] = rid
        fwd["prefill_only"] = True
        pf_ctx = route_ctx.child() if route_ctx is not None else None
        if pf_ctx is not None:
            fwd["trace_context"] = pf_ctx.to_wire()
        t_req = self._clock()
        t0 = t_req
        with self._lock:
            pf.router_inflight += 1
        try:
            try:
                code, out = self._post(pf.replica, "/v1/generate", fwd,
                                       timeout=self.handoff_timeout_s)
            finally:
                with self._lock:
                    pf.router_inflight -= 1
        except _WIRE_ERRORS:
            # the chaos leg's blackholed-prefill case lands here: mark
            # the replica (health loop owns ejection), re-prefill on
            # the decode tier — one honest retry, zero dropped streams
            with self._lock:
                pf.failures += 1
                pf.set(ready=False)
            self._breaker_note(pf, ok=False,
                               latency_s=max(0.0, self._clock() - t0))
            self._span("handoff_prefill", t0, self._clock(), rid,
                       ctx=pf_ctx, replica=pf.replica.name,
                       outcome="error")
            return self._fallback(doc, rid, "prefill_unreachable",
                                  ctx=route_ctx, t_req=t_req)
        self._breaker_note(pf, ok=code < 500 or code == 503,
                           latency_s=max(0.0, self._clock() - t0))
        self._span("handoff_prefill", t0, self._clock(), rid,
                   ctx=pf_ctx, replica=pf.replica.name, code=code,
                   outcome="ok" if code == 200 else "error")
        if code == 429 and isinstance(out, dict) and out.get("shed"):
            # class-shed stays TERMINAL fleet policy — never rerouted
            self._span("route", t_req, self._clock(), rid,
                       ctx=route_ctx, outcome="shed",
                       replica=pf.replica.name)
            return 429, {**out, "replica": pf.replica.name,
                         "request_id": rid}
        if code != 200 or not isinstance(out, dict):
            return self._fallback(doc, rid, f"prefill_{code}",
                                  ctx=route_ctx, t_req=t_req)
        if out.get("finish_reason") != "prefilled":
            # the stream finished AT its first token (stop token or
            # max_new_tokens == 1): the prefill replica's answer is
            # already complete — nothing to hand off
            out = {**out, "replica": pf.replica.name,
                   "served_by": pf.replica.name}
            out.setdefault("request_id", rid)
            self._span("route", t_req, self._clock(), rid,
                       ctx=route_ctx, outcome="ok",
                       served_by=pf.replica.name)
            return code, out

        # phase 2 — export the parked KV rows + resume cursor
        t_pf_done = self._clock()
        exp_ctx = route_ctx.child() if route_ctx is not None else None
        exp_doc = {"request_id": rid}
        if exp_ctx is not None:
            exp_doc["trace_context"] = exp_ctx.to_wire()
        try:
            ecode, ship = self._post(pf.replica, "/admin/kv/export",
                                     exp_doc,
                                     timeout=self.handoff_timeout_s)
        except _WIRE_ERRORS:
            self._span("handoff_export", t_pf_done, self._clock(), rid,
                       ctx=exp_ctx, replica=pf.replica.name,
                       outcome="error")
            return self._fallback(doc, rid, "export_unreachable",
                                  ctx=route_ctx, t_req=t_req)
        self._span("handoff_export", t_pf_done, self._clock(), rid,
                   ctx=exp_ctx, replica=pf.replica.name, code=ecode,
                   outcome="ok" if ecode == 200 else "error")
        if ecode != 200 or not isinstance(ship, dict):
            # 404 = the park TTL or deadline reclaimed the slot first
            return self._fallback(doc, rid, f"export_{ecode}",
                                  ctx=route_ctx, t_req=t_req)

        # phase 3 — import on the least-loaded decode replica, which
        # resumes the stream and answers with the finished result. A
        # busy 429 tries ONE other decode replica; a 409 (fingerprint
        # mismatch — mixed weight generations mid-push) falls back.
        tried: set[str] = set()
        for _ in range(2):
            dec = self._pick_excluding(tried, tier="decode")
            if dec is None:
                break
            tried.add(dec.replica.name)
            t_imp = self._clock()
            imp_ctx = route_ctx.child() if route_ctx is not None else None
            imp_doc = ship
            if imp_ctx is not None:
                imp_doc = {**ship, "trace_context": imp_ctx.to_wire()}
            with self._lock:
                dec.router_inflight += 1
            try:
                try:
                    icode, iout = self._post(dec.replica,
                                             "/admin/kv/import", imp_doc)
                finally:
                    with self._lock:
                        dec.router_inflight -= 1
            except _WIRE_ERRORS:
                self._breaker_note(dec, ok=False)
                self._span("handoff_import", t_imp, self._clock(), rid,
                           ctx=imp_ctx, replica=dec.replica.name,
                           outcome="error")
                continue
            self._breaker_note(dec, ok=icode < 500)
            self._span("handoff_import", t_imp, self._clock(), rid,
                       ctx=imp_ctx, replica=dec.replica.name, code=icode,
                       outcome=("ok" if icode == 200
                                else "busy" if icode == 429 else "error"))
            if icode == 200 and isinstance(iout, dict):
                with self._lock:
                    self._disagg["handoffs"] += 1
                    self._disagg["ship_bytes"] += _ship_payload_bytes(ship)
                self.hist_handoff.observe(max(0.0, t_imp - t_pf_done))
                self._span("handoff", t_pf_done, t_imp, rid,
                           ctx=(route_ctx.child()
                                if route_ctx is not None else None),
                           prefilled_by=pf.replica.name,
                           decoded_by=dec.replica.name)
                t_done = self._clock()
                self._span("route", t_req, t_done, rid, ctx=route_ctx,
                           outcome="ok", served_by=dec.replica.name,
                           prefilled_by=pf.replica.name)
                # per-phase TTFT waterfall, from the clocks that own
                # each boundary: the prefill replica's own queue/compute
                # split, the router's ship window (export leg + decode
                # pick), and the import leg's admission overhead (wire +
                # KV mapping, the decode work itself subtracted out)
                pf_timing = out.get("timing") or {}
                imp_leg_s = max(0.0, self._clock() - t_imp)
                it = iout.get("timing") or {}
                phases = {}
                if isinstance(pf_timing.get("queued_s"), (int, float)):
                    phases["queue_s"] = round(
                        float(pf_timing["queued_s"]), 6)
                    if isinstance(pf_timing.get("ttft_s"), (int, float)):
                        phases["prefill_s"] = round(max(
                            0.0, float(pf_timing["ttft_s"])
                            - float(pf_timing["queued_s"])), 6)
                phases["ship_s"] = round(max(0.0, t_imp - t_pf_done), 6)
                if isinstance(it.get("total_s"), (int, float)):
                    phases["decode_admission_s"] = round(max(
                        0.0, imp_leg_s - float(it["total_s"])), 6)
                iout = {**iout, "replica": dec.replica.name,
                        "served_by": dec.replica.name,
                        "prefilled_by": pf.replica.name,
                        "disagg": "handoff",
                        # END-TO-END first-token latency: router receipt
                        # to the prefill reply (the first token exists
                        # from then on) — the decode replica's own
                        # timing.ttft_s only covers the resumed stream
                        "handoff_ttft_s": round(t_pf_done - t_req, 6),
                        "handoff_phases": phases}
                iout.setdefault("request_id", rid)
                if route_ctx is not None and route_ctx.sampled:
                    iout.setdefault("trace_id", route_ctx.trace_id)
                return 200, iout
            if icode == 429:
                continue  # this decode replica is full; try another
            break  # 409 mismatch / 400 / 5xx: fall back, don't spray
        return self._fallback(doc, rid, "import_failed",
                              ctx=route_ctx, t_req=t_req)

    def _fallback(self, doc: dict, rid: str, reason: str,
                  ctx=None, t_req: float | None = None) -> tuple[int, dict]:
        """The ONE honest retry: a plain monolithic generate on the
        decode tier (which re-prefills locally). Counted per reason;
        when even that finds no decode replica, the base router's full
        resilience stack is the last resort. ``ctx``/``t_req`` carry
        the disagg route span: each fallback attempt is its own child
        span tagged with the reason, and the route span closes with
        ``outcome="fallback"`` on every path out of here."""
        with self._lock:
            self._disagg["fallbacks"] += 1
            self._fallback_reasons[reason] = (
                self._fallback_reasons.get(reason, 0) + 1
            )
        fwd = {k: v for k, v in doc.items() if k != "prefill_only"}
        fwd["request_id"] = rid
        tried: set[str] = set()
        for _ in range(2):
            st = self._pick_excluding(tried, tier="decode")
            if st is None:
                break
            tried.add(st.replica.name)
            fb_ctx = ctx.child() if ctx is not None else None
            if fb_ctx is not None:
                fwd = {**fwd, "trace_context": fb_ctx.to_wire()}
            t0 = self._clock()
            with self._lock:
                st.router_inflight += 1
            try:
                try:
                    code, out = self._post(st.replica, "/v1/generate", fwd)
                finally:
                    with self._lock:
                        st.router_inflight -= 1
            except _WIRE_ERRORS:
                self._breaker_note(st, ok=False)
                self._span("fallback", t0, self._clock(), rid,
                           ctx=fb_ctx, replica=st.replica.name,
                           reason=reason, outcome="error")
                continue
            self._breaker_note(st, ok=code < 500 or code == 503)
            self._span("fallback", t0, self._clock(), rid, ctx=fb_ctx,
                       replica=st.replica.name, reason=reason, code=code,
                       outcome=("ok" if code == 200
                                else "busy" if code == 429
                                else "unavailable" if code == 503
                                else "error"))
            if code in (429, 503) and not (
                    isinstance(out, dict) and out.get("shed")):
                continue
            if isinstance(out, dict):
                out = {**out, "replica": st.replica.name,
                       "served_by": st.replica.name,
                       "disagg": "fallback"}
                out.setdefault("request_id", rid)
                if ctx is not None and ctx.sampled:
                    out.setdefault("trace_id", ctx.trace_id)
            else:
                # a non-dict body must still carry the join key — the
                # fallback path is exactly where a client needs it
                out = {"error": out, "replica": st.replica.name,
                       "disagg": "fallback", "request_id": rid}
            if ctx is not None and t_req is not None:
                self._span("route", t_req, self._clock(), rid, ctx=ctx,
                           outcome="fallback", reason=reason,
                           served_by=st.replica.name)
            return code, out
        # last resort: the base router's full resilience stack, its
        # route span nested under the disagg route span via the wire
        # context so the trace stays one tree
        if ctx is not None:
            fwd = {**fwd, "trace_context": ctx.to_wire()}
        code, out = super().handle_generate(fwd)
        if ctx is not None and t_req is not None:
            self._span("route", t_req, self._clock(), rid, ctx=ctx,
                       outcome="fallback", reason=reason)
        return code, out

    # -- observability --------------------------------------------------------

    def fleet_stats(self) -> dict:
        out = super().fleet_stats()
        with self._lock:
            d = dict(self._disagg)
            d["fallbacks_by_reason"] = dict(
                sorted(self._fallback_reasons.items())
            )
        snap = self.hist_handoff.snapshot()
        if snap["count"]:
            d["handoff_count"] = snap["count"]
            d["handoff_seconds_sum"] = round(snap["sum"], 6)
        out["disagg"] = d
        return out

    def _extra_metric_families(self, stats: dict) -> list:
        d = stats.get("disagg") or {}
        fams: list = [
            ("nanodiloco_fleet_handoffs", "counter",
             "completed prefill->decode KV handoffs (the stream's "
             "prefill and decode ran on different replicas)",
             [(None, d.get("handoffs", 0))]),
            ("nanodiloco_fleet_handoff_fallbacks", "counter",
             "handoffs degraded to a monolithic decode-tier generate "
             "(prefill unreachable, export expired, import refused) — "
             "one honest retry, never a dropped stream",
             [(None, d.get("fallbacks", 0))]),
            ("nanodiloco_fleet_ship_bytes", "counter",
             "raw KV payload bytes the router moved between tiers "
             "(pre-base64)",
             [(None, d.get("ship_bytes", 0))]),
        ]
        snap = self.hist_handoff.snapshot()
        if snap["count"]:
            fams.append((
                "nanodiloco_fleet_handoff_seconds", "histogram",
                "prefill completion to payload landing on the decode "
                "replica (export round-trip + tier pick; the decode "
                "stream itself is the request, not the handoff)",
                snap,
            ))
        return fams


class TierAutoscaler(Autoscaler):
    """Autoscaler scoped to ONE tier of a disaggregated fleet.

    Differences from the base loop, all tier-scoping:

    - the capacity model is pinned every tick to this tier's USABLE
      replicas (``FleetRouter.tier_capacity_names`` — serving, ready,
      breaker closed, role matching), so a draining or open-breaker
      prefill replica never counts toward decode capacity;
    - fleet size / retirement candidates count only this tier's
      replicas (plus the boots THIS loop launched, tracked by name —
      a booting replica has not declared a role yet);
    - a fleet-scope SLO burn whose rule name matches this tier's
      keywords (TTFT -> prefill, decode throughput -> decode) is a
      scale-out vote even before a forecast confirms it;
    - at most one tier's loop may own the admission ceiling
      (``manage_admission``) — two shed ladders over one fleet would
      fight each other one class per tick.

    The provider must launch replicas OF THIS TIER (e.g. a
    ``ProcessReplicaProvider`` whose template carries ``--role``)."""

    def __init__(self, router: FleetRouter, model, provider, *,
                 tier: str, manage_admission: bool = False,
                 burn_keywords: tuple = None, **kw) -> None:
        if tier not in ("prefill", "decode"):
            raise ValueError(
                f"tier must be 'prefill' or 'decode'; got {tier!r}"
            )
        super().__init__(router, model, provider, **kw)
        self.tier = tier
        self.manage_admission = bool(manage_admission)
        if burn_keywords is None:
            burn_keywords = (PREFILL_BURN_KEYWORDS if tier == "prefill"
                             else DECODE_BURN_KEYWORDS)
        self.burn_keywords = tuple(burn_keywords)
        self._mine: set[str] = set()

    def _in_tier(self, name: str) -> bool:
        st = self.router.state_of(name)
        if st["status"] == "serving":
            role = st["stats"].get("role") or "both"
            return role == self.tier or role == "both"
        if st["status"] == "scaling_up":
            return name in self._mine
        return False

    def _fleet_size(self) -> int:
        return sum(1 for n in self.router.replica_names()
                   if self._in_tier(n))

    def _launch(self, n: int, *, why: str,
                kind: str = "scale_up") -> list[str]:
        names = super()._launch(n, why=f"[{self.tier}] {why}", kind=kind)
        self._mine.update(names)
        return names

    def _retire(self, n: int, *, why: str) -> list[str]:
        names = [nm for nm in self.router.replica_names()
                 if self._in_tier(nm)
                 and self.router.state_of(nm)["status"] == "serving"]
        victims = names[::-1][:n]
        out: list[str] = []
        for name in victims:
            if len(names) - len(out) <= self.min_replicas:
                break
            self.router.log_event("scale_down", replica=name,
                                  reason=f"[{self.tier}] {why}")
            self.router.remove_replica(name, drain=True,
                                       reason="scale_down")
            self.provider.retire(name)
            self._mine.discard(name)
            out.append(name)
        return out

    def _burning_for_tier(self) -> str | None:
        """A fleet-scope burning rule whose name routes to this tier,
        or None. Rule names carry the signal: the SLO config's TTFT
        rule names contain 'ttft', the throughput rules 'decode' /
        'tokens_per_sec' — the PR-15 burn signals driving the split."""
        slo = getattr(self.router, "slo_state", None)
        if not callable(slo):
            return None
        for rule in slo().get("slo_fleet_burning") or []:
            low = rule.lower()
            if any(k in low for k in self.burn_keywords):
                return rule
        return None

    def _wants_out(self, est: CapacityEstimate) -> str | None:
        reason = super()._wants_out(est)
        if reason:
            return reason
        rule = self._burning_for_tier()
        if rule is not None:
            return f"slo burn: {rule} -> {self.tier} tier"
        return None

    def _shed_tick(self, est: CapacityEstimate, rec: dict) -> None:
        if self.manage_admission:
            super()._shed_tick(est, rec)
        else:
            rec["admission_max_priority"] = (
                self.router.admission_max_priority()
            )

    def tick(self) -> dict:
        # pin the model to THIS tier's usable supply before estimating
        # (the small-fix satellite: capacity is tier-scoped, not
        # fleet-global)
        tgt = getattr(self.model, "set_targets", None)
        names = getattr(self.router, "tier_capacity_names", None)
        if callable(tgt) and callable(names):
            tgt(names(self.tier))
        rec = super().tick()
        rec["tier"] = self.tier
        return rec


class DisaggAutoscaler:
    """Two tier-scoped control loops over one fleet, ticked together.

    The prefill tier is sized by arrival pressure (queue depth and its
    slope are prompt-compute demand on prefill replicas), the decode
    tier by live slots and the ``kv_blocks_free`` forecast — each
    through its OWN tier-pinned ``CapacityModel``, scaling
    independently as the traffic mix shifts. The decode loop owns the
    admission ceiling (overload saturates decode capacity first; one
    shed ladder, not two fighting)."""

    def __init__(self, prefill: TierAutoscaler,
                 decode: TierAutoscaler) -> None:
        if prefill.tier != "prefill" or decode.tier != "decode":
            raise ValueError(
                "DisaggAutoscaler needs (prefill-tier, decode-tier) "
                f"loops; got {prefill.tier!r}, {decode.tier!r}"
            )
        if prefill.manage_admission and decode.manage_admission:
            raise ValueError(
                "only one tier's loop may manage the admission ceiling"
            )
        self.prefill = prefill
        self.decode = decode
        self.interval_s = min(prefill.interval_s, decode.interval_s)

    def tick(self) -> dict:
        return {"prefill": self.prefill.tick(),
                "decode": self.decode.tick()}

    def run(self, stop=None, max_ticks: int | None = None) -> None:
        n = 0
        while stop is None or not stop.is_set():
            try:
                self.tick()
            except Exception:
                pass  # one bad tick must not kill the control loop
            n += 1
            if max_ticks is not None and n >= max_ticks:
                return
            if stop is not None:
                stop.wait(self.interval_s)
            else:
                self.prefill._sleep(self.interval_s)
