"""The port's disaggregated prefill/decode fleet
(nanodiloco_tpu_torch/fleet/disagg.py) against the JAX package's:

- the two-phase request path and every degradation edge, with both
  ``DisaggRouter``s driven by the same scripted tiers on the same fake
  clock: the same replies, legs, wire timeouts, accounting, events and
  ``/metrics`` text;
- the tier autoscalers (``TierAutoscaler`` / ``DisaggAutoscaler``) over
  a scripted tiered router, provider and capacity model: the same scale
  steps, retirements, admission ceilings and events;
- over real sockets: one prefill and one decode replica of the port's
  own serve stack (a tiny f32 model on the CPU) behind the port's
  ``DisaggRouter`` front door. Every stream crosses the KV ship and is
  token-identical to the JAX package's solo ``generate()``; the
  router's and both tiers' trace shards stitch into one causal tree per
  request whose critical path sums to its wall time.
"""

import functools
import importlib
import json
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanodiloco_tpu.fleet as jax_fleet
import nanodiloco_tpu.obs.forecast as jax_forecast
import nanodiloco_tpu_torch.fleet as torch_fleet
import nanodiloco_tpu_torch.obs.forecast as torch_forecast
from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy
from nanodiloco_tpu_torch.obs.tracer import SpanTracer, critical_path, stitch_trace
from nanodiloco_tpu_torch.serve import InferenceEngine, Scheduler, ServeServer, http_post_json

JG = importlib.import_module("nanodiloco_tpu.models.generate")
SIZE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_hidden_layers=2, max_position_embeddings=64)
PACKAGES = {"jax": types.SimpleNamespace(fleet=jax_fleet, forecast=jax_forecast),
            "torch": types.SimpleNamespace(fleet=torch_fleet, forecast=torch_forecast)}
# a packed ship doc as the router sees it: opaque fields whose base64
# length is all the router reads (9 raw bytes)
SHIP = {"config": "cafe", "generation": 0, "wire_dtype": "float32",
        "k": "AAAAAAAA", "v": "AAAA", "pos": 3, "emitted": [7]}
ROLES = {"pf": "prefill", "d0": "decode", "d1": "decode"}


def within(seconds):
    """The test's own time limit: its body runs in a thread, and the
    test fails if that thread has not finished after ``seconds``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            box = {}

            def body():
                try:
                    fn(*args, **kwargs)
                except BaseException as e:  # re-raised on the test's thread
                    box["error"] = e
            t = threading.Thread(target=body, daemon=True)
            t.start()
            t.join(seconds)
            assert not t.is_alive(), f"{fn.__name__} took longer than {seconds} s"
            if "error" in box:
                raise box["error"]
        return run
    return wrap


class FakeClock:
    def __init__(self, t: float = 50.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class TieredFleet:
    """Scripted probe/post for a tiered fleet: health docs with the
    declared role, per-(replica, path) replies (a pair, a callable, or
    an exception to raise), and a log of every post with its timeout.
    Each post advances the clock, so the handoff phases have lengths."""

    def __init__(self, roles, clock):
        self.docs = {n: {"reachable": True, "live": True, "ready": True,
                         "stats": {"queue_depth": 0, "slots_busy": 0, "kv_blocks_free": 10,
                                   "in_flight": 0, "role": role}}
                     for n, role in roles.items()}
        self.posts = []
        self.reply = {}
        self.clock = clock

    def probe(self, replica):
        d = self.docs[replica.name]
        return {k: (dict(v) if isinstance(v, dict) else v) for k, v in d.items()}

    def post(self, replica, path, doc, timeout=None):
        self.posts.append((replica.name, path, dict(doc), timeout))
        self.clock.advance(0.125)
        r = self.reply.get((replica.name, path))
        if isinstance(r, Exception):
            raise r
        if callable(r):
            return r(doc)
        if r is not None:
            return r[0], (dict(r[1]) if isinstance(r[1], dict) else r[1])
        if path == "/v1/generate":
            return 200, {"token_ids": [1, 2], "finish_reason": "length",
                         "request_id": doc.get("request_id")}
        raise AssertionError(f"unexpected post: {replica.name} {path}")


def happy(fleet, dec_reply=(200, {"token_ids": [7, 8, 9], "finish_reason": "length"})):
    fleet.reply[("pf", "/v1/generate")] = lambda doc: (
        200, {"token_ids": [7], "finish_reason": "prefilled",
              "request_id": doc.get("request_id")})
    fleet.reply[("pf", "/admin/kv/export")] = (200, SHIP)
    fleet.reply[("d0", "/admin/kv/import")] = dec_reply


CASES = {
    "handoff": (ROLES, happy),
    "both-monolith": ({"r0": "both", "r1": "both"}, lambda f: None),
    "no-decode-tier": ({"pf": "prefill"}, lambda f: None),
    "first-token-finish": (ROLES, lambda f: f.reply.update(
        {("pf", "/v1/generate"): (200, {"token_ids": [9], "finish_reason": "stop"})})),
    "shed-429": (ROLES, lambda f: f.reply.update(
        {("pf", "/v1/generate"): (429, {"shed": True, "error": "priority 3 shed"})})),
    "prefill-unreachable": (ROLES, lambda f: f.reply.update(
        {("pf", "/v1/generate"): OSError("connection reset")})),
    "prefill-500": (ROLES, lambda f: f.reply.update(
        {("pf", "/v1/generate"): (500, {"error": "boom"})})),
    "export-404": (ROLES, lambda f: (happy(f), f.reply.update(
        {("pf", "/admin/kv/export"): (404, {"error": "no parked stream"})}))),
    "import-429-other": (ROLES, lambda f: (happy(f, (429, {"error": "busy"})), f.reply.update(
        {("d1", "/admin/kv/import"): (200, {"token_ids": [7, 8], "finish_reason": "length"})}))),
    "import-409": (ROLES, lambda f: happy(f, (409, {"error": "fingerprint mismatch"}))),
    "import-non-dict": (ROLES, lambda f: (happy(f, (502, "a bare string body")), f.reply.update(
        {("d1", "/admin/kv/import"): (502, "a bare string body")}))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_disagg_router_paths_match_jax(tmp_path, case):
    roles, script = CASES[case]
    seen = {}
    for name, pkg in PACKAGES.items():
        clock = FakeClock()
        fleet = TieredFleet(roles, clock)
        d = tmp_path / name
        d.mkdir()
        router = pkg.fleet.DisaggRouter(
            [pkg.fleet.Replica(n, f"http://fake/{n}") for n in roles],
            probe=fleet.probe, post=fleet.post, clock=clock, wall=clock,
            sleep=clock.advance, events_jsonl=str(d / "deploy.jsonl"), quiet=True,
            handoff_timeout_s=7.5, hedge_after_s=0)
        router.health_tick()
        script(fleet)
        replies = [router.handle_generate({"token_ids": [5, 9], "max_new_tokens": 4,
                                           "stop": False}),
                   router.handle_generate({"token_ids": [5], "max_new_tokens": 4,
                                           "stop": False, "prefill_only": True,
                                           "request_id": "mine-1"})]
        events = (d / "deploy.jsonl").read_text() if (d / "deploy.jsonl").exists() else ""
        seen[name] = (replies, fleet.posts, router.fleet_stats(), router.render_metrics(),
                      events, router.tier_capacity_names("prefill"),
                      router.tier_capacity_names("decode"))
    assert seen["torch"] == seen["jax"]
    (code, out), _ = seen["torch"][0]
    disagg = seen["torch"][2]["disagg"]
    if case in ("handoff", "import-429-other"):
        assert code == 200 and out["disagg"] == "handoff" and disagg["ship_bytes"] == 9
    elif case in ("prefill-unreachable", "prefill-500", "export-404", "import-409"):
        assert code == 200 and out["disagg"] == "fallback" and disagg["fallbacks"] == 1
    elif case == "shed-429":
        assert code == 429 and disagg["fallbacks"] == 0


def est(mod, *, kv_eta=None, q_eta=None, slope=0.0, confident=True):
    return mod.CapacityEstimate(at=0.0, replicas=2, queue_depth=1.0, queue_slope=slope,
                                request_rate=1.0, kv_blocks_free=100.0,
                                kv_exhaustion_s=kv_eta, queue_exhaustion_s=q_eta,
                                horizon_s=10.0, confident=confident)


class TierRouter:
    """A scripted tiered router for the autoscaler loops: serving
    replicas with declared roles and booting ones with none yet."""

    def __init__(self, roles):
        self.roles = dict(roles)
        self.scaling = set()
        self.events = []
        self.removed = []
        self.admission = 9
        self.burning = []

    def fleet_stats(self):
        return {"replicas_serving": len(self.roles), "replicas_scaling_up": len(self.scaling)}

    def add_replica(self, replica, source=None):
        self.scaling.add(replica.name)

    def remove_replica(self, name, drain=True, reason=None):
        self.roles.pop(name, None)
        self.scaling.discard(name)
        self.removed.append((name, drain, reason))

    def replica_names(self):
        return list(self.roles) + sorted(self.scaling)

    def state_of(self, name):
        if name in self.scaling:
            return {"status": "scaling_up", "stats": {}}
        return {"status": "serving", "stats": {"role": self.roles[name]}}

    def log_event(self, kind, replica=None, reason=None):
        self.events.append((kind, replica, reason))

    def admission_max_priority(self):
        return self.admission

    def set_admission(self, n, reason=None):
        self.admission = n
        return n

    def slo_burning(self):
        return bool(self.burning)

    def slo_state(self):
        return {"slo_fleet_burning": list(self.burning)}

    def tier_capacity_names(self, tier):
        return sorted(n for n, r in self.roles.items() if r in (tier, "both"))

    def breaker_open_replicas(self):
        return []


class TierProvider:
    def __init__(self, pkg, tier):
        self.pkg, self.tier, self.seq, self.retired = pkg, tier, 0, []

    def launch(self):
        self.seq += 1
        return self.pkg.fleet.Replica(name=f"{self.tier}{self.seq}", url="http://test")

    def retire(self, name):
        self.retired.append(name)

    def preempted(self):
        return []


class TierModel:
    def __init__(self):
        self.current = None
        self.targets = []

    def estimate(self, now):
        return self.current

    def set_targets(self, names):
        self.targets.append(list(names))


def test_tier_autoscalers_match_jax():
    """Pressure on the decode tier scales decode only; headroom retires
    the newest decode boot; a burn keyed to the prefill tier votes
    there; the decode loop alone owns the admission ceiling."""
    seen = {}
    for name, pkg in PACKAGES.items():
        router = TierRouter(ROLES)
        clock = FakeClock(0.0)
        models = {t: TierModel() for t in ("prefill", "decode")}
        providers = {t: TierProvider(pkg, t) for t in ("prefill", "decode")}
        kw = dict(min_replicas=1, max_replicas=3, cooldown_s=1.0, hysteresis_ticks=2,
                  scale_out_horizon_s=30.0, scale_in_idle_ticks=2, shed_horizon_s=10.0,
                  clock=clock)
        pf = pkg.fleet.TierAutoscaler(router, models["prefill"], providers["prefill"],
                                      tier="prefill", **kw)
        dec = pkg.fleet.TierAutoscaler(router, models["decode"], providers["decode"],
                                       tier="decode", manage_admission=True, **kw)
        both = pkg.fleet.DisaggAutoscaler(pf, dec)
        trace = []
        script = ([("neutral", "pressure")] * 3 + [("neutral", "exhaust")] * 4
                  + [("headroom", "headroom")] * 6 + [("burn", "neutral")] * 3)
        for p_est, d_est in script:
            for tier, kind in (("prefill", p_est), ("decode", d_est)):
                models[tier].current = {
                    "neutral": est(pkg.forecast, slope=1.0),
                    "pressure": est(pkg.forecast, kv_eta=5.0, slope=2.0),
                    "exhaust": est(pkg.forecast, kv_eta=2.0, q_eta=1.0, slope=3.0),
                    "headroom": est(pkg.forecast, slope=-0.5),
                    "burn": est(pkg.forecast, slope=1.0)}[kind]
            router.burning = ["prefill_ttft"] if p_est == "burn" else []
            for n in list(router.scaling):  # boots finish on the next tick
                router.scaling.discard(n)
                router.roles[n] = "prefill" if n.startswith("prefill") else "decode"
            clock.advance(1.5)
            trace.append((both.tick(), router.admission))
        seen[name] = (trace, router.events, router.removed, models["decode"].targets,
                      providers["prefill"].retired, providers["decode"].retired)
        with pytest.raises(ValueError):
            pkg.fleet.DisaggAutoscaler(dec, pf)
    assert seen["torch"] == seen["jax"]
    assert any(kind.startswith("scale") for kind, _, _ in seen["torch"][1])


# -- over real sockets: the port's prefill and decode tiers ---------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jc = JaxConfig(**SIZE)
    jp = jax_init(jax.random.key(0), jc)
    return jc, jp, LlamaConfig(**SIZE), params_from_numpy(jax.tree.map(np.asarray, jp),
                                                          device="cpu")


def jax_solo(model, prompt, n):
    jc, jp = model[0], model[1]
    with jax.default_matmul_precision("highest"):
        out = JG.generate(jp, jnp.asarray([list(prompt)], jnp.int32), jc, n)
    return np.asarray(out)[0].tolist()


def tier(model, role, **kv):
    eng = InferenceEngine(model[3], model[2], num_slots=2, max_len=64, device="cpu", **kv)
    tracer = SpanTracer(clock=time.monotonic, process_name=f"serve {role}")
    sched = Scheduler(eng, tracer=tracer, park_ttl_s=30.0)
    server = ServeServer(sched, port=0, host="127.0.0.1", max_new_tokens_cap=64,
                         role=role).start()
    return eng, sched, server, tracer


@within(90)
def test_tiers_over_sockets_match_jax_and_stitch(model):
    pf_eng, pf_sched, pf_srv, pf_tr = tier(model, "prefill", kv_block_size=4)
    de_eng, de_sched, de_srv, de_tr = tier(model, "decode", kv_block_size=4)
    rtr_tr = SpanTracer(clock=time.monotonic, process_name="router")
    router = torch_fleet.DisaggRouter(
        [torch_fleet.Replica("pf", f"http://127.0.0.1:{pf_srv.port}"),
         torch_fleet.Replica("d0", f"http://127.0.0.1:{de_srv.port}")],
        host="127.0.0.1", health_interval_s=0.05, tracer=rtr_tr, quiet=True).start()
    base = f"http://127.0.0.1:{router.port}"
    prompts = [[5, 9, 2, 11], [7, 1, 4, 3, 8, 12, 6], [2, 10]]
    try:
        deadline = time.monotonic() + 10
        while router.fleet_stats()["replicas_ready"] < 2:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        for i, p in enumerate(prompts):
            code, out = http_post_json(base + "/v1/generate", {
                "token_ids": p, "max_new_tokens": 10, "temperature": 0.0, "stop": False,
                "request_id": f"d{i}"}, timeout=30.0)
            assert code == 200, out
            assert out["disagg"] == "handoff"
            assert (out["prefilled_by"], out["served_by"]) == ("pf", "d0")
            assert out["token_ids"] == jax_solo(model, p, 10)
        d = router.fleet_stats()["disagg"]
        assert d["handoffs"] == 3 and d["fallbacks"] == 0 and d["ship_bytes"] > 0
        # every parked and imported block came back
        for eng in (pf_eng, de_eng):
            kv = eng.kv_stats()
            assert kv["blocks_free"] == kv["num_blocks"]
    finally:
        router.stop()
        pf_srv.stop()
        de_srv.stop()
    docs = [json.loads(json.dumps(t.to_chrome())) for t in (rtr_tr, pf_tr, de_tr)]
    for i in range(len(prompts)):
        st = stitch_trace(docs, f"d{i}")
        root = st["root"]
        assert root["name"] == "route" and root["process"] == "router"
        procs = {n["process"] for n in st["spans"]}
        assert procs == {"router", "serve prefill", "serve decode"}
        segs = critical_path(root)
        assert sum(s["seconds"] for s in segs) == pytest.approx(root["end_s"] - root["start_s"])
        assert st["request_id_joined"] == 0
