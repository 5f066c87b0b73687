"""The port's chaos harness (nanodiloco_tpu_torch/fleet/chaos.py) and the
request-level resilience it drills, against the JAX package:

- the plan: validation (the same errors), once-per-ordinal firing, the
  fired records and the counter family, ``DRILL_PLAN``;
- the proxy: both packages' ``ChaosProxy`` in front of one scripted
  upstream realize every fault kind on a real socket the same way;
- a drill over a fleet of the port's own serve replicas (a tiny f32
  model on the CPU) behind the port's router, driven through its HTTP
  front door: every greedy stream is token-identical to the JAX
  package's solo ``generate()`` on the same weights, the slow request
  is hedged and the loser cancelled, the breaker opens on the erroring
  replica, no KV block leaks, and a replica whose engine loop dies is
  ejected while the fleet answers every request;
- ``/v1/cancel`` hygiene on the port's server, with the queued-request
  case waiting until the first request holds the slot before it posts
  the second (no race on which request takes the slot).

Every test that opens a socket or starts a thread runs under its own
time limit (``within``), and waits on polled state, never a fixed sleep.
"""

import functools
import http.client
import importlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nanodiloco_tpu.fleet.chaos as jax_chaos
import nanodiloco_tpu_torch.fleet.chaos as torch_chaos
from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu_torch.fleet import FleetRouter, Replica
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy
from nanodiloco_tpu_torch.serve import InferenceEngine, Scheduler, ServeServer, http_post_json

JG = importlib.import_module("nanodiloco_tpu.models.generate")
SIZE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_hidden_layers=2, max_position_embeddings=64)
CHAOS = {"jax": jax_chaos, "torch": torch_chaos}


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


def wait_for(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


# -- the plan -------------------------------------------------------------------

BAD_PLANS = [
    [{"kind": "meteor", "target": "r0", "requests": [1]}],
    [{"kind": "latency", "requests": [1]}],
    [{"kind": "latency", "target": "r0", "requests": []}],
    [{"kind": "latency", "target": "r0", "requests": [True]}],
    [{"kind": "reset", "target": "r0", "requests": [-1]}],
    [{"kind": "flap_health", "target": "r0", "requests": [1]}],
    [{"kind": "latency", "target": "r0", "probes": [1]}],
    [{"kind": "latency", "target": "r0", "requests": [1], "seconds": 0}],
    [{"kind": "slow_drip", "target": "r0", "requests": [1], "chunk_bytes": 0}],
]


@pytest.mark.parametrize("faults", BAD_PLANS)
def test_plan_validation_matches_jax(faults):
    errors = {}
    for name, mod in CHAOS.items():
        with pytest.raises(ValueError) as e:
            mod.ChaosPlan(faults)
        errors[name] = str(e.value)
    assert errors["torch"] == errors["jax"]


def test_plan_firing_records_and_counters_match_jax():
    seen = {}
    for name, mod in CHAOS.items():
        plan = mod.ChaosPlan.from_dict(mod.DRILL_PLAN)
        taken = [(ch, tgt, i, [f["kind"] for f in plan.take(ch, tgt, i)])
                 for i in range(8) for tgt in ("r0", "r1", "r2")
                 for ch in ("request", "probe")]
        taken.append(plan.take("request", "r0", 1))  # fired: never again
        seen[name] = (taken, plan.counts(), plan.drain_fired(), plan.drain_fired(),
                      mod.chaos_families(plan.counts()), mod.chaos_families({}),
                      sorted(mod.KINDS))
        with pytest.raises(ValueError):
            mod.ChaosPlan.from_dict({"faults": "latency"})
    assert seen["torch"] == seen["jax"]
    assert torch_chaos.DRILL_PLAN == jax_chaos.DRILL_PLAN
    assert sorted({f["kind"] for f in torch_chaos.DRILL_PLAN["faults"]}) == sorted(
        torch_chaos.KINDS)


# -- the proxy on a real socket ---------------------------------------------------


class Upstream:
    """A scripted replica: /healthz, and /v1/generate with a padded body
    (so reset and slow_drip have something to cut or drip)."""

    def __init__(self):
        up = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _json(self, code, doc):
                raw = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                self._json(200, {"alive": True} if self.path.startswith("/healthz")
                           else {"path": self.path})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                if n:
                    self.rfile.read(n)
                up.hits += 1
                self._json(200, {"ok": True, "pad": "x" * 600})

        self.hits = 0
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def raw(port, method, path, body=None, timeout=5.0):
    """One raw exchange: (status, body) or the transport fault's type."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=payload)
        r = conn.getresponse()
        data = r.read()
        try:
            return r.status, json.loads(data)
        except ValueError:
            return r.status, "unparseable"
    except (OSError, http.client.HTTPException):
        return "transport-fault", None
    finally:
        conn.close()


@within(60)
def test_proxy_realizes_every_fault_like_jax():
    faults = [
        {"kind": "error_500", "target": "r0", "requests": [1]},
        {"kind": "latency", "target": "r0", "requests": [2], "seconds": 0.2},
        {"kind": "garbage_json", "target": "r0", "requests": [3]},
        {"kind": "reset", "target": "r0", "requests": [4]},
        {"kind": "slow_drip", "target": "r0", "requests": [5], "seconds": 0.1,
         "chunk_bytes": 64},
        {"kind": "blackhole", "target": "r0", "requests": [6], "seconds": 30.0},
        {"kind": "flap_health", "target": "r0", "probes": [1]},
        {"kind": "kill", "target": "r0", "requests": [7]},
    ]
    seen = {}
    for name, mod in CHAOS.items():
        up = Upstream()
        killed = []
        plan = mod.ChaosPlan(faults)
        proxy = mod.ChaosProxy(up.url, plan, "r0", on_kill=killed.append).start()
        try:
            out = [raw(proxy.port, "GET", "/metrics"),
                   raw(proxy.port, "GET", "/healthz"), raw(proxy.port, "GET", "/healthz")]
            t0 = time.monotonic()
            for i in range(8):
                out.append(raw(proxy.port, "POST", "/v1/generate", {"i": i},
                               timeout=1.0 if i == 6 else 5.0))
                if i == 2:
                    out.append(time.monotonic() - t0 >= 0.2)  # slow but answered
            out.append(raw(proxy.port, "GET", "/chaos/status"))
            seen[name] = (out, killed, plan.counts(), up.hits)
        finally:
            proxy.stop()
            up.stop()
    assert seen["torch"] == seen["jax"]
    out, killed, counts, hits = seen["torch"]
    assert out[2][0] == 503 and out[4][0] == 500 and out[7][1] == "unparseable"
    assert out[8] == ("transport-fault", None) and out[10] == ("transport-fault", None)
    assert killed == ["r0"] and counts["kill"] == 1


# -- the drill over the port's own serve replicas ---------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) from one numpy tree,
    and a cache of the JAX package's solo greedy streams."""
    jc = JaxConfig(**SIZE)
    jp = jax_init(jax.random.key(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, LlamaConfig(**SIZE), tp, {}


def jax_solo(model, prompt, n):
    """The request run alone through the JAX package's generate()."""
    jc, jp, _, _, cache = model
    key = (tuple(prompt), n)
    if key not in cache:
        with jax.default_matmul_precision("highest"):
            out = JG.generate(jp, jnp.asarray([list(prompt)], jnp.int32), jc, n)
        cache[key] = np.asarray(out)[0].tolist()
    return cache[key]


def serve(model, *, num_slots=2, tick_delay_s=0.0, **kv):
    eng = InferenceEngine(model[3], model[2], num_slots=num_slots, max_len=64,
                          device="cpu", **kv)
    sched = Scheduler(eng)
    server = ServeServer(sched, port=0, host="127.0.0.1", max_new_tokens_cap=64,
                         tick_delay_s=tick_delay_s).start()
    return eng, sched, server


def post_async(url, doc):
    box = {}

    def run():
        try:
            box["resp"] = http_post_json(url, doc, timeout=60.0)
        except Exception as e:  # surfaced by the caller's assert
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


def kill_loop(server, sched):
    """The engine loop dies (its next tick raises): /healthz turns 503."""
    def boom():
        raise RuntimeError("injected engine fault")
    sched.tick = boom
    assert wait_for(lambda: not server.loop_alive())


PROMPTS = [[5, 9, 2, 11], [7, 1, 4], [3, 8, 1, 7, 2, 6], [12, 4], [9, 9, 3, 1, 5],
           [2, 10, 12], [6, 5, 4, 3, 2, 1, 8], [11, 7]]


@within(120)
def test_drill_streams_match_jax_solo_generate(model):
    """Two port replicas (r0 paged, r1 dense) behind chaos proxies and
    the port's router, in phases whose routing does not depend on the
    host's speed: (A) a lone request to the idle fleet lands on r0 (most
    free KV blocks), whose engine is slowed to 0.5 s a tick, is hedged to
    r1 after 1 s, and the loser is cancelled on r0; (B) with r0 marked
    not-preferred, r1 takes the next three first: it answers one late,
    resets one and fails one with a 500, the last two retried on r0,
    which opens r1's breaker; (C) a concurrent burst reaches r1 only as
    hedges, its breaker routing first attempts around it; (D) r1's engine
    loop dies, r1 is ejected, r0 answers everything. A flapped health
    probe never ejects. Every reply is JAX's solo greedy stream: no
    request is dropped."""
    plan = torch_chaos.ChaosPlan([
        {"kind": "latency", "target": "r1", "requests": [1], "seconds": 0.1},
        {"kind": "reset", "target": "r1", "requests": [2]},
        {"kind": "error_500", "target": "r1", "requests": [3]},
        {"kind": "flap_health", "target": "r1", "probes": [1]},
    ])
    eng0, sched0, s0 = serve(model, kv_block_size=4)
    eng1, sched1, s1 = serve(model)
    replicas, proxies = torch_chaos.proxy_fleet(
        [Replica("r0", f"http://127.0.0.1:{s0.port}"),
         Replica("r1", f"http://127.0.0.1:{s1.port}")], plan)
    router = FleetRouter(replicas, host="127.0.0.1", hedge_after_s=1.0,
                         retry_budget_min=10.0, breaker_window=4, breaker_min_samples=2,
                         breaker_failure_rate=0.5, breaker_open_s=60.0,
                         health_interval_s=0.05, quiet=True).start()
    base = f"http://127.0.0.1:{router.port}"
    seq = iter(range(1000))

    def drive(prompts):
        threads = [post_async(base + "/v1/generate",
                              {"token_ids": p, "max_new_tokens": 8, "temperature": 0.0,
                               "stop": False, "request_id": f"q{next(seq)}"})
                   for p in prompts]
        served = []
        for p, (t, box) in zip(prompts, threads):
            t.join(60)
            assert "error" not in box, box
            code, out = box["resp"]
            assert code == 200, out
            assert out["token_ids"] == jax_solo(model, p, 8)
            served.append(out["served_by"])
        return served

    try:
        assert wait_for(lambda: router.fleet_stats()["replicas_ready"] == 2)
        s0._tick_delay_s = 0.5  # (A) r0's engine is slow for this request
        assert drive(PROMPTS[:1]) == ["r1"]  # the hedge won
        s0._tick_delay_s = 0.0
        stats = router.fleet_stats()
        assert stats["hedges"] == 1 and stats["hedge_wins"] == 1
        assert wait_for(lambda: sched0.stats()["cancelled"] == 1)
        router.set_slo_burning("drill", "r0", True)
        drive(PROMPTS[1:2])  # (B) r1's ordinal 1, 0.1 s late
        assert drive(PROMPTS[2:3]) == ["r0"]  # reset, retried on r0
        assert drive(PROMPTS[3:4]) == ["r0"]  # 500, retried on r0
        assert router.fleet_stats()["breaker_state"]["r1"] == "open"
        assert router.breaker_open_replicas() == ["r1"]
        router.set_slo_burning("drill", "r0", False)
        hedges = router.fleet_stats()["hedges"]
        served = drive(PROMPTS[4:])  # (C) first attempts go around the open breaker
        assert served.count("r1") <= router.fleet_stats()["hedges"] - hedges
        assert wait_for(lambda: plan.counts().get("flap_health") == 1)
        assert router.fleet_stats()["replicas_ejected"] == 0  # one flap never ejects
        # no slot or KV block stays held: the hedge loser was cancelled
        assert wait_for(lambda: sched0.stats()["slots_busy"] == 0
                        and sched1.stats()["slots_busy"] == 0)
        assert wait_for(lambda: eng0.kv_stats()["blocks_free"] == eng0.kv_stats()["num_blocks"])
        kill_loop(s1, sched1)  # (D)
        assert wait_for(lambda: router.state_of("r1")["status"] == "ejected")
        assert set(drive(PROMPTS[:3])) == {"r0"}
        assert plan.counts() == {"latency": 1, "reset": 1, "error_500": 1, "flap_health": 1}
    finally:
        router.stop()
        for p in proxies:
            p.stop()
        s0.stop()
        s1.stop()


def cancel_until_ok(base, rid, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        code, out = http_post_json(base + "/v1/cancel", {"request_id": rid})
        if code == 200:
            return out
        assert code == 404  # not registered yet
        time.sleep(0.005)
    raise AssertionError("cancel never found the request in flight")


@pytest.mark.parametrize("kv", [{}, {"kv_block_size": 4}], ids=["dense", "paged"])
@within(60)
def test_cancel_frees_slot_and_kv_blocks(model, kv):
    eng, sched, server = serve(model, tick_delay_s=0.02, **kv)
    base = f"http://127.0.0.1:{server.port}"
    try:
        t, box = post_async(base + "/v1/generate", {
            "token_ids": [5, 9, 2, 11], "max_new_tokens": 56, "temperature": 0.0,
            "request_id": "c1"})
        assert cancel_until_ok(base, "c1")["cancelled"] is True
        t.join(30)
        code, doc = box["resp"]
        assert code == 200 and doc["finish_reason"] == "cancelled"
        assert doc["completion_tokens"] < 56
        s = sched.stats()
        assert s["slots_busy"] == 0 and s["queue_depth"] == 0 and s["cancelled"] == 1
        kvs = eng.kv_stats()
        if kvs is not None:
            assert kvs["blocks_free"] == kvs["num_blocks"]
        code, out = http_post_json(base + "/v1/cancel", {"request_id": "ghost"})
        assert code == 404 and out == {"cancelled": False, "request_id": "ghost"}
        assert http_post_json(base + "/v1/cancel", {"request_id": 7})[0] == 400
    finally:
        server.stop()


@within(60)
def test_cancel_queued_request_never_decodes(model):
    """``a`` is posted alone and holds the single slot before ``b`` is
    posted, so ``b`` surely queues; cancelled there, it retires with no
    output, and ``a`` finishes untouched with JAX's solo stream."""
    eng, sched, server = serve(model, num_slots=1, tick_delay_s=0.02)
    base = f"http://127.0.0.1:{server.port}"
    try:
        ta, box_a = post_async(base + "/v1/generate", {
            "token_ids": [1, 2, 3], "max_new_tokens": 40, "temperature": 0.0,
            "stop": False, "request_id": "a"})
        assert wait_for(lambda: sched.stats()["slots_busy"] == 1)
        tb, box_b = post_async(base + "/v1/generate", {
            "token_ids": [4, 5, 6], "max_new_tokens": 40, "temperature": 0.0,
            "request_id": "b"})
        assert wait_for(lambda: sched.queue_depth() == 1)
        cancel_until_ok(base, "b")
        tb.join(30)
        code, doc = box_b["resp"]
        assert code == 200 and doc["finish_reason"] == "cancelled"
        assert doc["token_ids"] == []
        ta.join(60)
        code, doc = box_a["resp"]
        assert code == 200 and doc["finish_reason"] == "length"
        assert doc["token_ids"] == jax_solo(model, [1, 2, 3], 40)
    finally:
        server.stop()
