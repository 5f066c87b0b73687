"""The port's fleet router and deploy controller
(nanodiloco_tpu_torch/fleet/router.py, fleet/deploy.py) against the JAX
package's, as host logic: both routers are driven by the same scripted
replicas (probe/post functions, no sockets, no model) on the same fake
clock, and must make the same decisions — routing picks, replies,
ejections, breaker states, retries, hedges, goodput seconds, shedding,
membership — and write the same deploy-event JSONL and the same
``/metrics`` text. The controller runs over those routers with a
scripted canary bench and must take the same promote / rollback path.

Each scenario is one function of a package's modules; ``twin`` runs it
once per package and compares what it observed, then the test checks
the reference behaviour on the port's observation.
"""

import json
import threading
import time
import types

import pytest

import nanodiloco_tpu.fleet.deploy as jax_deploy
import nanodiloco_tpu.fleet.router as jax_router
import nanodiloco_tpu_torch.fleet.deploy as torch_deploy
import nanodiloco_tpu_torch.fleet.router as torch_router

PACKAGES = {
    "jax": types.SimpleNamespace(router=jax_router, deploy=jax_deploy),
    "torch": types.SimpleNamespace(router=torch_router, deploy=torch_deploy),
}


class FakeClock:
    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class ScriptedFleet:
    """Per-replica health docs the scenario mutates, per-replica
    generate replies (a (code, body) pair or a callable of the doc), an
    optional event a replica's generate blocks on, and a log of every
    post."""

    def __init__(self, names):
        self.docs = {
            n: {"reachable": True, "live": True, "ready": True,
                "stats": {"queue_depth": 0, "slots_busy": 0,
                          "kv_blocks_free": 10, "in_flight": 0}}
            for n in names
        }
        self.posts = []
        self.generate_reply = {}
        self.block = {}
        self.finishing = False  # each probe finishes one in-flight stream

    def probe(self, replica):
        d = self.docs[replica.name]
        out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in d.items()}
        if self.finishing and "in_flight" in d.get("stats", {}):
            d["stats"]["in_flight"] = max(0, d["stats"]["in_flight"] - 1)
        return out

    def post(self, replica, path, doc, timeout=None):
        self.posts.append((replica.name, path, dict(doc)))
        if path == "/v1/generate":
            ev = self.block.get(replica.name)
            if ev is not None:
                ev.wait(timeout=10.0)
            r = self.generate_reply.get(replica.name, (200, {"token_ids": [1], "ok": True}))
            if callable(r):
                r = r(doc)
            code, out = r
            return code, (dict(out) if isinstance(out, dict) else out)
        if path == "/v1/cancel":
            return 200, {"cancelled": True}
        if path == "/admin/swap":
            return 200, {"swapped": True, "deploy_generation": doc.get("step", 0)}
        if path == "/admin/drain":
            self.docs[replica.name]["ready"] = False
            return 200, {"draining": True}
        if path == "/admin/resume":
            self.docs[replica.name]["ready"] = True
            return 200, {"draining": False}
        raise AssertionError(path)


def make_router(pkg, tmp, names=("r0", "r1"), blackbox=None, **kw):
    clock = FakeClock()
    fleet = ScriptedFleet(names)
    reps = [pkg.router.Replica(n, f"http://fake/{n}",
                               blackbox=(blackbox or {}).get(n)) for n in names]
    router = pkg.router.FleetRouter(
        reps, probe=fleet.probe, post=fleet.post, clock=clock, wall=clock,
        sleep=clock.advance, events_jsonl=str(tmp / "deploy.jsonl"), quiet=True, **kw)
    return router, fleet, clock


def events(tmp):
    path = tmp / "deploy.jsonl"
    if not path.exists():
        return []
    return [json.loads(line) for line in path.read_text().splitlines()]


def gen_posts(fleet):
    return [(n, d) for n, p, d in fleet.posts if p == "/v1/generate"]


def twin(scenario, tmp_path):
    """Run ``scenario(pkg, dir)`` for both packages; their observations
    must be equal. Returns the port's."""
    seen = {}
    for name, pkg in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        seen[name] = scenario(pkg, d)
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


def wait_for(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


# -- routing and ejection -------------------------------------------------------


def test_pick_least_loaded_from_gauges(tmp_path):
    def scenario(pkg, tmp):
        router, fleet, _ = make_router(pkg, tmp)
        picks = []
        for q0, b0, kv0, ready0 in ((3, 2, 10, True), (1, 1, 50, True),
                                    (1, 1, 50, False), (0, 0, 5, True)):
            fleet.docs["r0"]["stats"].update(queue_depth=q0, slots_busy=b0,
                                             kv_blocks_free=kv0)
            fleet.docs["r1"]["stats"].update(queue_depth=1, slots_busy=1)
            fleet.docs["r0"]["ready"] = ready0
            router.health_tick()
            picks.append(router.pick().replica.name)
        return {"picks": picks, "tiers": router.tier_counts()}

    seen = twin(scenario, tmp_path)
    # busier r0 loses; equal load -> most KV blocks; draining never picked
    assert seen["picks"] == ["r1", "r0", "r1", "r0"]


@pytest.mark.parametrize("cause", ["healthz_503", "unreachable"])
def test_ejection_with_blackbox_and_failure_budget(tmp_path, cause):
    bb = tmp_path / "r1-blackbox.json"
    bb.write_text(json.dumps({"blackbox": True, "reason": "serve_loop:RuntimeError",
                              "t_unix": 1.0, "events": [{"kind": "serve_finish"}] * 3}))

    def scenario(pkg, tmp):
        router, fleet, clock = make_router(pkg, tmp, blackbox={"r1": str(bb)},
                                           eject_after_failures=3)
        router.health_tick()
        statuses = []
        if cause == "healthz_503":
            fleet.docs["r1"].update(live=False, ready=False)
        else:
            fleet.docs["r1"].update(reachable=False, live=False, ready=False)
        for _ in range(3):
            clock.advance(1.0)
            router.health_tick()
            statuses.append(router.state_of("r1")["status"])
        fleet.docs["r1"].update(reachable=True, live=True, ready=True)
        router.health_tick()
        statuses.append(router.state_of("r1")["status"])
        s = router.fleet_stats()
        return {"statuses": statuses, "events": events(tmp),
                "ejected": s["replicas_ejected"], "metrics": router.render_metrics()}

    seen = twin(scenario, tmp_path)
    ej = [e for e in seen["events"] if e["deploy_event"] == "eject"]
    assert len(ej) == 1 and ej[0]["reason"] == cause
    assert ej[0]["blackbox"]["events"] == 3 and seen["ejected"] == 1
    if cause == "healthz_503":
        assert seen["statuses"] == ["ejected"] * 4  # at once, never back
    else:
        assert seen["statuses"] == ["serving", "serving", "ejected", "ejected"]


def test_push_drains_one_replica_at_a_time(tmp_path):
    def scenario(pkg, tmp):
        router, fleet, _ = make_router(pkg, tmp, drain_timeout_s=10.0)
        router.health_tick()
        fleet.docs["r0"]["stats"]["in_flight"] = 2
        fleet.finishing = True
        results = router.push_weights("/ckpt", 4)
        return {"results": results, "posts": [(n, p, d) for n, p, d in fleet.posts],
                "events": events(tmp),
                "generations": router.fleet_stats()["deploy_generations"]}

    seen = twin(scenario, tmp_path)
    assert [r["ok"] for r in seen["results"]] == [True, True]
    assert [(n, p) for n, p, _ in seen["posts"]] == [
        ("r0", "/admin/drain"), ("r0", "/admin/swap"), ("r0", "/admin/resume"),
        ("r1", "/admin/drain"), ("r1", "/admin/swap"), ("r1", "/admin/resume")]
    assert [e["deploy_event"] for e in seen["events"]] == ["drain", "swap", "drain", "swap"]
    assert seen["generations"] == {"r0": 4, "r1": 4}


@pytest.mark.parametrize("reply", [
    (429, {"error": "queue full"}),
    (503, {"error": "draining"}),
    (429, {"error": "shed", "shed": True, "shed_class": 3, "max_priority": 1}),
    (500, "a bare string body"),
], ids=["busy-429", "503", "shed-429", "non-dict-500"])
def test_generate_retry_and_terminal_replies(tmp_path, reply):
    def scenario(pkg, tmp):
        router, fleet, _ = make_router(pkg, tmp, hedge_after_s=0)
        fleet.docs["r1"]["stats"].update(queue_depth=5)  # r0 is the pick
        router.health_tick()
        fleet.generate_reply["r0"] = reply
        code, out = router.handle_generate({"token_ids": [1, 2], "priority": 3})
        code2, out2 = router.handle_generate({"token_ids": [3], "request_id": "client-7"})
        s = router.fleet_stats()
        return {"replies": [(code, out), (code2, out2)],
                "posts": [(n, d.get("request_id")) for n, d in gen_posts(fleet)],
                "retries": s["retries"], "shed": s["shed_by_class"]}

    seen = twin(scenario, tmp_path)
    (code, out), (code2, out2) = seen["replies"]
    if reply[0] == 429 and isinstance(reply[1], dict) and reply[1].get("shed"):
        assert code == 429 and out["shed"] is True and 3 in seen["shed"]
    elif reply[0] == 500:
        assert code == 200 and out["served_by"] == "r1" and seen["retries"] >= 1
    else:
        assert code == 200 and out["served_by"] == "r1"
    # one request id rides every attempt; a client's id is kept
    assert out["request_id"] == "rtr-1" and out2["request_id"] == "client-7"


def test_goodput_and_elastic_membership(tmp_path):
    def scenario(pkg, tmp):
        router, fleet, clock = make_router(pkg, tmp)
        router.health_tick()
        clock.advance(5.0)
        router.add_replica(pkg.router.Replica("a1", "http://fake/a1"))
        fleet.docs["a1"] = {"reachable": False, "live": False, "ready": False, "stats": {}}
        for _ in range(4):
            router.health_tick()
        booting = router.state_of("a1")
        clock.advance(3.0)
        fleet.docs["a1"].update(reachable=True, live=True, ready=True)
        router.health_tick()
        clock.advance(2.0)
        fleet.docs["r1"].update(live=False, ready=False)
        router.health_tick()
        clock.advance(4.0)
        mid = router.fleet_stats()
        router.remove_replica("a1", drain=False, reason="scale_down")
        end = router.fleet_stats()
        errors = []
        for bad in (lambda: router.add_replica(pkg.router.Replica("r0", "http://x")),
                    lambda: router.remove_replica("a1")):
            try:
                bad()
            except ValueError as e:
                errors.append(str(e))
        return {"booting": booting, "mid": mid, "end": end, "events": events(tmp),
                "errors": errors, "names": router.replica_names()}

    seen = twin(scenario, tmp_path)
    assert seen["booting"]["status"] == "scaling_up" and seen["booting"]["failures"] == 0
    secs = seen["mid"]["replica_seconds"]
    assert secs["a1"]["scaling_up"] == pytest.approx(3.0)
    assert secs["r1"]["ejected"] == pytest.approx(4.0)
    # every tracked replica-second lands in exactly one state
    end = seen["end"]
    total = sum(end["seconds_by_state"].values())
    assert total == pytest.approx(2 * end["elapsed_s"] + 9.0)
    assert end["replicas_departed"] == 1 and len(seen["errors"]) == 2
    assert seen["names"] == ["r0", "r1"]


def test_admission_ceiling_and_endpoint(tmp_path):
    def scenario(pkg, tmp):
        router, fleet, _ = make_router(pkg, tmp)
        router.health_tick()
        router.set_admission(2, reason="test pressure")
        replies = [router.handle_generate({"token_ids": [1], "priority": p})
                   for p in (5, 2)]
        router.set_admission(2)  # idempotent: no second event
        codes = [router.handle_admission({"max_priority": v})[0]
                 for v in (-1, 10, -2, "3", True, None, 4)]
        return {"replies": replies, "codes": codes, "events": events(tmp),
                "ceiling": router.admission_max_priority(),
                "shed": router.fleet_stats()["shed_by_class"],
                "posts": len(fleet.posts)}

    seen = twin(scenario, tmp_path)
    (c5, o5), (c2, _) = seen["replies"]
    assert c5 == 429 and o5["shed"] is True and c2 == 200 and seen["posts"] == 1
    assert seen["codes"] == [200, 400, 400, 400, 400, 400, 200] and seen["ceiling"] == 4
    assert [e["deploy_event"] for e in seen["events"]].count("shed_level") == 3


# -- request-level resilience ---------------------------------------------------


def test_deadline_propagation_and_expiry(tmp_path):
    def scenario(pkg, tmp):
        router, fleet, clock = make_router(pkg, tmp, hedge_after_s=0)
        router.health_tick()
        out = [router.handle_generate({"token_ids": [1], "timeout_s": 2.0}),
               router.handle_generate({"token_ids": [1], "timeout_s": 2.0,
                                       "deadline_s": 0.5}),
               router.handle_generate({"token_ids": [1]}),
               router.handle_generate({"token_ids": [1], "timeout_s": -1})]

        def slow(doc):  # the replica answers after the client's budget
            clock.advance(5.0)
            return 500, {"error": "late"}
        fleet.generate_reply["r0"] = slow
        fleet.generate_reply["r1"] = slow
        out.append(router.handle_generate({"token_ids": [1], "timeout_s": 1.0}))
        s = router.fleet_stats()
        return {"replies": [(c, o) for c, o in out],
                "deadlines": [d.get("deadline_s") for _, d in gen_posts(fleet)],
                "expired": s["deadline_expired"]}

    seen = twin(scenario, tmp_path)
    assert seen["deadlines"][:3] == [2.0, 0.5, None]
    assert seen["replies"][3][0] == 400 and seen["replies"][4][0] == 504
    assert seen["expired"] == 1


def test_hedge_first_answer_wins_and_loser_is_cancelled(tmp_path):
    def scenario(pkg, tmp):
        router, fleet, _ = make_router(pkg, tmp, hedge_after_s=0.05)
        router.health_tick()
        stuck = threading.Event()
        fleet.block["r0"] = stuck
        code, out = router.handle_generate({"prompt": [1, 2, 3]})
        cancelled = wait_for(lambda: any(
            n == "r0" and p == "/v1/cancel" and d == {"request_id": out["request_id"]}
            for n, p, d in fleet.posts))
        stuck.set()
        assert wait_for(lambda: len(gen_posts(fleet)) == 2)
        s = router.fleet_stats()
        return {"code": code, "served_by": out["served_by"], "cancelled": cancelled,
                "hedges": (s["hedges"], s["hedge_wins"]),
                "rids": sorted({d["request_id"] for _, d in gen_posts(fleet)})}

    seen = twin(scenario, tmp_path)
    assert seen == {"code": 200, "served_by": "r1", "cancelled": True,
                    "hedges": (1, 1), "rids": ["rtr-1"]}


def test_hedge_delay_modes(tmp_path):
    def scenario(pkg, tmp):
        out = []
        for kw in ({"hedge_after_s": 1.5}, {"hedge_after_s": 0}, {"hedge_min_samples": 10}):
            router, _, _ = make_router(pkg, tmp, **kw)
            out.append(router._hedge_delay())
        for i in range(10):
            router._latencies.append(0.1 * (i + 1))
        out.append(router._hedge_delay())
        router._latencies.clear()
        router._latencies.extend([0.001] * 10)
        out.append(router._hedge_delay())
        return out

    assert twin(scenario, tmp_path) == [1.5, None, None, pytest.approx(1.0), 0.05]


def test_retry_budget_exhausts_then_refills(tmp_path):
    def scenario(pkg, tmp):
        router, fleet, _ = make_router(pkg, tmp, hedge_after_s=0, retry_budget_min=1.0,
                                       retry_budget_ratio=0.25, breaker_failure_rate=0.9)
        router.health_tick()
        seq = []
        for reply in [(500, {"error": "sick"})] * 2 + [(200, {"ok": True})] * 3 \
                + [(500, {"error": "sick"})]:
            fleet.generate_reply["r0"] = reply
            code, out = router.handle_generate({"prompt": [1]})
            s = router.fleet_stats()
            seq.append((code, out.get("served_by"), s["retries"],
                        s["retry_budget_exhausted"], s["retry_budget_tokens"]))
        return seq

    seq = twin(scenario, tmp_path)
    assert [c for c, *_ in seq] == [200, 500, 200, 200, 200, 200]
    assert seq[1][3] == 1 and seq[-1][2] == 2


def test_breaker_trips_half_opens_and_recovers(tmp_path):
    def scenario(pkg, tmp):
        router, fleet, clock = make_router(
            pkg, tmp, hedge_after_s=0, retry_budget_min=10.0, breaker_window=4,
            breaker_min_samples=2, breaker_failure_rate=0.5, breaker_open_s=5.0)
        router.health_tick()
        fleet.generate_reply["r0"] = (500, {"error": "gray"})
        served = [router.handle_generate({"prompt": [1]})[1]["served_by"] for _ in range(3)]
        opened = (router.fleet_stats()["breaker_state"], router.breaker_open_replicas())
        clock.advance(4.0)
        open_s = router.fleet_stats()["seconds_by_state"]["breaker_open"]
        clock.advance(1.0)
        router.health_tick()
        fleet.docs["r1"]["ready"] = False
        router.health_tick()
        fleet.generate_reply["r0"] = (200, {"ok": True})
        code, out = router.handle_generate({"prompt": [1]})
        return {"served": served, "opened": opened, "open_s": open_s,
                "recovered": (code, out["served_by"], router.fleet_stats()["breaker_state"]),
                "events": [e["deploy_event"] for e in events(tmp)],
                "metrics": router.render_metrics()}

    seen = twin(scenario, tmp_path)
    assert seen["served"] == ["r1", "r1", "r1"]
    assert seen["opened"] == ({"r0": "open", "r1": "closed"}, ["r0"])
    assert seen["open_s"] == pytest.approx(4.0)
    assert seen["recovered"] == (200, "r0", {"r0": "closed", "r1": "closed"})
    assert [k for k in seen["events"] if k.startswith("breaker")] == [
        "breaker_open", "breaker_half_open", "breaker_close"]


def test_breaker_unit_semantics():
    def scenario(mod):
        clock = FakeClock()
        b = mod._Breaker(clock, window=4, min_samples=2, failure_rate=0.5, open_s=3.0,
                         slow_s=1.0)
        states = []
        for ok, lat, dt in ((True, 0.1, 0), (False, 0.1, 0), (True, 2.0, 0),
                            (True, 0.1, 3.0), (True, 0.1, 0), (False, 0.1, 0)):
            clock.advance(dt)
            states.append((b.current(), b.rank()))
            b.note(ok, lat)
        return states

    assert scenario(torch_router) == scenario(jax_router)


def test_slo_route_around_and_canary_gate(tmp_path):
    def scenario(pkg, tmp):
        router, fleet, _ = make_router(pkg, tmp)
        router.health_tick()
        seq = []
        for rule, target, firing in (("ttft", "r0", True), ("goodput", None, True),
                                     ("goodput", "fleet", True), ("goodput", None, False),
                                     ("ttft", "r0", False)):
            code, out = router.handle_slo({"rule": rule, "target": target,
                                           "firing": firing,
                                           "scope": "fleet" if rule == "goodput"
                                           else "replica"})
            seq.append((code, router.slo_burning(), router.pick().replica.name))
        return {"seq": seq, "state": router.slo_state(), "bad": router.handle_slo({})[0]}

    seen = twin(scenario, tmp_path)
    assert seen["seq"][0][2] == "r1" and seen["seq"][1][1] is True
    assert seen["bad"] == 400


def test_router_spans_carry_the_request_id(tmp_path):
    def scenario(pkg, tmp):
        import nanodiloco_tpu.obs.tracer as jt
        import nanodiloco_tpu_torch.obs.tracer as pt
        tracer_mod = pt if pkg.router is torch_router else jt
        clock = FakeClock()
        fleet = ScriptedFleet(["r0"])
        tracer = tracer_mod.SpanTracer(clock=clock, process_name="router")
        router = pkg.router.FleetRouter(
            [pkg.router.Replica("r0", "http://fake/r0")], probe=fleet.probe,
            post=fleet.post, clock=clock, wall=clock, sleep=clock.advance,
            tracer=tracer, quiet=True, hedge_after_s=0)
        router.health_tick()
        router.handle_generate({"token_ids": [1], "request_id": "q-1"})
        evs = [e for e in tracer.to_chrome()["traceEvents"] if e["ph"] == "X"]
        return sorted((e["name"], e["args"]["request_id"], e["args"].get("outcome"),
                       "trace_id" in e["args"]) for e in evs)

    assert twin(scenario, tmp_path) == [("forward", "q-1", "ok", True),
                                        ("route", "q-1", "ok", True)]


# -- the deploy controller over a scripted router ------------------------------

GOOD = {"canary_eval_loss": 3.0, "ttft_p50_s": 0.05, "client_tokens_per_sec": 100.0,
        "errors": 0, "requests": 4}
BETTER = {**GOOD, "canary_eval_loss": 2.8}
WORSE = {**GOOD, "canary_eval_loss": 3.5}
NAN = {**GOOD, "canary_eval_loss": float("nan")}


@pytest.mark.parametrize("plan", [
    {"steps": [4], "bench": {2: GOOD, 4: BETTER}, "initial": 2},
    {"steps": [4, 4], "bench": {2: GOOD, 4: WORSE}, "initial": 2},
    {"steps": [4], "bench": {4: WORSE}, "initial": None},
    {"steps": [4, 6], "bench": {2: GOOD, 4: NAN, 6: BETTER}, "initial": 2},
    {"steps": [4], "bench": {2: RuntimeError("gc'd"), 4: GOOD}, "initial": 2},
    {"steps": [4], "bench": {2: GOOD, 4: {**GOOD, "errors": 1}}, "initial": 2},
], ids=["promote", "rollback-once", "first-deploy-fails", "nan-then-good",
        "baseline-gone", "request-errors"])
def test_controller_decisions(tmp_path, plan):
    def scenario(pkg, tmp):
        router, fleet, _ = make_router(pkg, tmp, drain_timeout_s=0.1)
        router.health_tick()
        benched = []

        def bench(url, ckpt, step):
            benched.append(step)
            rec = plan["bench"][step]
            if isinstance(rec, Exception):
                raise rec
            return dict(rec)

        ctl = pkg.deploy.DeployController(router, str(tmp / "ckpt"),
                                          initial_step=plan["initial"], bench=bench)
        actions = []
        for step in plan["steps"]:
            if step in ctl.failed_steps:
                actions.append("skipped")  # poll_once's blacklist rule
                continue
            actions.append(ctl.deploy(step))
        evs = [{k: v for k, v in e.items() if k != "record"} for e in events(tmp)]
        return {"actions": actions, "benched": benched, "deployed": ctl.deployed_step,
                "failed": sorted(ctl.failed_steps), "events": json.dumps(evs)}

    seen = twin(scenario, tmp_path)
    kinds = [e["deploy_event"] for e in json.loads(seen["events"])]
    first = seen["actions"][0]
    assert first in ("promote", "rollback", "rollback_failed")
    if first == "rollback":
        assert kinds.index("rollback") > kinds.index("canary_verdict")
    if plan["steps"] == [4, 6]:
        assert seen["actions"] == ["rollback", "promote"] and seen["failed"] == [4]


def test_controller_poll_reads_committed_port_checkpoints(tmp_path):
    """``latest_checkpoint_step`` reads the port's ``step_<n>.pt`` names
    (a ``.tmp`` mid-save never counts); the watch loop canaries each new
    step once and never goes backwards."""
    ck = tmp_path / "ckpt"
    assert torch_deploy.latest_checkpoint_step(str(ck)) is None
    ck.mkdir()
    assert torch_deploy.latest_checkpoint_step(str(ck)) is None
    (ck / "step_2.pt").write_bytes(b"")
    (ck / "step_9.tmp").write_bytes(b"")
    assert torch_deploy.latest_checkpoint_step(str(ck)) == 2
    router, fleet, _ = make_router(PACKAGES["torch"], tmp_path, drain_timeout_s=0.1)
    router.health_tick()
    benched = []
    ctl = torch_deploy.DeployController(
        router, str(ck), initial_step=2,
        bench=lambda url, c, s: benched.append(s) or dict(GOOD))
    assert ctl.poll_once() is None
    (ck / "step_4.pt").write_bytes(b"")
    assert ctl.poll_once() == "promote" and ctl.deployed_step == 4
    (ck / "step_4.pt").rename(ck / "step_3.pt")
    assert ctl.poll_once() is None  # never deploy backwards
    assert benched == [2, 4]
