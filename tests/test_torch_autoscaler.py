"""The port's predictive autoscaler (nanodiloco_tpu_torch/fleet/autoscaler.py)
against the JAX package's:

- every decision path of ``Autoscaler.tick()`` (hysteresis, cooldown,
  step and ceiling clamps, confidence, drain-first scale-in newest
  first, reflexive preemption recovery, the below-min refill, the
  class-shed ladder) with a scripted router, provider, capacity
  estimate and clock: the same tick records, events, launches,
  retirements and admission ceilings;
- the whole chain — each package's real ``FleetRouter`` over scripted
  replicas, its ``SeriesStore`` and ``CapacityModel`` fed the same
  series — through a burst and the idle tail after it;
- ``ProcessReplicaProvider``: SIGTERM is a preemption reported once, a
  SIGKILL a crash; and a replica launched from the port's command
  template (``python -m nanodiloco_tpu_torch serve --device cpu``) joins
  a real router, serves, and drains out.
"""

import functools
import json
import os
import signal
import sys
import threading
import time
import types

import pytest
import torch

import nanodiloco_tpu.fleet.autoscaler as jax_autoscaler
import nanodiloco_tpu.fleet.router as jax_router
import nanodiloco_tpu.obs.collector as jax_collector
import nanodiloco_tpu.obs.forecast as jax_forecast
import nanodiloco_tpu_torch.fleet.autoscaler as torch_autoscaler
import nanodiloco_tpu_torch.fleet.router as torch_router
import nanodiloco_tpu_torch.obs.collector as torch_collector
import nanodiloco_tpu_torch.obs.forecast as torch_forecast
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.serve import http_post_json
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

PACKAGES = {
    "jax": types.SimpleNamespace(autoscaler=jax_autoscaler, router=jax_router,
                                 collector=jax_collector, forecast=jax_forecast),
    "torch": types.SimpleNamespace(autoscaler=torch_autoscaler, router=torch_router,
                                   collector=torch_collector, forecast=torch_forecast),
}


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


def wait_for(cond, timeout_s=30.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return False


def est(pkg, kind):
    kw = {"pressure": dict(kv_eta=5.0, slope=2.0), "headroom": dict(slope=-0.5),
          "neutral": dict(slope=1.0), "unsure": dict(kv_eta=5.0, slope=2.0, confident=False),
          "exhaust": dict(kv_eta=2.0, q_eta=1.0, slope=3.0)}[kind]
    return pkg.forecast.CapacityEstimate(
        at=0.0, replicas=2, queue_depth=1.0, queue_slope=kw.get("slope", 0.0),
        request_rate=1.0, kv_blocks_free=100.0, kv_exhaustion_s=kw.get("kv_eta"),
        queue_exhaustion_s=kw.get("q_eta"), horizon_s=10.0,
        confident=kw.get("confident", True))


class FakeRouter:
    def __init__(self, serving):
        self.serving = [f"r{i}" for i in range(serving)]
        self.events, self.removed = [], []
        self.admission = 9
        self.burning = False
        self.breakers = []

    def fleet_stats(self):
        return {"replicas_serving": len(self.serving), "replicas_scaling_up": 0}

    def add_replica(self, replica, source=None):
        self.serving.append(replica.name)

    def remove_replica(self, name, drain=True, reason=None):
        if name not in self.serving:
            raise ValueError(name)
        self.serving.remove(name)
        self.removed.append((name, drain, reason))

    def replica_names(self):
        return list(self.serving)

    def state_of(self, name):
        return {"status": "serving"}

    def log_event(self, kind, replica=None, reason=None):
        self.events.append((kind, replica, reason))

    def admission_max_priority(self):
        return self.admission

    def set_admission(self, n, reason=None):
        self.admission = n
        return n

    def slo_burning(self):
        return self.burning

    def breaker_open_replicas(self):
        return list(self.breakers)


class FakeProvider:
    def __init__(self, pkg):
        self.pkg, self.seq, self.retired, self.preempt_queue = pkg, 0, [], []

    def launch(self):
        self.seq += 1
        return self.pkg.router.Replica(name=f"auto{self.seq}", url="http://test")

    def retire(self, name):
        self.retired.append(name)

    def preempted(self):
        out, self.preempt_queue = self.preempt_queue, []
        return out


class FakeModel:
    def __init__(self):
        self.current, self.excluded = None, []

    def estimate(self, now):
        return self.current

    def set_excluded(self, names):
        self.excluded.append(sorted(names))


# each step: (estimate kind, seconds to advance, extra action)
SCRIPTS = {
    "hysteresis-cooldown-clamp": (dict(serving=1, max_replicas=3, max_step=2), [
        ("pressure", 1, None), ("pressure", 1, None), ("pressure", 1, None),
        ("pressure", 5, None), ("pressure", 10, None), ("pressure", 10, None),
        ("pressure", 10, None)]),
    "unconfident-and-disagreement": (dict(serving=1), [
        ("unsure", 1, None), ("unsure", 1, None), ("pressure", 1, None),
        ("headroom", 1, None), ("pressure", 1, None), ("pressure", 1, None)]),
    "scale-in-newest-first-to-min": (dict(serving=1, min_replicas=1), [
        ("pressure", 1, None), ("pressure", 1, None), ("pressure", 11, None),
        ("pressure", 1, None), ("headroom", 11, None), ("headroom", 1, None),
        ("headroom", 1, None), ("headroom", 11, None), ("headroom", 1, None),
        ("headroom", 1, None), ("headroom", 11, None), ("headroom", 1, None)]),
    "preemption-and-refill": (dict(serving=2, min_replicas=2), [
        ("pressure", 1, None), ("pressure", 1, None), ("neutral", 1, "preempt"),
        ("neutral", 1, "drop"), ("neutral", 1, None), ("neutral", 1, None)]),
    "shed-ladder": (dict(serving=4, max_replicas=4), [
        ("exhaust", 1, None), ("exhaust", 1, None), ("exhaust", 1, None),
        ("exhaust", 1, "burn"), ("exhaust", 1, None), ("headroom", 1, "calm"),
        ("headroom", 1, None), ("headroom", 1, None), ("neutral", 1, None)]),
    "breaker-open-supply": (dict(serving=3), [
        ("neutral", 1, "breaker"), ("pressure", 1, None), ("pressure", 1, "heal")]),
}


@pytest.mark.parametrize("case", list(SCRIPTS))
def test_autoscaler_decisions_match_jax(case):
    kw, script = SCRIPTS[case]
    kw = dict(kw)
    serving = kw.pop("serving")
    seen = {}
    for name, pkg in PACKAGES.items():
        router, provider, model = FakeRouter(serving), FakeProvider(pkg), FakeModel()
        clock = types.SimpleNamespace(t=0.0)
        opts = dict(min_replicas=1, max_replicas=4, cooldown_s=10.0, hysteresis_ticks=2,
                    scale_out_horizon_s=30.0, scale_in_idle_ticks=3, shed_horizon_s=10.0)
        opts.update(kw)
        scaler = pkg.autoscaler.Autoscaler(router, model, provider, clock=lambda: clock.t,
                                           **opts)
        ticks = []
        for kind, dt, action in script:
            clock.t += dt
            model.current = est(pkg, kind)
            if action == "preempt":
                provider.preempt_queue.append(router.serving[-1])
            elif action == "drop":
                router.serving.pop()
            elif action == "burn":
                router.burning = True
            elif action == "calm":
                router.burning = False
            elif action == "breaker":
                router.breakers = ["r1"]
            elif action == "heal":
                router.breakers = []
            ticks.append((scaler.tick(), router.admission, list(router.serving)))
        seen[name] = (ticks, router.events, router.removed, provider.retired, model.excluded)
    assert seen["torch"] == seen["jax"]
    events = [k for k, _, _ in seen["torch"][1]]
    assert events, "the script must make the loop act"


def test_constructor_validation_matches_jax():
    bad = [dict(min_replicas=0), dict(min_replicas=3, max_replicas=2), dict(max_step=0),
           dict(hysteresis_ticks=0), dict(max_shed_floor=10)]
    for kw in bad:
        msgs = {}
        for name, pkg in PACKAGES.items():
            with pytest.raises(ValueError) as e:
                pkg.autoscaler.Autoscaler(FakeRouter(1), FakeModel(), FakeProvider(pkg), **kw)
            msgs[name] = str(e.value)
        assert msgs["torch"] == msgs["jax"]


def test_whole_chain_router_model_autoscaler_matches_jax(tmp_path):
    """Each package's FleetRouter over scripted replicas, its collector
    store and CapacityModel fed the same queue and KV series: a burst
    grows the fleet, the idle tail drains it back to the floor, and
    every replica-second lands in a goodput state."""
    seen = {}
    for name, pkg in PACKAGES.items():
        clock = types.SimpleNamespace(t=0.0)
        now = lambda: clock.t  # noqa: E731
        docs = {}

        def probe(replica):
            d = docs.setdefault(replica.name, {"reachable": True, "live": True, "ready": True,
                                               "stats": {"queue_depth": 0, "slots_busy": 0,
                                                         "kv_blocks_free": 40, "in_flight": 0}})
            return json.loads(json.dumps(d))

        def post(replica, path, doc, timeout=None):
            return 200, {"ok": True}

        d = tmp_path / name
        d.mkdir()
        router = pkg.router.FleetRouter(
            [pkg.router.Replica("r0", "http://fake/r0")], probe=probe, post=post,
            clock=now, wall=now, sleep=lambda s: None, events_jsonl=str(d / "ev.jsonl"),
            quiet=True, drain_timeout_s=0.0)
        store = pkg.collector.SeriesStore()
        model = pkg.forecast.CapacityModel(store, window_s=20.0)
        provider = FakeProvider(pkg)
        scaler = pkg.autoscaler.Autoscaler(router, model, provider, clock=now, min_replicas=1,
                                           max_replicas=3, cooldown_s=4.0, hysteresis_ticks=2,
                                           scale_out_horizon_s=30.0, scale_in_idle_ticks=3)
        trace = []
        for tick in range(60):
            clock.t += 1.0
            burst = 6 <= tick < 26
            for n in router.replica_names():
                q = float(tick - 5) if burst else 0.0
                kv = max(0.0, 40.0 - 1.5 * (tick - 5)) if burst else 40.0
                for sample, v in ((pkg.forecast.QUEUE_DEPTH_SAMPLE, q),
                                  (pkg.forecast.KV_FREE_SAMPLE, kv),
                                  (pkg.forecast.SLOTS_TOTAL_SAMPLE, 4.0),
                                  (pkg.forecast.REQUESTS_TOTAL_SAMPLE, 3.0 * tick)):
                    store.add(f"{n}:{sample}", clock.t, v)
            router.health_tick()
            rec = scaler.tick()
            trace.append((rec.get("action"), router.replica_names(),
                          router.admission_max_priority()))
        stats = router.fleet_stats()
        seen[name] = (trace, stats, (d / "ev.jsonl").read_text())
    assert seen["torch"] == seen["jax"]
    trace, stats, _ = seen["torch"]
    assert max(len(names) for _, names, _ in trace) >= 2  # the burst grew the fleet
    assert len(trace[-1][1]) == 1                          # and the tail drained it
    # every tracked replica-second is in one state, departed ones too
    by_state = stats["seconds_by_state"]
    assert sum(by_state.values()) > stats["elapsed_s"] and by_state["scaling_up"] > 0
    assert stats["fleet_goodput_fraction"] == pytest.approx(
        by_state["serving_ready"] / sum(by_state.values()), abs=1e-6)


def test_sigkill_is_a_crash_sigterm_a_preemption():
    seen = {}
    for name, pkg in PACKAGES.items():
        provider = pkg.autoscaler.ProcessReplicaProvider("sleep 30")
        try:
            r1, r2 = provider.launch(), provider.launch()
            pids = provider.pids()
            os.kill(pids[r1.name], signal.SIGKILL)
            os.kill(pids[r2.name], signal.SIGTERM)
            assert wait_for(lambda: provider.pids() == {} or not any(
                _alive(p) for p in pids.values()), 10.0)
            seen[name] = (provider.preempted(), provider.preempted())
            assert provider.pids() == {}
        finally:
            provider.stop_all()
    assert seen["torch"] == seen["jax"] == (["auto2"], [])


def _alive(pid):
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port checkpoint of a tiny model (one round on the CPU)."""
    d = tmp_path_factory.mktemp("ck")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train(TrainConfig(
            model=LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                              num_attention_heads=4, num_key_value_heads=2,
                              num_hidden_layers=2, max_position_embeddings=64),
            seed=3, batch_size=2, per_device_batch_size=2, seq_length=32, warmup_steps=1,
            total_steps=2, inner_steps=2, num_workers=1, checkpoint_dir=str(d / "ck"),
            log_dir=None, quiet=True, dynamics_metrics=False), device="cpu")
    finally:
        torch.set_num_threads(n)
    return str(d / "ck")


@within(90)
def test_template_replica_joins_serves_and_drains(checkpoint):
    """The CLI's provider with the port's serve command: the child boots
    on the CPU, the router promotes it from scaling_up to serving on its
    first ready probe, it answers through the router, and scale-in
    drains and retires it (the child exits)."""
    template = (f"{sys.executable} -m nanodiloco_tpu_torch serve --checkpoint-dir {checkpoint}"
                " --device cpu --host 127.0.0.1 --port {port} --slots 2 --max-len 64")
    provider = torch_autoscaler.ProcessReplicaProvider(template, env={"OMP_NUM_THREADS": "1"})
    router = torch_router.FleetRouter([torch_router.Replica("seed", "http://127.0.0.1:1")],
                                      quiet=True, drain_timeout_s=5.0)
    try:
        rep = provider.launch()
        router.add_replica(rep)
        assert router.state_of(rep.name)["status"] == "scaling_up"

        def ready():
            router.health_tick()
            return router.state_of(rep.name)["status"] == "serving"
        assert wait_for(ready, 60.0)
        code, out = router.handle_generate({"token_ids": [5, 9, 2], "max_new_tokens": 4,
                                            "temperature": 0.0, "stop": False})
        assert code == 200 and out["served_by"] == rep.name and len(out["token_ids"]) == 4
        code, direct = http_post_json(rep.url + "/v1/generate", {
            "token_ids": [5, 9, 2], "max_new_tokens": 4, "temperature": 0.0, "stop": False})
        assert code == 200 and direct["token_ids"] == out["token_ids"]
        pid = provider.pids()[rep.name]
        router.remove_replica(rep.name, drain=True, reason="scale_down")
        provider.retire(rep.name)
        assert not _alive(pid) or wait_for(lambda: not _alive(pid), 10.0)
        assert rep.name not in router.replica_names()
        assert router.fleet_stats()["replicas_departed"] == 1
    finally:
        provider.stop_all()
