"""Predictive autoscaler: the observability plane closing its own loop.

PR 15 built the fleet's senses (collector series, burn rates) and the
router built its actuators (launch/eject, drain/refill); this module
connects trend to action. A control loop watches the collector through
``obs/forecast.py``'s ``CapacityModel`` — queue-depth slope, exhaustion
forecasts, fleet burn state, NEVER raw point gauges — and:

- **scales out** when a resource is forecast to exhaust within
  ``scale_out_horizon_s`` (e.g. ``kv_blocks_free`` trending to 0), by
  launching replicas through a ``ReplicaProvider`` and joining them to
  the ``FleetRouter`` via ``add_replica`` (their boot seconds are
  booked to the ``scaling_up`` goodput bucket — MegaScale's
  every-second-accounted discipline, arXiv:2402.15627, extended to
  elastic capacity);
- **scales in** after sustained headroom (no exhaustion forecast, flat
  or falling queue trend), through the router's drain discipline
  (``remove_replica``) so in-flight streams finish first;
- **rate-limits itself**: a cooldown between scale actions, a max step
  size per action, and hysteresis (``hysteresis_ticks`` consecutive
  agreeing observations before acting) so forecast noise cannot flap
  the fleet;
- **is preemption-aware**: a provider reporting preempted replicas
  (the PR-3 supervisor lifecycle — exit 75 / SIGTERM is "the machine
  was reclaimed", not "the replica failed") gets them relaunched
  IMMEDIATELY, outside the cooldown and step budget, because spot
  capacity only counts as serving capacity if reclaims are recovered
  reflexively;
- **sheds by class** under pressure: when the fleet burns an SLO or
  exhaustion is forecast inside ``shed_horizon_s`` while already at
  ``max_replicas``, the admission ceiling drops one class per tick
  (lowest class first); it recovers one class per tick once the
  pressure clears — so the highest class's SLO holds while load
  exceeds what the fleet can add capacity for.

Everything is injectable (clock, model, provider, router) and the loop
is a plain ``tick()`` method — every decision is provable with scripted
components and a fake clock, no sockets, no model (tier-1 budget).
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import time
from typing import Callable, Protocol

from nanodiloco_tpu_torch.fleet.router import FleetRouter, Replica
from nanodiloco_tpu_torch.obs.forecast import CapacityEstimate, CapacityModel
from nanodiloco_tpu_torch.resilience.supervisor import PREEMPT_EXIT_CODE


class ReplicaProvider(Protocol):
    """Where replicas come from and go to. ``launch`` returns the
    joined ``Replica`` (the autoscaler adds it to the router);
    ``retire`` reclaims one the router already removed; ``preempted``
    lists names whose machines were reclaimed since the last call
    (the autoscaler relaunches them immediately)."""

    def launch(self) -> Replica: ...

    def retire(self, name: str) -> None: ...

    def preempted(self) -> list[str]: ...


class Autoscaler:
    """The control loop. ``run(stop)`` ticks on ``interval_s``;
    ``tick()`` is one observation->decision->action pass returning a
    record of what it saw and did (the drill's assertion surface)."""

    def __init__(
        self,
        router: FleetRouter,
        model: CapacityModel,
        provider: ReplicaProvider,
        *,
        min_replicas: int = 1,
        max_replicas: int = 4,
        interval_s: float = 2.0,
        cooldown_s: float = 20.0,
        max_step: int = 1,
        hysteresis_ticks: int = 2,
        scale_out_horizon_s: float = 60.0,
        scale_in_idle_ticks: int = 5,
        shed_horizon_s: float = 10.0,
        max_shed_floor: int = 0,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas; got "
                f"{min_replicas}..{max_replicas}"
            )
        if max_step < 1:
            raise ValueError(f"max_step must be >= 1; got {max_step}")
        if hysteresis_ticks < 1:
            raise ValueError(
                f"hysteresis_ticks must be >= 1; got {hysteresis_ticks}"
            )
        if not 0 <= max_shed_floor <= 9:
            raise ValueError(
                f"max_shed_floor must be in [0, 9]; got {max_shed_floor}"
            )
        self.router = router
        self.model = model
        self.provider = provider
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.max_step = int(max_step)
        self.hysteresis_ticks = int(hysteresis_ticks)
        self.scale_out_horizon_s = float(scale_out_horizon_s)
        self.scale_in_idle_ticks = int(scale_in_idle_ticks)
        self.shed_horizon_s = float(shed_horizon_s)
        # the lowest the admission ceiling may drop: 0 always protects
        # the most urgent class (shedding class 0 would be the fleet
        # refusing the traffic it exists to protect)
        self.max_shed_floor = int(max_shed_floor)
        self._clock = clock
        self._sleep = sleep
        self._last_scale_t: float | None = None
        self._out_votes = 0   # consecutive ticks voting scale-out
        self._in_votes = 0    # consecutive ticks voting scale-in
        self.ticks = 0

    # -- size + membership ---------------------------------------------------

    def _fleet_size(self) -> int:
        """Replicas that ARE or WILL BE capacity: serving + scaling_up
        (counting a booting replica prevents a second redundant
        scale-out while the first boots — hysteresis alone cannot see
        that)."""
        s = self.router.fleet_stats()
        return s["replicas_serving"] + s["replicas_scaling_up"]

    def _launch(self, n: int, *, why: str, kind: str = "scale_up") -> list[str]:
        names: list[str] = []
        for _ in range(n):
            replica = self.provider.launch()
            self.router.add_replica(replica, source="autoscaler")
            self.router.log_event(kind, replica=replica.name, reason=why)
            names.append(replica.name)
        return names

    def _retire(self, n: int, *, why: str) -> list[str]:
        """Scale in via the router's drain discipline, newest
        autoscaled replicas first (the seed fleet is the stable core),
        never touching a replica below ``min_replicas``."""
        s = self.router.fleet_stats()
        # candidates: ready serving replicas, least-recently added last
        names = [name for name in self.router.replica_names()
                 if self.router.state_of(name)["status"] == "serving"]
        victims = names[::-1][:n]
        out: list[str] = []
        for name in victims:
            if s["replicas_serving"] - len(out) <= self.min_replicas:
                break
            self.router.log_event("scale_down", replica=name, reason=why)
            self.router.remove_replica(name, drain=True,
                                       reason="scale_down")
            self.provider.retire(name)
            out.append(name)
        return out

    # -- the decision --------------------------------------------------------

    def _cooling_down(self, now: float) -> bool:
        return (self._last_scale_t is not None
                and now - self._last_scale_t < self.cooldown_s)

    def _wants_out(self, est: CapacityEstimate) -> str | None:
        """A scale-out reason, or None. Only CONFIDENT forecasts count:
        a two-sample slope from a replica that just booted must not
        grow the fleet."""
        if not est.confident:
            return None
        eta = est.exhaustion_s()
        if eta is not None and eta <= self.scale_out_horizon_s:
            which = ("kv_blocks_free"
                     if eta == est.kv_exhaustion_s else "queue_depth")
            return f"forecast: {which} exhausts in {eta:.1f}s"
        return None

    def _wants_in(self, est: CapacityEstimate) -> bool:
        """Headroom: confident data, nothing forecast to exhaust, and
        the queue trend flat or falling."""
        return (est.confident
                and est.exhaustion_s() is None
                and (est.queue_slope is None or est.queue_slope <= 0.0))

    def tick(self) -> dict:
        """One pass: recover preemptions, observe, decide, act."""
        now = self._clock()
        self.ticks += 1
        rec: dict = {"t": round(now, 3), "tick": self.ticks}

        # 1) preemption recovery — immediate, outside cooldown/step:
        # a reclaimed spot machine is lost capacity RIGHT NOW, and the
        # whole premise of spot serving is reflexive recovery
        for name in self.provider.preempted():
            try:
                self.router.remove_replica(name, drain=False,
                                           reason="preempted")
            except ValueError:
                pass  # already ejected+removed or never joined
            relaunched = self._launch(1, why=f"preempted: {name}",
                                      kind="preempt_resume")
            rec.setdefault("preempt_resumed", []).extend(relaunched)

        # breaker-open replicas are not credible supply: they still
        # scrape (gray failure, not dead), but counting them would let
        # the model see capacity the router is routing around
        breaker = getattr(self.router, "breaker_open_replicas", None)
        excl = getattr(self.model, "set_excluded", None)
        if callable(breaker) and callable(excl):
            excl(breaker())

        est = self.model.estimate(now)
        rec["estimate"] = est.to_dict()
        size = self._fleet_size()
        rec["fleet_size"] = size

        # 2) scaling votes (hysteresis: act only after N consecutive
        # agreeing ticks; any disagreement resets the streak)
        out_reason = self._wants_out(est)
        if out_reason:
            self._out_votes += 1
            self._in_votes = 0
        elif self._wants_in(est):
            self._in_votes += 1
            self._out_votes = 0
        else:
            self._out_votes = self._in_votes = 0

        if (out_reason and self._out_votes >= self.hysteresis_ticks
                and size < self.max_replicas
                and not self._cooling_down(now)):
            n = min(self.max_step, self.max_replicas - size)
            rec["scaled_up"] = self._launch(n, why=out_reason)
            self._last_scale_t = now
            self._out_votes = 0
        elif (self._in_votes >= max(self.hysteresis_ticks,
                                    self.scale_in_idle_ticks)
                and size > self.min_replicas
                and not self._cooling_down(now)):
            n = min(self.max_step, size - self.min_replicas)
            removed = self._retire(n, why="sustained headroom")
            if removed:
                rec["scaled_down"] = removed
                self._last_scale_t = now
            self._in_votes = 0
        elif size < self.min_replicas and not self._cooling_down(now):
            # below the floor (boot, or a preempted replica the
            # provider could not relaunch): refill without a vote
            rec["scaled_up"] = self._launch(
                min(self.max_step, self.min_replicas - size),
                why="below min_replicas",
            )
            self._last_scale_t = now

        # 3) class-aware shedding (an overridable step: the tier-scoped
        # autoscalers in fleet/disagg.py run TWO loops over one fleet,
        # and exactly one of them may own the admission ceiling)
        self._shed_tick(est, rec)
        return rec

    def _shed_tick(self, est: CapacityEstimate, rec: dict) -> None:
        """Class-aware shedding: pressure = fleet-scope SLO burn, or
        exhaustion forecast inside the shed horizon while the fleet
        cannot grow any further. One class per tick each way —
        shedding is an escalation ladder, not a cliff."""
        ceiling = self.router.admission_max_priority()
        pressed = self.router.slo_burning()
        eta = est.exhaustion_s() if est.confident else None
        if (not pressed and eta is not None
                and eta <= self.shed_horizon_s
                and self._fleet_size() >= self.max_replicas):
            pressed = True
        if pressed and ceiling > self.max_shed_floor:
            ceiling = self.router.set_admission(
                ceiling - 1, reason="fleet pressure"
            )
            rec["shed_to"] = ceiling
        elif not pressed and ceiling < 9:
            ceiling = self.router.set_admission(
                ceiling + 1, reason="pressure cleared"
            )
            rec["recovered_to"] = ceiling
        rec["admission_max_priority"] = ceiling

    def run(self, stop=None, max_ticks: int | None = None) -> None:
        """Tick until ``stop`` is set (or ``max_ticks`` exhausted)."""
        n = 0
        while stop is None or not stop.is_set():
            try:
                self.tick()
            except Exception:
                # one bad tick (a racing replica removal, a transient
                # probe error) must not kill the control loop
                pass
            n += 1
            if max_ticks is not None and n >= max_ticks:
                return
            if stop is not None:
                stop.wait(self.interval_s)
            else:
                self._sleep(self.interval_s)


class ProcessReplicaProvider:
    """Replicas as local serve subprocesses — the CLI's provider
    (``fleet --autoscale-template``) and the surge drill's.

    ``template`` is a shell-ish command string with ``{port}`` (and
    optionally ``{name}``) placeholders; each launch picks a free port,
    formats, and spawns the child in its own process group. A child
    that exits with the supervisor's ``PREEMPT_EXIT_CODE`` (75) or dies
    by SIGTERM — the spot reclaim signal — is reported by
    ``preempted()`` exactly once so the autoscaler relaunches it;
    a clean exit is simply gone."""

    def __init__(self, template: str, *, name_prefix: str = "auto",
                 host: str = "127.0.0.1", env: dict | None = None,
                 stdout=None) -> None:
        self.template = template
        self.name_prefix = name_prefix
        self.host = host
        self.env = env
        self._stdout = stdout
        self._seq = 0
        self._procs: dict[str, subprocess.Popen] = {}
        self._ports: dict[str, int] = {}

    @staticmethod
    def _free_port(host: str) -> int:
        import socket

        with socket.socket() as s:
            s.bind((host, 0))
            return s.getsockname()[1]

    def launch(self) -> Replica:
        self._seq += 1
        name = f"{self.name_prefix}{self._seq}"
        port = self._free_port(self.host)
        cmd = self.template.format(port=port, name=name)
        kw: dict = {"start_new_session": True}
        if self.env is not None:
            kw["env"] = {**os.environ, **self.env}
        if self._stdout is not None:
            kw["stdout"] = self._stdout
            kw["stderr"] = subprocess.STDOUT
        proc = subprocess.Popen(shlex.split(cmd), **kw)
        self._procs[name] = proc
        self._ports[name] = port
        return Replica(name=name, url=f"http://{self.host}:{port}")

    def retire(self, name: str) -> None:
        proc = self._procs.pop(name, None)
        self._ports.pop(name, None)
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=5)

    def preempted(self) -> list[str]:
        """Names whose child died a preemption death since the last
        call (exit 75 or SIGTERM). Crashed children (any other nonzero
        exit) are dropped from tracking but NOT relaunched here — the
        router's health loop ejects them and the autoscaler's
        min-replicas floor refills; relaunching a crash-looping replica
        at preemption speed would be a fork bomb."""
        gone: list[str] = []
        for name, proc in list(self._procs.items()):
            rc = proc.poll()
            if rc is None:
                continue
            del self._procs[name]
            self._ports.pop(name, None)
            if rc == PREEMPT_EXIT_CODE or rc == -signal.SIGTERM:
                gone.append(name)
        return gone

    def pids(self) -> dict[str, int]:
        """Live child pids by replica name (the drill's preemption
        injection surface)."""
        return {n: p.pid for n, p in self._procs.items()
                if p.poll() is None}

    def stop_all(self) -> None:
        for name in list(self._procs):
            self.retire(name)
