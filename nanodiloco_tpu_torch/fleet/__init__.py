"""The fleet tier: train -> serve, closed.

A copy of ``nanodiloco_tpu/fleet`` (``deploy.py`` rewritten: it reads
the port's ``step_<n>.pt`` checkpoints and runs the canary's loss in
PyTorch on a chosen device).

Three coupled pieces over the serving stack (nanodiloco_tpu_torch/serve):

- hot-swap weight deployment lives IN the engine
  (``InferenceEngine.swap_weights`` + the ``/admin/swap`` endpoint):
  params from the latest training checkpoint replace the serving params
  atomically, the paged KV pool survives untouched, in-flight streams
  finish bit-identically on the weights they were admitted under, and
  the prefix cache is invalidated;
- ``router.FleetRouter`` — a small HTTP front over N serve replicas:
  least-loaded routing from queue-depth + ``kv_blocks_free`` gauges,
  ejection on ``/healthz`` 503 with the replica's flight-recorder black
  box attached to the event, drain/refill one-replica-at-a-time weight
  pushes, and a fleet goodput ledger (replica-seconds accounted by
  state);
- ``deploy.DeployController`` — watches the training checkpoint dir,
  canaries each fresh checkpoint on one replica (closed-loop bench +
  held-out eval loss), and promotes fleet-wide only on a passing
  ``report compare`` verdict — automatic rollback on regression;
- ``chaos.ChaosProxy`` + ``chaos.ChaosPlan`` — a deterministic wire-
  level fault injector (the ``resilience/faults.py`` pattern, keyed by
  request ordinal) that sits in front of a real replica so the router's
  resilience stack (deadlines, hedging, retry budget, circuit breakers)
  is drill-verified, not review-anecdote;
- ``disagg.DisaggRouter`` + ``disagg.TierAutoscaler`` /
  ``disagg.DisaggAutoscaler`` — disaggregated prefill/decode serving:
  admissions prefill on one tier, the parked KV ships between replicas
  (``serve/kvship.py``), the stream resumes mid-request on the decode
  tier, and each tier scales independently off its own pinned capacity
  model.

``python -m nanodiloco_tpu_torch fleet --replica URL[,BLACKBOX] ...`` boots
the router (+ the controller with ``--watch-checkpoint-dir``).
"""

from nanodiloco_tpu_torch.fleet.autoscaler import (
    Autoscaler,
    ProcessReplicaProvider,
    ReplicaProvider,
)
from nanodiloco_tpu_torch.fleet.chaos import (
    DRILL_PLAN,
    ChaosPlan,
    ChaosProxy,
    chaos_families,
    proxy_fleet,
)
from nanodiloco_tpu_torch.fleet.deploy import (
    DeployController,
    canary_bench,
    canary_eval_loss,
    latest_checkpoint_step,
)
from nanodiloco_tpu_torch.fleet.disagg import (
    DisaggAutoscaler,
    DisaggRouter,
    TierAutoscaler,
)
from nanodiloco_tpu_torch.fleet.router import EVENT_KINDS, FleetRouter, Replica

__all__ = [
    "Autoscaler",
    "ChaosPlan",
    "ChaosProxy",
    "DRILL_PLAN",
    "DeployController",
    "DisaggAutoscaler",
    "DisaggRouter",
    "EVENT_KINDS",
    "FleetRouter",
    "ProcessReplicaProvider",
    "Replica",
    "ReplicaProvider",
    "TierAutoscaler",
    "canary_bench",
    "canary_eval_loss",
    "chaos_families",
    "latest_checkpoint_step",
    "proxy_fleet",
]
