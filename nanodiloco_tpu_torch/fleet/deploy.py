"""Canary-gated promotion: close the train->serve loop.

The trainer emits checkpoints round after round (the DiLoCo premise,
arXiv:2311.08105); the fleet serves whichever one it booted with. This
module is the missing arrow: a controller that WATCHES the training
checkpoint directory, pushes each fresh checkpoint to ONE canary
replica, measures it, and promotes fleet-wide only when the measurement
passes the same ``report compare`` verdict the repo's bench records
already gate on — with automatic rollback (re-swap the prior snapshot)
on regression. Every decision is a deploy-JSONL event next to the
router's drain/swap/eject stream, so ``report faults`` /
``summarize_run`` read one coherent timeline of what the fleet did and
why.

The canary measurement (``canary_bench``) has two legs, and the split
is deliberate (PERF.md honest-measurement entry):

- **Serving legs, over the wire.** Closed-loop clients drive the canary
  replica's real ``/v1/generate`` endpoint — TTFT p50 and
  client-visible decode tokens/s, the keys ``compare_runs`` gates with
  its latency/throughput thresholds. This is the only honest way to
  ask "does the new checkpoint still serve"; it catches a checkpoint
  that loads but stalls, errors, or decodes slowly.
- **Quality leg, from the checkpoint.** ``canary_eval_loss``: mean
  next-token cross-entropy of the candidate snapshot on a DETERMINISTIC
  held-out batch (the synthetic-corpus generator at a held-out seed,
  packed with the run's own tokenizer). The serve API returns token
  ids, not logits, so quality must be computed from the weights — and
  computing it from the same checkpoint the canary swapped in keeps the
  two legs about the same bits. A later checkpoint of a healthy run
  scores lower; a poisoned or torn one scores higher or non-finite —
  non-finite is an AUTOMATIC regression (NaN compares false against
  every threshold, so without the explicit check a NaN checkpoint would
  sail through the gate).

Verdict rules, in order: any canary request error -> fail; non-finite
eval loss -> fail; otherwise ``compare_runs(baseline, candidate)`` (the
``report compare`` engine) with its standard thresholds. The baseline
is the PREVIOUS promoted checkpoint's canary record, measured by the
same harness on the same replica — never a number from a different
machine or a different bench shape. A rolled-back step is remembered
and never re-canaried (a broken checkpoint must not put the fleet in a
canary->rollback loop forever).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Callable

# the newest COMMITTED checkpoint step of a training --checkpoint-dir:
# the port's step_<n>.pt files, never a step_<n>.tmp save in progress
# (never canary a torn write); None without one. The supervisor's reader.
from nanodiloco_tpu_torch.resilience.supervisor import latest_checkpoint_step
from nanodiloco_tpu_torch.serve.client import http_post_json


def canary_eval_loss(checkpoint_dir: str, step: int | None, *,
                     rows: int = 2, seq: int = 64,
                     holdout_seed: int = 20260804,
                     device: str = "cuda") -> float:
    """Mean next-token cross-entropy of a checkpoint's merged snapshot
    on a deterministic held-out batch — the canary's quality leg. The
    batch comes from the synthetic-corpus generator at a seed no
    training run uses (training's corpus seed is 0), packed with the
    tokenizer the checkpoint's sidecar names, so the number is
    comparable checkpoint-to-checkpoint and meaningless to game. The
    forward runs on ``device``: without a card, ``"cuda"`` raises."""
    import torch

    from nanodiloco_tpu_torch.__main__ import _load_checkpoint_snapshot
    from nanodiloco_tpu_torch.data.pipeline import pack_corpus, synthetic_corpus
    from nanodiloco_tpu_torch.data.tokenizer import get_tokenizer
    from nanodiloco_tpu_torch.models.llama import causal_lm_loss, resolve_device, tree_map

    dev = resolve_device(device)
    cfg, sidecar, snapshot = _load_checkpoint_snapshot(checkpoint_dir, step)
    tok = get_tokenizer(sidecar.get("tokenizer"))
    texts = synthetic_corpus(n_docs=max(8, rows * 2), seed=holdout_seed)
    packed = pack_corpus(texts, tok, seq_length=min(
        seq, cfg.max_position_embeddings
    ))
    params = tree_map(lambda t: t.to(dev), snapshot)
    batch = torch.as_tensor(packed[:rows], dtype=torch.long, device=dev)
    with torch.no_grad():
        loss, _aux = causal_lm_loss(params, batch, cfg)
    return float(loss)


def canary_bench(url: str, checkpoint_dir: str, step: int | None, *,
                 clients: int = 2, requests_per_client: int = 2,
                 prompt_len: int = 12, max_new_tokens: int = 16,
                 seed: int = 0, timeout_s: float = 120.0,
                 eval_rows: int = 2, eval_seq: int = 64,
                 device: str = "cuda") -> dict:
    """The closed-loop canary measurement against ONE replica (see
    module docstring for the two-leg split). Returns the summary keys
    ``compare_runs`` gates (``ttft_p50_s``, ``client_tokens_per_sec``,
    ``canary_eval_loss``) plus the raw counts, and ``kernel_launches`` and
    ``kernel_shapes``: the CUDA kernels the loss leg launched in this
    process, and at which shapes (0 and empty on the CPU), which
    ``compare_runs`` does not read."""
    import random

    from nanodiloco_tpu_torch.obs.telemetry import nearest_rank_percentile
    from nanodiloco_tpu_torch.ops.cuda.flash_attention import launch_counts, shape_counts

    launches0, shapes0 = launch_counts(), shape_counts()
    loss = canary_eval_loss(checkpoint_dir, step,
                            rows=eval_rows, seq=eval_seq, device=device)
    launches = {k: v - launches0[k] for k, v in launch_counts().items()}
    shapes = {k: {key: n - shapes0[k].get(key, 0) for key, n in v.items()
                  if n > shapes0[k].get(key, 0)}
              for k, v in shape_counts().items()}
    rng = random.Random(seed)
    # greedy, prefix-cache-opted-out traffic: the canary must measure
    # the CHECKPOINT, not the cache it is about to invalidate anyway
    docs = [
        {
            "token_ids": [rng.randrange(2, 100) for _ in range(prompt_len)],
            "max_new_tokens": max_new_tokens, "temperature": 0.0,
            "seed": seed + c * 1000 + r, "stop": False,
            "prefix_cache": False,
        }
        for c in range(clients) for r in range(requests_per_client)
    ]
    results: list[dict] = []
    errors: list[dict] = []
    lock = threading.Lock()

    def client(cid: int) -> None:
        for i, doc in enumerate(docs):
            if i % clients != cid:
                continue
            try:
                code, out = http_post_json(
                    url + "/v1/generate", doc, timeout=timeout_s
                )
            except (OSError, ValueError) as e:
                # ValueError = non-JSON body; either way the canary
                # request FAILED and must count as an error (a dead
                # client thread would under-report the request count
                # with errors == 0 — the quiet way to pass the gate)
                code, out = -1, {"error": str(e)}
            with lock:
                (results if code == 200 else errors).append(out)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    ttft = sorted(r["timing"]["ttft_s"] for r in results)
    completion = sum(r["completion_tokens"] for r in results)
    return {
        "canary_step": step,
        "requests": len(results),
        "errors": len(errors),
        "wall_s": round(wall, 3),
        "canary_eval_loss": round(loss, 6) if math.isfinite(loss) else loss,
        "ttft_p50_s": (
            round(nearest_rank_percentile(ttft, 0.50), 4) if ttft else None
        ),
        "client_tokens_per_sec": (
            round(completion / wall, 1) if wall > 0 else None
        ),
        "kernel_launches": launches,
        "kernel_shapes": shapes,
    }


class DeployController:
    """Watch a training checkpoint dir; canary, promote, roll back.

    ``router`` is a ``fleet.FleetRouter`` (or anything with its
    ``push_weights``/``log_event``/``replica_names``/``state_of``
    surface — tests script one). ``bench`` is injectable:
    ``bench(url, checkpoint_dir, step) -> summary dict``; the default
    is ``canary_bench``. The canary replica is the FIRST configured
    replica unless named."""

    def __init__(
        self,
        router,
        checkpoint_dir: str,
        *,
        initial_step: int | None = None,
        canary: str | None = None,
        bench: Callable[[str, str, int | None], dict] | None = None,
        poll_interval_s: float = 2.0,
        sleep: Callable[[float], None] = time.sleep,
        max_loss_increase: float = 0.02,
        max_tps_drop: float = 0.2,
        max_latency_increase: float = 0.5,
        bench_kwargs: dict | None = None,
        slo_gate: Callable[[], bool] | None = None,
    ) -> None:
        self.router = router
        self.checkpoint_dir = checkpoint_dir
        self.deployed_step = initial_step
        names = router.replica_names()
        if canary is not None and canary not in names:
            raise ValueError(
                f"canary replica {canary!r} is not in the fleet {names}"
            )
        self.canary = canary or names[0]
        self._bench_kwargs = dict(bench_kwargs or {})
        self._bench = bench or (
            lambda url, ckpt, step: canary_bench(
                url, ckpt, step, **self._bench_kwargs
            )
        )
        self.poll_interval_s = float(poll_interval_s)
        self._sleep = sleep
        self._compare_kwargs = {
            "max_loss_increase": max_loss_increase,
            "max_tps_drop": max_tps_drop,
            "max_latency_increase": max_latency_increase,
        }
        self._baseline: dict | None = None
        # canary SLO gate: a callable answering "is a fleet-scope SLO
        # burning right now?" — default the router's own slo_burning()
        # (wired by obs-watch through POST /fleet/slo). While it
        # answers True, deploy() DEFERS: pushing new weights into a
        # live incident conflates two changes and makes the canary
        # verdict meaningless (the burn would fail a good checkpoint,
        # or mask a bad one). The step is NOT blacklisted — the next
        # poll retries it once the burn clears.
        self._slo_gate = slo_gate if slo_gate is not None else getattr(
            router, "slo_burning", None
        )
        self._deferred_step: int | None = None
        # rolled-back steps: never re-canaried — a broken checkpoint
        # must not trap the fleet in a canary->rollback loop
        self.failed_steps: set[int] = set()

    # -- the watch loop ------------------------------------------------------

    def run(self, stop: threading.Event | None = None,
            max_polls: int | None = None) -> None:
        """Poll until ``stop`` is set (or ``max_polls`` exhausted)."""
        polls = 0
        while stop is None or not stop.is_set():
            self.poll_once()
            polls += 1
            if max_polls is not None and polls >= max_polls:
                return
            if stop is not None:
                stop.wait(self.poll_interval_s)
            else:
                self._sleep(self.poll_interval_s)

    def poll_once(self) -> str | None:
        """One watch step: deploy the newest unseen checkpoint, if any.
        Returns the action taken ("promote"/"rollback"/"canary_failed"/
        "canary_deferred") or None when there was nothing new."""
        try:
            step = latest_checkpoint_step(self.checkpoint_dir)
        except Exception:
            return None  # a mid-write race must not kill the watcher
        if step is None or step == self.deployed_step:
            return None
        if step in self.failed_steps:
            return None
        if self.deployed_step is not None and step < self.deployed_step:
            return None  # never deploy backwards off a stale listing
        return self.deploy(step)

    # -- one deployment ------------------------------------------------------

    def _canary_url(self) -> str:
        return self.router.url_of(self.canary)

    def deploy(self, step: int) -> str:
        """Canary ``step``: establish the baseline (once, by benching
        the CURRENTLY deployed weights on the same canary with the same
        harness), push the candidate to the canary, measure, and
        promote fleet-wide or roll back on the verdict."""
        router = self.router
        if self._slo_gate is not None and self._slo_gate():
            # deferred, not failed: logged ONCE per step (the watch
            # loop re-polls every interval — a long burn must not spam
            # the deploy timeline), retried when the burn clears
            if self._deferred_step != step:
                self._deferred_step = step
                router.log_event("canary_deferred", step=step,
                                 replica=self.canary,
                                 reason="fleet SLO burning")
            return "canary_deferred"
        self._deferred_step = None
        router.log_event("canary_start", step=step, replica=self.canary,
                         baseline_step=self.deployed_step)
        url = self._canary_url()
        if self._baseline is None and self.deployed_step is not None:
            try:
                self._baseline = self._bench(
                    url, self.checkpoint_dir, self.deployed_step
                )
                router.log_event("canary_baseline",
                                 step=self.deployed_step,
                                 record=self._baseline)
            except Exception as e:
                # a missing/unloadable BASELINE is not the candidate's
                # fault (the deployed step's checkpoint may have been
                # GC'd by the trainer's max_to_keep retention):
                # blacklisting the candidate here would stall
                # deployment forever on an error no future checkpoint
                # can clear. Proceed baseline-less — first-deployment
                # semantics: the candidate still fails on request
                # errors or a non-finite eval loss.
                router.log_event("canary_baseline_failed",
                                 step=self.deployed_step,
                                 error=f"{type(e).__name__}: {e}")
        res = router.push_weights(self.checkpoint_dir, step,
                                  replicas=[self.canary])
        if not res or not res[0].get("ok"):
            # NOT blacklisted: a failed PUSH is an infrastructure blip
            # (timeout, replica restarting), not a judgment on the
            # checkpoint — the next poll retries it. The blacklist is
            # reserved for VERDICT failures (a checkpoint that measured
            # bad stays bad).
            router.log_event("canary_failed", step=step,
                             error=(res[0].get("error")
                                    if res else "no canary replica"))
            return "canary_failed"
        try:
            candidate = self._bench(url, self.checkpoint_dir, step)
        except Exception as e:
            candidate = {"errors": 1, "bench_error": str(e)}
        verdict = self.verdict(self._baseline, candidate)
        router.log_event("canary_verdict", step=step, ok=verdict["ok"],
                         regressions=verdict["regressions"],
                         record=candidate)
        if verdict["ok"]:
            others = [
                n for n in router.replica_names()
                if n != self.canary
                and router.state_of(n)["status"] == "serving"
            ]
            failed: list[str] = []
            if others:
                res = router.push_weights(self.checkpoint_dir, step,
                                          replicas=others)
                # a replica whose push failed is LEFT ON THE OLD
                # weights — the promote event must say so, not imply a
                # uniformly updated fleet (the router already logged
                # the per-replica swap_failed detail)
                failed = [r["replica"] for r in res if not r.get("ok")]
            router.log_event(
                "promote", step=step,
                replicas=[self.canary]
                + [n for n in others if n not in failed],
                prior_step=self.deployed_step,
                **({"failed_replicas": failed} if failed else {}),
            )
            self.deployed_step = step
            self._baseline = candidate
            return "promote"
        # ROLLBACK: re-swap the canary to the prior snapshot — the rest
        # of the fleet never saw the regressing weights
        self.failed_steps.add(step)
        restored = self.deployed_step
        rolled = False
        if restored is not None:
            res = router.push_weights(self.checkpoint_dir, restored,
                                      replicas=[self.canary])
            rolled = bool(res) and all(r.get("ok") for r in res)
        if not rolled:
            # the timeline must never CLAIM a rollback that did not
            # happen: the canary is still serving the regressing
            # weights — either the restore push failed (prior
            # checkpoint GC'd, replica died mid-push) or this was a
            # first-ever deployment with NO prior snapshot to restore.
            # Loudest event we have; the operator acts on it.
            router.log_event(
                "rollback_failed", step=step, restored_step=restored,
                regressions=verdict["regressions"],
                **({} if restored is not None
                   else {"error": "no prior deployed step to restore"}),
            )
            return "rollback_failed"
        router.log_event("rollback", step=step, restored_step=restored,
                         regressions=verdict["regressions"])
        return "rollback"

    def verdict(self, baseline: dict | None, candidate: dict) -> dict:
        """The promotion gate (see module docstring for the rule
        order). With no baseline yet (a first-ever deployment), the
        candidate passes unless it errored or its eval loss is
        non-finite — there is nothing to regress against."""
        regressions: list[str] = []
        if candidate.get("errors"):
            regressions.append("canary_request_errors")
        loss = candidate.get("canary_eval_loss")
        if isinstance(loss, float) and not math.isfinite(loss):
            # NaN compares false against every threshold: without this
            # explicit rule a NaN checkpoint would pass the gate
            regressions.append("canary_eval_loss_nonfinite")
        if baseline is not None and not regressions:
            from nanodiloco_tpu_torch.training.metrics import compare_runs

            diff = compare_runs(baseline, candidate,
                                **self._compare_kwargs)
            regressions.extend(diff["regressions"])
        return {"ok": not regressions, "regressions": regressions}
