"""Jittered exponential backoff with a deadline — the transient-IO shield.

A copy of ``nanodiloco_tpu/resilience/retry.py`` (jax-free, but the JAX
package's ``__init__`` imports jax, so the port keeps its own).

Checkpoint writes and dataset reads on real deployments fail
transiently (GCS 503s, NFS hiccups, a preempted sidecar); the
difference between a blip and a dead run is whether the caller retries.
One implementation, used by the checkpoint manager (save/restore), so
backoff behavior can never differ by call site.

Policy: attempt, then sleep ``base * 2^attempt`` capped at ``max_delay``
with full jitter (a uniform draw in [delay/2, delay] — herd-safe without
being unbounded below), until either ``max_attempts`` attempts have
failed or the ``deadline_s`` wall-clock budget is exhausted. The final
failure raises ``RetryError`` carrying the last exception — callers that
degrade gracefully (alarm-and-continue) catch that one type.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 4        # total attempts (first try included)
    base_delay_s: float = 0.25   # first backoff; doubles per attempt
    max_delay_s: float = 8.0     # backoff cap
    deadline_s: float = 60.0     # total wall-clock budget across attempts


class RetryError(RuntimeError):
    """All attempts failed. ``last`` is the final exception; ``attempts``
    how many were made."""

    def __init__(self, op: str, attempts: int, last: BaseException) -> None:
        super().__init__(
            f"{op} failed after {attempts} attempt(s): "
            f"{type(last).__name__}: {last}"
        )
        self.op = op
        self.attempts = attempts
        self.last = last


def jittered_backoff(
    n: int, base_delay_s: float, max_delay_s: float, rng: random.Random
) -> float:
    """The one backoff formula: ``base * 2^n`` capped at ``max``, with a
    uniform draw in [delay/2, delay] (herd-safe without being unbounded
    below)."""
    d = min(base_delay_s * (2.0 ** max(0, n)), max_delay_s)
    return rng.uniform(d / 2.0, d)


def backoff_delays(policy: RetryPolicy, rng: random.Random) -> list[float]:
    """The jittered delay schedule (one entry per retry gap) — exposed
    so tests can pin the bounds without sleeping."""
    return [
        jittered_backoff(a, policy.base_delay_s, policy.max_delay_s, rng)
        for a in range(policy.max_attempts - 1)
    ]


def retry_call(
    fn: Callable[[], Any],
    op: str = "operation",
    policy: RetryPolicy | None = None,
    on_retry: Callable[[int, BaseException, float], None] | None = None,
    retry_on: tuple[type[BaseException], ...] = (Exception,),
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    rng: random.Random | None = None,
) -> Any:
    """Call ``fn`` under ``policy``; return its result or raise
    ``RetryError`` after the budget is spent.

    ``on_retry(attempt, exc, delay)`` fires before each backoff sleep —
    the caller's logging/telemetry hook. ``sleep``/``clock``/``rng`` are
    injectable so the backoff path is testable without wall-clock time.
    Exceptions outside ``retry_on`` propagate immediately (a programming
    error must not burn the deadline)."""
    policy = policy or RetryPolicy()
    rng = rng or random.Random()
    t0 = clock()
    last: BaseException | None = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn()
        except retry_on as e:
            last = e
        if attempt >= policy.max_attempts:
            break
        delay = jittered_backoff(
            attempt - 1, policy.base_delay_s, policy.max_delay_s, rng
        )
        if clock() - t0 + delay > policy.deadline_s:
            break
        if on_retry is not None:
            try:
                on_retry(attempt, last, delay)
            except Exception:
                pass  # a broken observer must not break the retry
        sleep(delay)
    raise RetryError(op, attempt, last)
