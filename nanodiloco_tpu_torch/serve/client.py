"""Tiny stdlib client for the serving endpoints — the ONE place the
wire contract (JSON bodies, HTTPError-carries-the-response) is encoded,
shared by tests, ``scripts/serve_bench.py``, and ``chip_agenda.py``'s
serve phase so they cannot drift from each other. A copy of
``nanodiloco_tpu/serve/client.py``."""

from __future__ import annotations

import json
import urllib.error
import urllib.request


def http_get(url: str, timeout: float = 10.0) -> tuple[int, str]:
    """GET -> (status, body text). A 4xx/5xx IS the response (healthz
    503 is the most interesting thing a probe can read), never raised."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def http_post_json(url: str, doc: dict,
                   timeout: float = 600.0) -> tuple[int, dict]:
    """POST a JSON object -> (status, parsed JSON response)."""
    req = urllib.request.Request(
        url, data=json.dumps(doc).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())
