"""KV block shipping: the wire format for moving a live request's
paged (or dense) KV cache between serving replicas.

A copy of ``nanodiloco_tpu/serve/kvship.py`` (jax-free), with one
change: numpy has no bfloat16, and this package does not lean on
``ml_dtypes`` to name it, so a ``"bfloat16"`` wire array is held as its
16-bit pattern (``int16``) on the host. The bytes on the wire are the
same, so a doc either package writes imports into the other
(``to_tensor`` turns the pattern back into a ``torch.bfloat16`` tensor).

This is the mechanism behind disaggregated prefill/decode serving
(DistServe, arXiv:2401.09670; Splitwise, arXiv:2311.18677): a prefill
replica computes a prompt's KV rows and its first sampled token, then
ships the rows to a decode replica which resumes the stream mid-request
— exactly like a prefix-cache hit crossing a process boundary. The
format is deliberately LAYOUT-INVARIANT: rows travel as
``[layers, tokens, kv_heads, head_dim]`` regardless of the exporter's
block size, pool size, or tensor-parallel degree (the host block pool
is global under TP — a block id names the same physical block on every
shard — so a tp=4 exporter and a tp=1 importer exchange identical
bytes). The importer re-blocks into its OWN pool geometry.

Dtype rules (the parity contract):

- an int8 arena ships its stored int8 rows + per-row f32 scales
  verbatim; an int8 importer stores them verbatim — bit-exact, the
  same bits attention would have read locally;
- an fp arena ships raw fp bits; a same-dtype fp importer stores them
  verbatim — bit-exact, so a disaggregated stream is bit-identical to
  solo ``generate()``;
- cross-dtype imports requantize (fp wire -> int8 arena via the proven
  amax/127 scheme) or dequantize (int8 wire -> fp arena), trading
  bit-parity for compatibility the same way the int8 arena itself
  does; an fp wire into a DIFFERENT fp arena dtype is refused loudly
  (``ShipMismatchError``) — silently casting bf16 bits into an f32
  arena would be the quiet-garbage failure this module exists to
  prevent.

Every payload carries a FINGERPRINT — config hash + weight deploy
generation + wire dtype — validated before a single row lands: a
mismatched architecture or weight generation is a loud 4xx on the
import path (``ShipMismatchError`` -> 409), a truncated or malformed
payload a ``ShipFormatError`` (-> 400), never silent garbage in the
decode replica's cache.

Stdlib, numpy and torch's host tensors only; the engine owns the
device work (``InferenceEngine.export_kv`` / ``import_kv``).
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import hashlib
import json

import numpy as np
import torch

__all__ = [
    "SHIP_VERSION",
    "ShipFormatError",
    "ShipMismatchError",
    "ShippedKV",
    "config_fingerprint",
    "pack",
    "unpack",
    "quantize_rows",
    "dequantize_rows",
    "to_host",
    "to_tensor",
    "wire_tag",
]

SHIP_VERSION = 1


class ShipFormatError(ValueError):
    """Malformed payload: bad base64, truncated buffer, inconsistent
    cursor, missing field. The importing server answers 400 — the
    sender's bytes are broken, retrying them is pointless."""


class ShipMismatchError(ValueError):
    """Well-formed payload that does not fit THIS engine: wrong config
    fingerprint (different architecture), wrong weight generation, or
    an fp wire dtype the arena cannot hold bit-exactly. The importing
    server answers 409 — the payload is fine, the pairing is not."""


def config_fingerprint(cfg) -> str:
    """Stable 16-hex digest of the model config: the architecture half
    of the ship fingerprint. Two engines agree iff their configs are
    field-for-field identical — shipping KV across architectures would
    be silent garbage, and this makes it a loud 409 instead."""
    doc = json.dumps(
        dataclasses.asdict(cfg), sort_keys=True, default=str
    )
    return hashlib.sha256(doc.encode()).hexdigest()[:16]


def quantize_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-token-row symmetric int8 quantization — the HOST twin of the
    engine arena's ``_quantize_rows`` (models/generate.py): amax over
    the (kv_heads, head_dim) axes, ``scale = max(amax, 1e-8) / 127``.
    ``rows`` is ``[..., T, H, hd]``; returns (int8 rows, f32 scales
    ``[..., T]``)."""
    f = np.asarray(rows, np.float32)
    amax = np.max(np.abs(f), axis=(-2, -1))
    scale = (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)
    q = np.clip(np.rint(f / scale[..., None, None]), -127, 127)
    return q.astype(np.int8), scale


def dequantize_rows(q: np.ndarray, scale: np.ndarray,
                    dtype) -> np.ndarray:
    """Inverse of ``quantize_rows`` into ``dtype`` — the same math the
    paged-int8 attention read performs on device."""
    return (
        np.asarray(q, np.float32) * np.asarray(scale, np.float32)[..., None, None]
    ).astype(dtype)


@dataclasses.dataclass
class ShippedKV:
    """One request's shipped cache + resume cursor, decoded form.

    ``k``/``v`` are ``[layers, pos, kv_heads, head_dim]`` in
    ``wire_dtype`` (``ks``/``vs`` the ``[layers, pos]`` f32 scales,
    int8 wire only). ``emitted`` are the tokens the stream already
    produced (>= 1: the prefill's first sample rides along —
    ``pos == prompt_len + len(emitted) - 1`` because the newest token's
    own KV row is written by the tick that consumes it, not the one
    that sampled it). ``request`` is the originating generate-request
    spec, so an importer can rebuild the exact sampling state (the PRNG
    schedule is seed-derived — no key material travels)."""

    config: str
    generation: int
    wire_dtype: str
    prompt_len: int
    pos: int
    step_idx: int
    emitted: list[int]
    k: np.ndarray
    v: np.ndarray
    ks: np.ndarray | None
    vs: np.ndarray | None
    request: dict

    def payload_bytes(self) -> int:
        """Raw (pre-base64) KV payload size — the ship-bytes meter."""
        n = self.k.nbytes + self.v.nbytes
        if self.ks is not None:
            n += self.ks.nbytes
        if self.vs is not None:
            n += self.vs.nbytes
        return int(n)


# wire tags numpy cannot name, held on the host as their bit pattern
_BIT_PATTERNS = {"bfloat16": np.dtype(np.int16)}


def _np_dtype(name: str) -> np.dtype:
    """Wire dtype tag -> the numpy dtype its host array has (bfloat16:
    its 16-bit pattern)."""
    if name in _BIT_PATTERNS:
        return _BIT_PATTERNS[name]
    try:
        return np.dtype(name)
    except TypeError:
        raise ShipFormatError(f"unknown wire dtype {name!r}") from None


def wire_tag(dtype: torch.dtype) -> str:
    """The wire dtype tag of a torch dtype ("float32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


def to_host(t: torch.Tensor) -> np.ndarray:
    """Arena rows -> the host array the wire carries: a bfloat16 tensor as
    its 16-bit pattern. Always a copy: a view of a CPU arena would change
    when the exported slot is released (and zeroed)."""
    t = t.detach().to("cpu", copy=True)
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def to_tensor(arr: np.ndarray, wire_dtype: str) -> torch.Tensor:
    """A host wire array -> a CPU torch tensor of the dtype the tag
    names (the inverse of ``to_host``; float32 scales pass through)."""
    arr = np.ascontiguousarray(arr)
    if wire_dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()

def _unb64(field: str, data, dtype: np.dtype, shape: tuple) -> np.ndarray:
    if not isinstance(data, str):
        raise ShipFormatError(f"field {field!r} must be a base64 string")
    try:
        raw = base64.b64decode(data.encode(), validate=True)
    except (binascii.Error, ValueError) as e:
        raise ShipFormatError(f"field {field!r}: bad base64 ({e})") from None
    want = int(np.prod(shape)) * dtype.itemsize
    if len(raw) != want:
        raise ShipFormatError(
            f"field {field!r}: payload is {len(raw)} bytes but the "
            f"declared shape {tuple(shape)} x {dtype} needs {want} — "
            "truncated or corrupt ship"
        )
    return np.frombuffer(raw, dtype).reshape(shape).copy()


def _int(doc: dict, field: str, minimum: int = 0) -> int:
    v = doc.get(field)
    if not isinstance(v, int) or isinstance(v, bool) or v < minimum:
        raise ShipFormatError(
            f"field {field!r} must be an integer >= {minimum}; got {v!r}"
        )
    return v


def pack(shipped: ShippedKV) -> dict:
    """ShippedKV -> JSON-safe wire doc (arrays base64-encoded)."""
    doc = {
        "version": SHIP_VERSION,
        "config": shipped.config,
        "generation": int(shipped.generation),
        "wire_dtype": shipped.wire_dtype,
        "prompt_len": int(shipped.prompt_len),
        "pos": int(shipped.pos),
        "step_idx": int(shipped.step_idx),
        "emitted": [int(t) for t in shipped.emitted],
        "layers": int(shipped.k.shape[0]),
        "kv_heads": int(shipped.k.shape[2]),
        "head_dim": int(shipped.k.shape[3]),
        "k": _b64(shipped.k),
        "v": _b64(shipped.v),
        "request": dict(shipped.request),
    }
    if shipped.ks is not None:
        doc["ks"] = _b64(np.asarray(shipped.ks, np.float32))
        doc["vs"] = _b64(np.asarray(shipped.vs, np.float32))
    return doc


def unpack(doc: dict) -> ShippedKV:
    """Wire doc -> ShippedKV, validating EVERYTHING structural here so
    the engine's import sees only well-formed payloads: version, field
    types, base64 integrity, buffer-length-vs-shape agreement, and the
    cursor identities (``pos == prompt_len + len(emitted) - 1``,
    ``step_idx == len(emitted) - 1``). Fingerprint/generation checks
    are the ENGINE's (it knows its config) — format first, fit second."""
    if not isinstance(doc, dict):
        raise ShipFormatError("ship payload must be a JSON object")
    version = doc.get("version")
    if version != SHIP_VERSION:
        raise ShipFormatError(
            f"unsupported ship version {version!r} (this build speaks "
            f"{SHIP_VERSION})"
        )
    config = doc.get("config")
    if not isinstance(config, str) or not config:
        raise ShipFormatError("field 'config' must be a non-empty string")
    wire = doc.get("wire_dtype")
    if not isinstance(wire, str) or not wire:
        raise ShipFormatError("field 'wire_dtype' must be a non-empty string")
    dtype = _np_dtype(wire)
    generation = _int(doc, "generation")
    prompt_len = _int(doc, "prompt_len", minimum=1)
    pos = _int(doc, "pos", minimum=1)
    step_idx = _int(doc, "step_idx")
    layers = _int(doc, "layers", minimum=1)
    kv_heads = _int(doc, "kv_heads", minimum=1)
    head_dim = _int(doc, "head_dim", minimum=1)
    emitted = doc.get("emitted")
    if (not isinstance(emitted, list) or not emitted
            or not all(isinstance(t, int) and not isinstance(t, bool)
                       for t in emitted)):
        raise ShipFormatError(
            "field 'emitted' must be a non-empty list of ints (a "
            "shipped stream has sampled at least its first token)"
        )
    if pos != prompt_len + len(emitted) - 1:
        raise ShipFormatError(
            f"cursor mismatch: pos={pos} but prompt_len={prompt_len} + "
            f"{len(emitted)} emitted tokens implies "
            f"{prompt_len + len(emitted) - 1} written KV rows"
        )
    if step_idx != len(emitted) - 1:
        raise ShipFormatError(
            f"cursor mismatch: step_idx={step_idx} but {len(emitted)} "
            f"emitted tokens implies {len(emitted) - 1} decode steps"
        )
    request = doc.get("request")
    if not isinstance(request, dict):
        raise ShipFormatError("field 'request' must be a JSON object")
    shape = (layers, pos, kv_heads, head_dim)
    k = _unb64("k", doc.get("k"), dtype, shape)
    v = _unb64("v", doc.get("v"), dtype, shape)
    ks = vs = None
    if dtype == np.dtype(np.int8):
        ks = _unb64("ks", doc.get("ks"), np.dtype(np.float32),
                    (layers, pos))
        vs = _unb64("vs", doc.get("vs"), np.dtype(np.float32),
                    (layers, pos))
    elif "ks" in doc or "vs" in doc:
        raise ShipFormatError(
            "scale fields ('ks'/'vs') only belong on int8 wire payloads"
        )
    return ShippedKV(
        config=config, generation=generation, wire_dtype=wire,
        prompt_len=prompt_len, pos=pos, step_idx=step_idx,
        emitted=[int(t) for t in emitted], k=k, v=v, ks=ks, vs=vs,
        request=dict(request),
    )
