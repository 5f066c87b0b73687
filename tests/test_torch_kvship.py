"""The port's KV shipping (nanodiloco_tpu_torch/serve/kvship.py, the
engine's ``export_kv`` / ``import_kv`` and the /admin/kv endpoints) on
the CPU at a tiny size (2 layers, hidden 64, vocab 128).

- The JAX package's tests/test_kvship.py against the port's solo
  ``generate()``: a stream prefilled and parked on one engine, shipped
  through the real wire doc (``pack`` -> ``unpack``) and resumed on
  another is token-identical to the request run alone, across dense,
  paged, int8 and block sizes, with speculation on the importer; an int8
  ship is verbatim (the same stream as a monolithic int8 engine); cross
  dtype imports requantize or dequantize, and an fp wire into another fp
  dtype is refused; blocks are conserved through export, retire, cancel
  and a failed import; the 4xx matrix over a real socket.
- Across the two packages: a doc the JAX engine wrote resumes in the
  port, token-identical to solo generate(); bfloat16 wire docs travel
  both ways with ``ml_dtypes`` hidden from the port, carrying the
  arena's bits unchanged.

Float32 on both sides: streams are compared for identity.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu.serve import GenRequest as JaxRequest
from nanodiloco_tpu.serve import InferenceEngine as JaxEngine
from nanodiloco_tpu.serve import Scheduler as JaxScheduler
from nanodiloco_tpu.serve import kvship as jax_kvship
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.generate import generate
from nanodiloco_tpu_torch.models.llama import params_from_numpy
from nanodiloco_tpu_torch.obs.telemetry import parse_metrics_text
from nanodiloco_tpu_torch.serve import (
    GenRequest,
    InferenceEngine,
    Scheduler,
    ServeServer,
    http_get,
    http_post_json,
    kvship,
)

SIZE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_hidden_layers=2, max_position_embeddings=64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) from one numpy tree."""
    jc = JaxConfig(**SIZE)
    jp = jax_init(jax.random.key(0), jc)
    return jc, jp, LlamaConfig(**SIZE), params_from_numpy(jax.tree.map(np.asarray, jp),
                                                          device="cpu")


def reference(model, req):
    return generate(model[3], [list(req.prompt)], model[2], req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                    seed=req.seed, device="cpu")[0].tolist()


def engine(model, **kv):
    return InferenceEngine(model[3], model[2], num_slots=2, max_len=32, device="cpu", **kv)


def drain(sched, tickets, limit=60):
    for _ in range(limit):
        if sched.tick() == 0 and all(t.done() for t in tickets):
            return
    raise AssertionError("scheduler did not drain")


def park(model, req, rid, **kv):
    """Prefill-only admission: the ticket finishes at the first token and
    the slot parks for export."""
    eng = engine(model, **kv)
    sched = Scheduler(eng)
    ticket = sched.submit(dataclasses.replace(req, prefill_only=True, request_id=rid))
    for _ in range(20):
        sched.tick()
        if ticket.done():
            break
    assert ticket.result["finish_reason"] == "prefilled"
    return eng, sched, ticket


def wire_doc(raw, parked, req, rid, mod=kvship):
    return mod.pack(mod.ShippedKV(
        config=raw["config"], generation=raw["generation"], wire_dtype=raw["wire_dtype"],
        prompt_len=len(parked.request.prompt), pos=raw["pos"],
        step_idx=len(parked.tokens) - 1, emitted=list(parked.tokens), k=raw["k"], v=raw["v"],
        ks=raw.get("ks"), vs=raw.get("vs"),
        request={"token_ids": [int(t) for t in req.prompt],
                 "max_new_tokens": int(req.max_new_tokens), "seed": int(req.seed),
                 "request_id": rid, "stop": False}))


def ship(sched, rid, req):
    """Export the parked slot across the real wire format."""
    raw, parked = sched.export_parked(rid)
    return kvship.unpack(wire_doc(raw, parked, req, rid))


def resume(model, req, shipped, **kv):
    eng = engine(model, **kv)
    sched = Scheduler(eng)
    ticket = sched.admit_import(dataclasses.replace(req, prefill_only=False), shipped)
    drain(sched, (ticket,))
    return eng, sched, ticket


SAMPLED = GenRequest(prompt=(5, 9, 2, 11, 3), max_new_tokens=8, temperature=0.8, top_k=20,
                     seed=7)
GREEDY = GenRequest(prompt=(5, 9, 2, 11, 3), max_new_tokens=6, seed=0)


@pytest.mark.parametrize("src, dst", [
    pytest.param({}, {}, id="dense-to-dense"),
    pytest.param({}, {"kv_block_size": 4}, id="dense-to-paged"),
    pytest.param({"kv_block_size": 4}, {}, id="paged-to-dense"),
    pytest.param({"kv_block_size": 4}, {"kv_block_size": 8}, id="paged4-to-paged8"),
    pytest.param({"kv_block_size": 8}, {"kv_block_size": 2, "chunk_size": 2},
                 id="paged8-to-paged2"),
])
def test_roundtrip_parity_across_geometries(model, src, dst):
    _, sa, ta = park(model, SAMPLED, "ship-a", **src)
    shipped = ship(sa, "ship-a", SAMPLED)
    assert shipped.emitted == ta.result["tokens"] and shipped.wire_dtype == "float32"
    _, _, tb = resume(model, SAMPLED, shipped, **dst)
    assert tb.result["finish_reason"] == "length"
    assert tb.result["tokens"] == reference(model, SAMPLED)


def test_int8_roundtrip_bit_exact_vs_monolithic_int8(model):
    kv = {"kv_block_size": 4, "kv_dtype": "int8"}
    eng = engine(model, **kv)
    sm = Scheduler(eng)
    tm = sm.submit(SAMPLED)
    drain(sm, (tm,))
    _, sa, _ = park(model, SAMPLED, "ship-q", **kv)
    shipped = ship(sa, "ship-q", SAMPLED)
    assert shipped.wire_dtype == "int8" and shipped.ks is not None and shipped.vs is not None
    _, _, tb = resume(model, SAMPLED, shipped, **kv)
    assert tb.result["tokens"] == tm.result["tokens"]


def test_roundtrip_parity_with_speculation(model):
    req = GenRequest(prompt=(5, 9, 2, 11, 3, 9, 2), max_new_tokens=8, temperature=0.8, top_k=20,
                     seed=7)
    _, sa, _ = park(model, req, "ship-sp", kv_block_size=4)
    shipped = ship(sa, "ship-sp", req)
    eng, _, tb = resume(model, req, shipped, kv_block_size=4, spec_k=2)
    assert tb.result["tokens"] == reference(model, req)


def test_cross_dtype_requantize_and_dequantize(model):
    """fp wire -> int8 arena requantizes, int8 wire -> fp arena
    dequantizes; both finish the stream (the greedy stream stays the solo
    one at this size). An fp wire into another fp dtype is refused."""
    ref = reference(model, GREEDY)
    _, sa, _ = park(model, GREEDY, "ship-f", kv_block_size=4)
    fp_wire = ship(sa, "ship-f", GREEDY)
    _, _, tb = resume(model, GREEDY, fp_wire, kv_block_size=4, kv_dtype="int8")
    assert tb.result["tokens"] == ref
    _, sq, _ = park(model, GREEDY, "ship-g", kv_block_size=4, kv_dtype="int8")
    _, _, td = resume(model, GREEDY, ship(sq, "ship-g", GREEDY))
    assert td.result["tokens"] == ref
    bad = dataclasses.replace(fp_wire, wire_dtype="float16", k=fp_wire.k.astype(np.float16),
                              v=fp_wire.v.astype(np.float16))
    with pytest.raises(kvship.ShipMismatchError, match="dtype"):
        engine(model, kv_block_size=4).import_kv(0, GREEDY, bad)


def test_refcount_conservation_export_and_retire(model):
    req = GenRequest(prompt=(5, 9, 2, 11, 3), max_new_tokens=8, seed=0)
    eng_a, sa, _ = park(model, req, "ship-rc", kv_block_size=4)
    free_a = eng_a.kv_stats()["blocks_free"]
    shipped = ship(sa, "ship-rc", req)
    assert eng_a.kv_stats()["blocks_free"] > free_a
    eng_b = engine(model, kv_block_size=4)
    sb = Scheduler(eng_b)
    base_b = eng_b.kv_stats()["blocks_free"]
    ticket = sb.admit_import(req, shipped)
    assert eng_b.kv_stats()["blocks_free"] == base_b - 4  # 13 tokens -> 4 blocks
    drain(sb, (ticket,))
    assert eng_b.kv_stats()["blocks_free"] == base_b
    c = eng_b.kvship_stats()
    assert c["import_requests"] == 1 and c["import_blocks"] == 2
    assert c["import_bytes"] == shipped.payload_bytes()
    assert eng_a.kvship_stats()["export_requests"] == 1
    assert engine(model).kvship_stats() is None


def test_import_cancel_frees_blocks_mid_stream(model):
    req = GenRequest(prompt=(5, 9, 2, 11, 3), max_new_tokens=16, seed=0)
    _, sa, _ = park(model, req, "ship-cx", kv_block_size=4)
    shipped = ship(sa, "ship-cx", req)
    eng = engine(model, kv_block_size=4)
    sched = Scheduler(eng)
    base = eng.kv_stats()["blocks_free"]
    ticket = sched.admit_import(req, shipped)
    sched.tick()
    assert not ticket.done()
    ticket.cancel()
    for _ in range(10):
        if sched.tick() == 0 and ticket.done():
            break
    assert ticket.result["finish_reason"] == "cancelled"
    assert eng.kv_stats()["blocks_free"] == base


def test_failed_import_scatter_leaks_nothing(model):
    _, sa, _ = park(model, GREEDY, "ship-fx", kv_block_size=4)
    shipped = ship(sa, "ship-fx", GREEDY)
    eng = engine(model, kv_block_size=4)
    base = eng.kv_stats()["blocks_free"]
    eng.pool["k"] = None  # the scatter fails after the allocation
    with pytest.raises(Exception):
        eng.import_kv(0, GREEDY, shipped)
    assert eng.kv_stats()["blocks_free"] == base and not eng._active[0]


def test_export_of_an_idle_slot_and_import_into_a_busy_one_refuse(model):
    eng, sa, _ = park(model, GREEDY, "ship-busy", kv_block_size=4)
    with pytest.raises(ValueError, match="no live stream"):
        eng.export_kv(1)
    raw, parked = sa.export_parked("ship-busy")
    shipped = kvship.unpack(wire_doc(raw, parked, GREEDY, "ship-busy"))
    eng.import_kv(0, GREEDY, shipped)
    with pytest.raises(ValueError, match="busy"):
        eng.import_kv(0, GREEDY, shipped)


def test_ship_4xx_matrix_over_real_socket(model):
    """A parked stream exports exactly once (then 404); a tampered config
    or weight generation is a 409; a truncated, broken or inconsistent
    payload is a 400; none of them touches the importer; the untouched
    payload then imports and finishes as solo generate()."""
    def server(role):
        return ServeServer(Scheduler(engine(model, kv_block_size=4)), port=0, host="127.0.0.1",
                           role=role, request_timeout_s=120.0).start()

    exporter, importer = server("prefill"), server("decode")

    def post(srv, path, doc):
        return http_post_json(f"http://127.0.0.1:{srv.port}{path}", doc, timeout=120.0)

    try:
        ref = reference(model, GREEDY)
        code, out = post(exporter, "/v1/generate", {
            "token_ids": list(GREEDY.prompt), "max_new_tokens": 6, "stop": False,
            "request_id": "wire-1", "prefill_only": True})
        assert code == 200 and out["finish_reason"] == "prefilled", out
        assert out["token_ids"] == ref[:1]
        assert post(exporter, "/admin/kv/export", {"request_id": "nope"})[0] == 404
        code, doc = post(exporter, "/admin/kv/export", {"request_id": "wire-1"})
        assert code == 200, doc
        assert post(exporter, "/admin/kv/export", {"request_id": "wire-1"})[0] == 404
        code, out = post(importer, "/admin/kv/import", {**doc, "config": "deadbeefdeadbeef"})
        assert code == 409 and "fingerprint" in out["error"], out
        code, out = post(importer, "/admin/kv/import", {**doc, "generation": 7})
        assert code == 409 and "generation" in out["error"], out
        cut = doc["k"][: (len(doc["k"]) // 8) * 4]
        code, out = post(importer, "/admin/kv/import", {**doc, "k": cut})
        assert code == 400 and "truncated" in out["error"], out
        assert post(importer, "/admin/kv/import", {**doc, "v": "!!not-base64!!"})[0] == 400
        code, out = post(importer, "/admin/kv/import", {**doc, "pos": doc["pos"] + 1})
        assert code == 400 and "cursor" in out["error"], out
        code, out = post(importer, "/admin/kv/import",
                         {k: v for k, v in doc.items() if k != "emitted"})
        assert code == 400, out
        body = http_get(f"http://127.0.0.1:{importer.port}/metrics", timeout=10)[1]
        assert "nanodiloco_kv_ship" not in body
        code, out = post(importer, "/admin/kv/import", doc)
        assert code == 200, out
        assert out["finish_reason"] == "length" and out["token_ids"] == ref
        assert out["request_id"] == "wire-1"
        em = parse_metrics_text(http_get(f"http://127.0.0.1:{exporter.port}/metrics",
                                         timeout=10)[1])
        im = parse_metrics_text(http_get(f"http://127.0.0.1:{importer.port}/metrics",
                                         timeout=10)[1])
        assert em['nanodiloco_kv_ship_requests_total{direction="export"}'] == 1
        assert em['nanodiloco_kv_ship_bytes_total{direction="export"}'] > 0
        assert em["nanodiloco_serve_slots_parked"] == 0
        assert im['nanodiloco_kv_ship_requests_total{direction="import"}'] == 1
        assert im['nanodiloco_kv_ship_blocks_total{direction="import"}'] > 0
        hz = json.loads(http_get(f"http://127.0.0.1:{exporter.port}/healthz", timeout=10)[1])
        assert hz["role"] == "prefill"
    finally:
        exporter.stop()
        importer.stop()


# -- across the two packages --------------------------------------------------


def jax_park_and_export(jc, jp, req, rid, **kv):
    eng = JaxEngine(jp, jc, num_slots=2, max_len=32, **kv)
    sched = JaxScheduler(eng)
    with jax.default_matmul_precision("highest"):
        ticket = sched.submit(dataclasses.replace(req, prefill_only=True, request_id=rid))
        for _ in range(20):
            sched.tick()
            if ticket.done():
                break
        raw, parked = sched.export_parked(rid)
    return eng, wire_doc(raw, parked, req, rid, mod=jax_kvship)


@pytest.mark.parametrize("kv", [{}, {"kv_block_size": 4}], ids=["dense", "paged"])
def test_a_jax_wire_doc_resumes_in_the_port(model, kv):
    """The JAX engine prefills, parks and exports a greedy stream; the
    port imports the JSON doc (a different package's bytes) and finishes
    the stream as the port's solo generate() does."""
    jc, jp, _, _ = model
    jreq = JaxRequest(prompt=GREEDY.prompt, max_new_tokens=GREEDY.max_new_tokens, seed=0)
    _, doc = jax_park_and_export(jc, jp, jreq, "x-1", **kv)
    shipped = kvship.unpack(json.loads(json.dumps(doc)))
    _, _, ticket = resume(model, GREEDY, shipped, kv_block_size=4)
    assert ticket.result["tokens"] == reference(model, GREEDY)


def test_bf16_wire_docs_travel_both_ways_without_ml_dtypes(model, monkeypatch):
    """bfloat16 has no numpy dtype; the port carries it as its 16-bit
    pattern under the tag "bfloat16". With ``ml_dtypes`` hidden from the
    port: a JAX bf16 doc unpacks and imports into a port bf16 engine whose
    cache rows then hold the JAX arena's bits; a port bf16 doc unpacks in
    the JAX package (which names bfloat16 through ml_dtypes) to the port
    arena's bits and imports into a JAX bf16 engine."""
    jc0, jp, _, _ = model
    jc = dataclasses.replace(jc0, dtype="bfloat16")
    tc = LlamaConfig(**SIZE, dtype="bfloat16")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    jreq = JaxRequest(prompt=GREEDY.prompt, max_new_tokens=GREEDY.max_new_tokens, seed=0)
    jeng, doc = jax_park_and_export(jc, jp, jreq, "bf-1", kv_block_size=4)
    assert doc["wire_dtype"] == "bfloat16"
    doc = json.loads(json.dumps(doc))
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)

    shipped = kvship.unpack(doc)
    assert shipped.k.dtype == np.int16
    port = InferenceEngine(tp, tc, num_slots=2, max_len=32, device="cpu")
    port.import_kv(0, GREEDY, shipped)
    pos = shipped.pos
    rows = port.cache["k"][:, 0, :pos]
    assert rows.dtype == torch.bfloat16
    assert np.array_equal(rows.view(torch.int16).numpy(), shipped.k)

    out = port.export_kv(0)
    assert out["wire_dtype"] == "bfloat16" and out["k"].dtype == np.int16
    assert np.array_equal(out["k"], shipped.k) and np.array_equal(out["v"], shipped.v)
    tdoc = kvship.pack(dataclasses.replace(shipped, k=out["k"], v=out["v"]))
    assert tdoc["k"] == doc["k"] and tdoc["v"] == doc["v"]  # the same wire bytes
    monkeypatch.undo()

    jshipped = jax_kvship.unpack(json.loads(json.dumps(tdoc)))
    assert str(jshipped.k.dtype) == "bfloat16"
    assert np.array_equal(jshipped.k.view(np.int16), out["k"])
    jdst = JaxEngine(jp, jc, num_slots=2, max_len=32)
    jdst.import_kv(1, jreq, jshipped)
    got = np.asarray(jdst.cache["k"][:, 1, :pos]).view(np.int16)
    assert np.array_equal(got, out["k"])
    assert int(jdst._tokens[1]) == int(port._tokens[0]) == shipped.emitted[-1]
