"""The port's causal tracing (nanodiloco_tpu_torch/obs/tracer.py) against
the JAX package's: spans under an activated context carry the same
causal links; ``merge_chrome_traces``, ``stitch_trace``,
``critical_path`` and ``render_waterfall`` give the JAX outputs on the
same shard documents (shards written by either package's tracer); and
the port's ``report merge-trace`` / ``report trace`` print what the JAX
CLI prints for the same files.

The shards model one disaggregated request (router → prefill tier →
decode tier), every cross-process edge crossing a real ``to_wire()`` /
``from_wire()`` hop, on injected clocks: host logic only, no model.
"""

import json

import pytest

import nanodiloco_tpu.obs.tracer as jax_tracer
import nanodiloco_tpu_torch.obs.tracer as torch_tracer
from nanodiloco_tpu.cli import report_main as jax_report_main
from nanodiloco_tpu_torch.__main__ import report_main as torch_report_main

TRACERS = {"jax": jax_tracer, "torch": torch_tracer}
RID = "req-42"


class FakeClock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def disagg_shards(mod, fallback=False):
    """Router, prefill and decode shards of one request, written by
    ``mod``'s tracer; the decode shard's wall anchor is 5 ms late, so
    the merge's clock alignment is part of what is compared."""
    rtr = mod.SpanTracer(clock=FakeClock(), process_name="router")
    route = rtr.new_trace()
    pf_ctx, exp_ctx, imp_ctx = route.child(), route.child(), route.child()
    if fallback:
        rtr.record_span("handoff_prefill", 0.01, 0.10, ctx=pf_ctx, request_id=RID,
                        outcome="error")
        fb_ctx = route.child()
        rtr.record_span("fallback", 0.12, 0.95, ctx=fb_ctx, request_id=RID, outcome="ok")
        rtr.record_span("route", 0.0, 1.0, ctx=route, request_id=RID, outcome="fallback")
    else:
        rtr.record_span("handoff_prefill", 0.01, 0.40, ctx=pf_ctx, request_id=RID,
                        outcome="ok")
        rtr.record_span("handoff_export", 0.40, 0.50, ctx=exp_ctx, request_id=RID,
                        outcome="ok")
        rtr.record_span("handoff_import", 0.52, 0.97, ctx=imp_ctx, request_id=RID,
                        outcome="ok")
        rtr.record_span("route", 0.0, 1.0, ctx=route, request_id=RID, outcome="ok")
    rdoc = rtr.to_chrome()
    rdoc["otherData"]["wall_start_unix"] = 100.0
    ptr = mod.SpanTracer(clock=FakeClock(), process_name="prefill", process_index=1)
    if not fallback:
        base = mod.TraceContext.from_wire(pf_ctx.to_wire())
        ptr.record_span("queued", 0.02, 0.05, ctx=base.child(), request_id=RID)
        ptr.record_span("prefill", 0.05, 0.38, ctx=base.child(), request_id=RID)
        ebase = mod.TraceContext.from_wire(exp_ctx.to_wire())
        ptr.record_span("kv_export", 0.42, 0.48, ctx=ebase.child(), request_id=RID,
                        outcome="ok")
    pdoc = ptr.to_chrome()
    pdoc["otherData"]["wall_start_unix"] = 100.0
    dtr = mod.SpanTracer(clock=FakeClock(), process_name="decode", process_index=2)
    ibase = mod.TraceContext.from_wire((fb_ctx if fallback else imp_ctx).to_wire())
    if not fallback:
        dtr.record_span("kv_import", 0.545, 0.595, ctx=ibase.child(), request_id=RID,
                        outcome="ok")
    dtr.record_span("decode", 0.595 if not fallback else 0.195, 0.945, ctx=ibase.child(),
                    request_id=RID)
    ddoc = dtr.to_chrome()
    ddoc["otherData"]["wall_start_unix"] = 100.005
    return route.trace_id, [rdoc, pdoc, ddoc]


def old_shard():
    """A shard with no causal ids: joins by request id alone."""
    return {"traceEvents": [
        {"name": "process_name", "ph": "M", "pid": 0, "args": {"name": "old"}},
        {"name": "decode", "ph": "X", "pid": 0, "tid": 1, "ts": 1.2e6, "dur": 3e5,
         "args": {"request_id": RID}}],
        "otherData": {"wall_start_unix": 100.0}}


def strip_ids(tree):
    """A stitched tree without its random ids (their links are compared
    through the tree's shape)."""
    if isinstance(tree, dict):
        return {k: strip_ids(v) for k, v in tree.items()
                if k not in ("trace_id", "span_id", "parent_span_id")}
    if isinstance(tree, list):
        return [strip_ids(v) for v in tree]
    return tree


@pytest.mark.parametrize("maker", ["jax", "torch"])
@pytest.mark.parametrize("variant", ["handoff", "fallback", "old-shard"])
def test_stitch_and_critical_path_match_jax(maker, variant):
    tid, docs = disagg_shards(TRACERS[maker], fallback=variant == "fallback")
    if variant == "old-shard":
        docs = docs + [old_shard()]
    for needle in (RID, tid):
        out = {}
        for name, mod in TRACERS.items():
            st = mod.stitch_trace(docs, needle)
            out[name] = (st, mod.critical_path(st["root"]), mod.render_waterfall(st, width=40))
        assert out["torch"] == out["jax"]
    st, segs, _ = out["torch"]
    # the segments partition the root span: they sum to its duration
    root = st["root"]
    assert sum(s["seconds"] for s in segs) == pytest.approx(root["end_s"] - root["start_s"])
    assert st["request_id_joined"] == (1 if variant == "old-shard" else 0)


@pytest.mark.parametrize("maker", ["jax", "torch"])
def test_merge_chrome_traces_matches_jax(maker):
    _, docs = disagg_shards(TRACERS[maker])
    docs.append(dict(docs[1]))  # a pid collision falls back to an ordinal
    docs.append({"traceEvents": [{"name": "x", "ph": "X", "ts": 5.0, "dur": 1.0}]})
    merged = {name: mod.merge_chrome_traces(docs) for name, mod in TRACERS.items()}
    merged["jax"]["otherData"]["tracer"] = merged["torch"]["otherData"]["tracer"]
    assert merged["torch"] == merged["jax"]
    assert sorted({e["pid"] for e in merged["torch"]["traceEvents"]}) == [0, 1, 2, 3, 4]
    for mod in TRACERS.values():
        with pytest.raises(ValueError):
            mod.merge_chrome_traces([])
        with pytest.raises(ValueError):
            mod.stitch_trace(docs, "no-such-request")
        assert mod.trace_shard_path("t.json", 0) == "t.json"
        assert mod.trace_shard_path("t.json", 2) == "t.rank2.json"
        assert mod.trace_shard_path("t", 1) == "t.rank1.json"


def test_activated_context_links_match_jax():
    """Under an activated sampled context a depth-0 span parents under
    the remote span and a nested span under the enclosing one; an
    unsampled context adds no ids; ``active_context`` restores on exit."""
    shapes = {}
    for name, mod in TRACERS.items():
        clk = FakeClock()
        tr = mod.SpanTracer(clock=clk, process_index=3)
        ctx = mod.TraceContext("ab" * 16, "cd" * 8, None, True)
        with tr.activate(ctx):
            assert tr.active_context() == ctx
            with tr.span("outer", phase="x"):
                clk.advance(1.0)
                with tr.span("inner"):
                    clk.advance(0.5)
        assert tr.active_context() is None
        with tr.activate(mod.TraceContext("ab" * 16, "cd" * 8, None, False)):
            with tr.span("unsampled"):
                pass
        inner, outer, unsampled = tr.events
        assert outer["args"]["parent_span_id"] == ctx.span_id
        assert inner["args"]["parent_span_id"] == outer["args"]["span_id"]
        doc = tr.to_chrome()
        shapes[name] = (strip_ids(tr.events), doc["otherData"]["process_index"],
                        [e["args"] for e in doc["traceEvents"] if e["ph"] == "M"])
    assert shapes["torch"] == shapes["jax"]


def write_shards(tmp_path, docs):
    paths = []
    for i, doc in enumerate(docs):
        p = tmp_path / f"shard{i}.json"
        p.write_text(json.dumps(doc))
        paths.append(str(p))
    return paths


def test_report_trace_and_merge_trace_cli_match_jax(tmp_path, capsys):
    tid, docs = disagg_shards(torch_tracer)
    paths = write_shards(tmp_path, docs)
    printed = {}
    for name, main in (("jax", jax_report_main), ("torch", torch_report_main)):
        main(["trace", RID, *paths, "--width", "30"])
        main(["trace", tid, *paths, "--json"])
        main(["merge-trace", *paths, "-o", str(tmp_path / f"merged-{name}.json")])
        printed[name] = capsys.readouterr().out.replace(f"merged-{name}", "merged")
        with pytest.raises(SystemExit):
            main(["trace", "nope", *paths])
        capsys.readouterr()
    assert printed["torch"] == printed["jax"]
    assert "critical path (1000.0 ms total)" in printed["torch"]
    assert "(residual)" in printed["torch"]
    merged = json.loads((tmp_path / "merged-torch.json").read_text())
    assert sum(e["ph"] == "X" for e in merged["traceEvents"]) == 9
