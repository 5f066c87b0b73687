"""The port's dense continuous-batching engine
(nanodiloco_tpu_torch/serve/engine.py) on the CPU at a tiny size (2
layers, hidden 64, vocab 128, MHA and GQA).

- Against the JAX engine: the same greedy requests through both engines
  (dense mode, overlapping admissions, chunked prefill, a prefix-cache
  hit) give identical token streams. Sampled streams cannot be compared
  across the two packages, whose noise differs (jax.random against the
  port's counter hash).
- Against the port's solo ``generate()``: the dense cases of the JAX
  package's tests/test_serve.py. Every stream, greedy and sampled, is
  token-identical to the request run alone with the same seed, through
  overlapping admissions, slot refill, stop tokens, chunk boundaries and
  prefix-cache hits. Both sides run float32 on the CPU, so identity is
  the bar, not a tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu.serve import GenRequest as JaxRequest
from nanodiloco_tpu.serve import InferenceEngine as JaxEngine
from nanodiloco_tpu.serve import Scheduler as JaxScheduler
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.generate import generate
from nanodiloco_tpu_torch.models.llama import params_from_numpy
from nanodiloco_tpu_torch.serve import GenRequest, InferenceEngine, Scheduler

SIZE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_hidden_layers=2, max_position_embeddings=64)
LAYOUTS = {"mha": None, "gqa": 2}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{"mha"|"gqa": (jax cfg, jax params, port cfg, port params)} from
    one numpy tree per layout."""
    out = {}
    for name, nkv in LAYOUTS.items():
        jc = JaxConfig(**SIZE, num_key_value_heads=nkv)
        jp = jax_init(jax.random.key(0), jc)
        out[name] = (jc, jp, LlamaConfig(**SIZE, num_key_value_heads=nkv),
                     params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def engine(models, layout="gqa", **kw):
    _, _, cfg, params = models[layout]
    return InferenceEngine(params, cfg, device="cpu", **{"num_slots": 2, "max_len": 32, **kw})


def drain(sched, tickets, ticks=300):
    for _ in range(ticks):
        if sched.tick() == 0 and all(t.done() for t in tickets):
            break
    assert all(t.done() for t in tickets)


def reference(models, req: GenRequest, layout="gqa"):
    """The request run ALONE through the port's one-shot generate()."""
    _, _, cfg, params = models[layout]
    row = generate(params, [list(req.prompt)], cfg, req.max_new_tokens,
                   temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                   seed=req.seed, stop_token=req.stop_token, device="cpu")[0].tolist()
    if req.stop_token is not None and req.stop_token in row:
        row = row[: row.index(req.stop_token) + 1]  # the engine stops AT the stop token
    return row


def greedy_requests(cls):
    prefix = (5, 9, 2, 11, 3, 8, 1, 7)
    return [
        cls(prompt=(5, 9, 2, 11, 3), max_new_tokens=8, seed=7),
        cls(prompt=(7, 1, 4), max_new_tokens=6, seed=3),
        cls(prompt=prefix + (4, 6), max_new_tokens=5, seed=1),
        cls(prompt=prefix + (2, 10, 12), max_new_tokens=5, seed=2),
        cls(prompt=tuple((3 * j) % 50 + 1 for j in range(13)), max_new_tokens=4, seed=4),
    ]


@pytest.mark.parametrize("layout", ["mha", "gqa"])
def test_greedy_streams_token_identical_to_the_jax_engine(models, layout):
    """Overlapping admissions through two slots, 4-token chunks and a
    prefix cache, on both engines."""
    jc, jp, tc, tp = models[layout]
    streams = {}
    with jax.default_matmul_precision("highest"):
        for name, eng, sched_cls, req_cls in (
            ("jax", JaxEngine(jp, jc, num_slots=2, max_len=32, chunk_size=4,
                              prefix_cache_tokens=64), JaxScheduler, JaxRequest),
            ("port", InferenceEngine(tp, tc, num_slots=2, max_len=32, chunk_size=4,
                                     prefix_cache_tokens=64, device="cpu"),
             Scheduler, GenRequest),
        ):
            sched = sched_cls(eng)
            reqs = greedy_requests(req_cls)
            tickets = [sched.submit(reqs[0])]
            sched.tick()
            tickets += [sched.submit(r) for r in reqs[1:]]
            drain(sched, tickets)
            streams[name] = [t.result["tokens"] for t in tickets]
            assert eng.prefix_stats()["hits"] >= 1
    assert streams["port"] == streams["jax"]


# -- the port's engine against its solo generate() --------------------------


@pytest.mark.parametrize("layout", ["mha", "gqa"])
def test_overlapping_requests_match_sequential_generate(models, layout):
    """Requests admitted mid-stream, decoded together and retired at
    different times, greedy and sampled, each equal to its solo run."""
    eng = engine(models, layout)
    sched = Scheduler(eng)
    reqs = [
        GenRequest(prompt=(5, 9, 2, 11, 3), max_new_tokens=8, temperature=0.8, top_k=20,
                   seed=7),
        GenRequest(prompt=(7, 1, 4), max_new_tokens=6, temperature=0.7, top_p=0.9, seed=3),
        GenRequest(prompt=(1, 2, 3, 4), max_new_tokens=5, seed=0),  # greedy
    ]
    tickets = [sched.submit(reqs[0])]
    sched.tick()
    sched.tick()
    tickets.append(sched.submit(reqs[1]))
    sched.tick()
    tickets.append(sched.submit(reqs[2]))
    drain(sched, tickets)
    for ticket, req in zip(tickets, reqs):
        assert ticket.result["finish_reason"] == "length"
        assert ticket.result["tokens"] == reference(models, req, layout)
    s = sched.stats()
    assert s["served"] == 3 and s["slots_busy"] == 0 and s["tp_degree"] == 1


def test_three_requests_two_slots_refill(models):
    """The third request decodes in a slot another just vacated (stale
    cache rows under it) and still matches its solo run."""
    sched = Scheduler(engine(models, max_len=24))
    reqs = [
        GenRequest(prompt=(5, 9), max_new_tokens=3, temperature=0.9, top_k=10, seed=11),
        GenRequest(prompt=(8, 8, 8, 8), max_new_tokens=7, temperature=0.6, seed=12),
        GenRequest(prompt=(3, 1, 4, 1, 5), max_new_tokens=4, temperature=0.8, top_p=0.8,
                   seed=13),
    ]
    tickets = [sched.submit(r) for r in reqs]
    drain(sched, tickets)
    for ticket, req in zip(tickets, reqs):
        assert ticket.result["tokens"] == reference(models, req)


def test_stop_token_retires_slot_and_matches_generate(models):
    _, _, cfg, params = models["gqa"]
    free = generate(params, [[5, 9, 2]], cfg, 8, device="cpu")[0].tolist()
    req = GenRequest(prompt=(5, 9, 2), max_new_tokens=8, seed=0, stop_token=free[2])
    sched = Scheduler(engine(models))
    ticket = sched.submit(req)
    drain(sched, [ticket], ticks=12)
    assert ticket.result["finish_reason"] == "stop"
    assert ticket.result["tokens"][-1] == free[2]
    assert ticket.result["tokens"] == reference(models, req)


def test_chunked_prefill_boundary_parity(models):
    """With chunk_size=4, prompts straddling every boundary case (< chunk,
    == chunk, chunk+1, several chunks, several+1, right-padded final
    buckets) admit overlapping; every stream equals its solo run."""
    sched = Scheduler(engine(models, chunk_size=4))
    lens = [3, 4, 5, 6, 7, 8, 13]
    reqs = [
        GenRequest(prompt=tuple((7 * i + 3 * j) % 50 + 1 for j in range(n)),
                   max_new_tokens=4, temperature=0.8, top_k=12, seed=40 + i)
        for i, n in enumerate(lens)
    ]
    tickets = [sched.submit(r) for r in reqs]
    drain(sched, tickets)
    for ticket, req in zip(tickets, reqs):
        assert ticket.result["finish_reason"] == "length"
        assert ticket.result["tokens"] == reference(models, req)
    assert sched.stats()["prefill_chunks_total"] == sum(-(-n // 4) for n in lens)


@pytest.mark.parametrize("prompt_len, max_len, final_pos", [(31, 32, 24), (29, 30, 21)],
                         ids=["bucket_ends_at_max_len", "refeed_past_max_len"])
def test_final_chunk_at_the_end_of_the_row(models, prompt_len, max_len, final_pos):
    """Chunk 8. A 31-token prompt in a 32-row slot: its final 7 tokens
    bucket to 8 from position 24, ending exactly at max_len. A 29-token
    prompt in a 30-row slot: its final 5 tokens would bucket to 8 from 24
    and run past the row, so the engine re-feeds the prompt's last 8
    tokens from 21 instead (the rows it rewrites hold those bits
    already). Both streams equal their solo runs."""
    eng = engine(models, max_len=max_len, chunk_size=8)
    calls = []
    chunk = eng._chunk

    def spy(params, cache, toks, slot, pos, *rest):
        calls.append((toks.shape[1], pos))
        return chunk(params, cache, toks, slot, pos, *rest)

    eng._chunk = spy
    sched = Scheduler(eng)
    req = GenRequest(prompt=tuple((5 * j) % 60 + 1 for j in range(prompt_len)),
                     max_new_tokens=max_len - prompt_len, temperature=0.9, seed=5)
    ticket = sched.submit(req)
    drain(sched, [ticket])
    assert calls[-1] == (8, final_pos)
    assert ticket.result["tokens"] == reference(models, req)


def test_prefix_cache_hit_parity_and_counters(models):
    """B and D reuse A's cached chunk-aligned prefix, C opts out; all four
    streams equal their solo runs, and the counters show the reuse (D's
    whole prompt IS the prefix, so its hit stops one chunk short)."""
    eng = engine(models, chunk_size=4, prefix_cache_tokens=64)
    sched = Scheduler(eng)
    prefix = (5, 9, 2, 11, 3, 8, 1, 7)
    reqs = [
        GenRequest(prompt=prefix + (4, 6), max_new_tokens=4, temperature=0.7, top_k=16, seed=3),
        GenRequest(prompt=prefix + (2, 10, 12), max_new_tokens=5, temperature=0.9, top_p=0.9,
                   seed=8),
        GenRequest(prompt=prefix + (1,), max_new_tokens=3, seed=5, prefix_cache=False),
        GenRequest(prompt=prefix, max_new_tokens=4, temperature=0.6, seed=21),
    ]
    ta = sched.submit(reqs[0])
    drain(sched, [ta])
    others = [sched.submit(r) for r in reqs[1:]]
    drain(sched, others)
    for ticket, req in zip([ta, *others], reqs):
        assert ticket.result["tokens"] == reference(models, req)
    ps = eng.prefix_stats()
    assert ps["hits"] == 2 and ps["misses"] == 1
    assert ps["hit_tokens"] == 8 + 4
    assert ps["insertions"] >= 2
    assert sched.stats()["prefix_cache"]["hits"] == 2


def test_program_shapes_bounded_across_mixed_lengths(models):
    """Twelve prompt lengths run the chunk program at the bucket lengths
    {1, 2, 4, 8} alone, and the decode program at one shape."""
    eng = engine(models, max_len=64, chunk_size=8, prefix_cache_tokens=64)
    sched = Scheduler(eng)
    lens = [1, 2, 3, 5, 7, 8, 9, 12, 15, 17, 23, 31]
    tickets = [sched.submit(GenRequest(prompt=tuple((i + j) % 60 for j in range(n)),
                                       max_new_tokens=2, seed=i))
               for i, n in enumerate(lens)]
    drain(sched, tickets)
    counts = eng.compile_counts()
    assert counts["layout"] == "dense"
    assert 1 <= counts["prefill_chunk:dense"] <= 4
    assert counts["decode:dense"] == 1
    assert counts["extract:dense"] in (0, 1) and counts["insert:dense"] in (0, 1)
    assert set(counts["buckets"]["prefill_chunk"]) <= {1, 2, 4, 8}
    assert counts["buckets"]["decode"] == [1]
    dev = eng.devtime_stats()
    assert dev["dispatches_by_program"]["decode:1:dense"] >= 1
    assert sched.stats()["devtime"] == dev


def test_engine_validates_impossible_requests(models):
    eng = engine(models, num_slots=1, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        eng.validate([1] * 10, 10)
    with pytest.raises(ValueError, match="at least one token"):
        eng.validate([], 4)
    with pytest.raises(ValueError, match="vocabulary"):
        eng.validate([SIZE["vocab_size"] + 5], 4)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.validate([1], 0)


# -- what is not ported ------------------------------------------------------


@pytest.mark.parametrize("kwargs, match", [
    ({"kv_block_size": 4}, "paged KV arena"),
    ({"kv_dtype": "int8"}, "int8"),
    ({"spec_k": 2}, "speculative"),
    ({"tp": 2}, "tensor-parallel"),
])
def test_unported_engine_options_raise(models, kwargs, match):
    with pytest.raises(NotImplementedError, match=f"{match}.*ROADMAP"):
        engine(models, **kwargs)


@pytest.mark.parametrize("call, args", [
    ("swap_weights", ({},)),
    ("export_kv", (0,)),
    ("import_kv", (0, None, None)),
])
def test_unported_engine_calls_raise(models, call, args):
    eng = engine(models)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(eng, call)(*args)


def test_moe_config_and_bad_options_are_refused(models):
    _, _, _, params = models["gqa"]
    moe = LlamaConfig(**SIZE, num_experts=4)
    with pytest.raises(NotImplementedError, match="MoE"):
        InferenceEngine(params, moe, device="cpu")
    for bad in ({"num_slots": 0}, {"max_len": 1}, {"chunk_size": 0}, {"spec_k": -1},
                {"tp": 0}, {"kv_dtype": "fp8"}):
        with pytest.raises(ValueError):
            engine(models, **bad)


def test_engine_runs_on_the_card_unless_asked_for_the_cpu(models, monkeypatch):
    _, _, cfg, params = models["gqa"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(params, cfg)
