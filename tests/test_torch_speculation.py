"""The port's speculative decoding (nanodiloco_tpu_torch/serve/
speculation.py, the verify programs of models/generate.py and the
engine's multi-token tick) on the CPU at a tiny size (2 layers, hidden
64, vocab 128).

- ``_accept_prefix`` and the dense verify program against the JAX
  package's on the same inputs (greedy: tokens and counts equal, logits
  and cache within TOL of their largest magnitude).
- ``_sample_slots_multi`` samples each (slot, position) row as the plain
  sampler samples that row alone with the same noise.
- The JAX package's tests/test_speculation.py against the port's solo
  ``generate()``: with speculation on (prompt lookup, an oracle that
  always guesses right, an adversary that always guesses wrong), every
  stream, greedy and sampled, dense, paged and int8-paged, is
  token-identical to the request run alone; the oracle compresses ticks,
  the adversary still emits one token per tick, rejected drafts leak no
  block, a stop token inside a draft window truncates, per-request
  opt-out, bounded verify widths, ``warm_spec`` and the stats.
- Greedy speculative streams against the JAX engine's, dense and paged.
- The copied proposer's own unit tests.

TOL = 1e-5: float32 on both sides, summation order only.
"""

import importlib

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
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy
from nanodiloco_tpu_torch.obs.telemetry import parse_metrics_text
from nanodiloco_tpu_torch.serve import GenRequest, InferenceEngine, Scheduler, ServeServer
from nanodiloco_tpu_torch.serve.speculation import PromptLookupProposer

JG = importlib.import_module("nanodiloco_tpu.models.generate")
TG = importlib.import_module("nanodiloco_tpu_torch.models.generate")

SIZE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_hidden_layers=2, max_position_embeddings=64)
V = SIZE["vocab_size"]
TOL = 1e-5
KV_MODES = [
    pytest.param({}, id="dense"),
    pytest.param({"kv_block_size": 4}, id="paged"),
]


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


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3e} of max|want| > {tol}"


def engine(model, **kw):
    return InferenceEngine(model[3], model[2], device="cpu",
                           **{"num_slots": 2, "max_len": 32, **kw})


def reference(model, req: GenRequest):
    row = TG.generate(model[3], [list(req.prompt)], model[2], req.max_new_tokens,
                      temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                      seed=req.seed, stop_token=req.stop_token, device="cpu")[0].tolist()
    if req.stop_token is not None and req.stop_token in row:
        row = row[: row.index(req.stop_token) + 1]
    return row


def drain(sched, tickets, limit=80):
    for _ in range(limit):
        if sched.tick() == 0 and all(t.done() for t in tickets):
            return
    raise AssertionError("scheduler did not drain")


class OracleProposer:
    """Proposes each request's true continuation: every draft accepts."""

    def __init__(self, streams: dict[int, list[int]]) -> None:
        self.streams = streams
        self._emitted: dict[int, int] = {}

    def begin(self, slot, prompt_ids, first_token):
        self._emitted[slot] = 1

    def release(self, slot):
        self._emitted.pop(slot, None)

    def propose(self, slot, cap):
        e = self._emitted[slot]
        return self.streams[slot][e:e + cap]

    def observe(self, slot, emitted):
        self._emitted[slot] += len(emitted)

    def feedback(self, slot, proposed, accepted):
        pass


class JunkProposer:
    """Always proposes ``cap`` copies of one (almost always wrong) token."""

    def __init__(self, token: int) -> None:
        self.token = int(token)

    def begin(self, slot, prompt_ids, first_token):
        pass

    def release(self, slot):
        pass

    def propose(self, slot, cap):
        return [self.token] * cap

    def observe(self, slot, emitted):
        pass

    def feedback(self, slot, proposed, accepted):
        pass


# -- the programs against JAX's ------------------------------------------------


def test_accept_prefix_matches_jax():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 3, (64, 5)).astype(np.int32)
    sampled = rng.integers(0, 3, (64, 5)).astype(np.int32)
    sampled[:8, :-1] = tokens[:8, 1:]  # full acceptance rows
    dlen = rng.integers(0, 5, 64).astype(np.int32)
    want = np.asarray(JG._accept_prefix(jnp.asarray(tokens), jnp.asarray(sampled),
                                        jnp.asarray(dlen)))
    got = TG._accept_prefix(torch.as_tensor(tokens), torch.as_tensor(sampled), dlen)
    assert np.array_equal(got.numpy(), want)
    assert got.min() >= 1 and (got.numpy() <= dlen + 1).all()


def test_sample_slots_multi_samples_each_row_as_the_plain_sampler():
    """Position j of slot b with noise row b*T + j samples exactly what
    ``_sample_slots`` samples for that row alone, with each slot's
    settings (greedy, temperature, top-k, top-p mixed)."""
    rng = np.random.default_rng(1)
    b, t = 4, 3
    logits = torch.as_tensor(rng.normal(size=(b, t, V)).astype(np.float32) * 3)
    noise = TG.gumbel_noise(np.repeat([1, 2, 3, 4], t), np.zeros(b * t, np.int64),
                            np.tile(np.arange(t), b), V, "cpu")
    temp = np.array([0.0, 0.8, 1.0, 0.7], np.float32)
    topk = np.array([0, 0, 10, 0])
    topp = np.array([1.0, 1.0, 1.0, 0.9], np.float32)
    got = TG._sample_slots_multi(logits, noise, temp, topk, topp)
    for s in range(b):
        for j in range(t):
            one = TG._sample_slots(logits[s, j][None], noise[s * t + j][None], temp[s:s + 1],
                                   topk[s:s + 1], topp[s:s + 1])
            assert int(got[s, j]) == int(one[0])


def test_verify_slots_fn_matches_jax(model):
    """Two live slots and a dead one, a 4-wide window, greedy: sampled
    tokens, emission counts and the cache against JAX's verify program;
    the dead slot's rows are untouched and a window's tail past the row
    (slot 2 at 14 of 16) is dropped on both sides."""
    jc, jp, tc, tp = model
    s, b, t = 16, 3, 4
    rng = np.random.default_rng(3)
    base_k = rng.normal(size=(2, b, s, tc.kv_heads, tc.head_dim)).astype(np.float32)
    base_v = rng.normal(size=base_k.shape).astype(np.float32)
    tokens = rng.integers(0, V, (b, t)).astype(np.int32)
    pos = np.array([5, 0, 14], np.int32)
    dlen = np.array([3, 0, 2], np.int32)
    active = np.array([1, 0, 1], np.int32)
    kv = np.zeros((b, s), np.int32)
    kv[0, :9] = 1
    kv[2, :] = 1
    with jax.default_matmul_precision("highest"):
        jl, jcache = JG._verify_slots_block(
            jp, jc, jnp.asarray(tokens), {"k": jnp.asarray(base_k), "v": jnp.asarray(base_v)},
            jnp.asarray(pos), jnp.asarray(kv), jnp.asarray(active))
        jsampled, jcounts, _ = JG.verify_slots_fn(jc)(
            jp, {"k": jnp.asarray(base_k), "v": jnp.asarray(base_v)}, jnp.asarray(tokens),
            jnp.asarray(pos), jnp.asarray(dlen), jnp.asarray(kv), jnp.zeros((b, t, 2), jnp.uint32),
            jnp.zeros(b, jnp.float32), jnp.zeros(b, jnp.int32), jnp.ones(b, jnp.float32),
            jnp.asarray(active))
    sp = TG.serving_params(tp, tc)
    cache = {"k": torch.as_tensor(base_k.copy()), "v": torch.as_tensor(base_v.copy())}
    tl, _ = TG._verify_slots_block(sp, tc, torch.as_tensor(tokens).long(),
                                   {k: v.clone() for k, v in cache.items()}, pos,
                                   torch.as_tensor(kv), active)
    close(tl[active > 0], np.asarray(jl)[active > 0])
    sampled, counts, cache = TG.verify_slots_fn(tc)(
        sp, cache, torch.as_tensor(tokens).long(), pos, dlen, torch.as_tensor(kv), None,
        np.zeros(b, np.float32), np.zeros(b, np.int64), np.ones(b, np.float32), active)
    live = active > 0
    assert np.array_equal(sampled.numpy()[live], np.asarray(jsampled)[live])
    assert np.array_equal(counts.numpy()[live], np.asarray(jcounts)[live])
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])
    assert np.array_equal(cache["k"][:, 1].numpy(), base_k[:, 1])


# -- streams against solo generate() (tests/test_speculation.py) ----------------


SPEC_MODES = [
    pytest.param("off", id="spec-off"),
    pytest.param("lookup", id="spec-lookup"),
    pytest.param("junk", id="spec-adversarial"),
]


@pytest.mark.parametrize("kv", KV_MODES)
@pytest.mark.parametrize("spec", SPEC_MODES)
def test_streams_token_identical_to_solo_generate(model, kv, spec):
    """Overlapping greedy and sampled requests through an engine with
    speculation off, prompt lookup, or an adversary: each stream equals
    its solo run; speculation changes tick counts, never tokens."""
    eng = engine(model, **kv, **({} if spec == "off" else {"spec_k": 4}))
    if spec == "junk":
        eng.speculator = JunkProposer(V - 1)
    sched = Scheduler(eng)
    reqs = [
        GenRequest(prompt=(5, 9, 2, 11, 3, 5, 9, 2), max_new_tokens=10, seed=0),
        GenRequest(prompt=(7, 1, 4), max_new_tokens=8, temperature=0.8, top_k=20, seed=7),
        GenRequest(prompt=(1, 2, 3, 4, 1, 2, 3), max_new_tokens=6, temperature=0.7, top_p=0.9,
                   seed=3),
    ]
    tickets = [sched.submit(reqs[0])]
    sched.tick()
    tickets.append(sched.submit(reqs[1]))
    sched.tick()
    tickets.append(sched.submit(reqs[2]))
    drain(sched, tickets)
    for ticket, req in zip(tickets, reqs):
        assert ticket.result["finish_reason"] == "length"
        assert ticket.result["tokens"] == reference(model, req)
    if spec == "junk":
        assert eng.spec_stats()["rejected_tokens"] > 0
    if spec == "lookup":
        assert eng.spec_stats()["draft_tokens"] > 0


@pytest.mark.parametrize("kv", KV_MODES)
def test_oracle_full_acceptance_compresses_ticks(model, kv):
    """A proposer that always guesses right: a greedy 12-token stream
    takes <= 4 ticks instead of 11, equals its solo run, and the accept
    counters are exact."""
    req = GenRequest(prompt=(5, 9, 2, 11, 3), max_new_tokens=12, seed=0)
    ref = reference(model, req)
    eng = engine(model, num_slots=1, spec_k=4, **kv)
    eng.speculator = OracleProposer({0: ref})
    sched = Scheduler(eng)
    ticket = sched.submit(req)
    drain(sched, [ticket])
    assert ticket.result["tokens"] == ref
    ss = eng.spec_stats()
    assert ss["accepted_tokens"] == ss["draft_tokens"] > 0 and ss["rejected_tokens"] == 0
    assert ss["decode_ticks"] <= 4 and ss["tokens_per_tick_mean"] > 2.0


def test_all_reject_still_makes_progress_every_tick(model):
    eng = engine(model, num_slots=1, spec_k=4)
    eng.speculator = JunkProposer(V - 1)
    req = GenRequest(prompt=(5, 9, 2), max_new_tokens=8, seed=0)
    toks = [eng.prefill(0, req)]
    ticks = 0
    while len(toks) < req.max_new_tokens:
        out = eng.step()
        ticks += 1
        assert len(out[0]) >= 1
        toks.extend(out[0])
    assert toks == reference(model, req)
    assert ticks == req.max_new_tokens - 1


@pytest.mark.parametrize("temperature", [0.0, 0.9], ids=["greedy", "sampled"])
def test_int8_paged_spec_parity(model, temperature):
    """int8 paged with speculation: streams equal the int8 engine without
    speculation (the same rows are read, whatever the tick width), and
    greedy streams equal solo float generate()."""
    reqs = [GenRequest(prompt=tuple((7 * i + 3 * j) % 50 + 1 for j in range(n)) * 2,
                       max_new_tokens=6, temperature=temperature, seed=40 + i)
            for i, n in enumerate([3, 5, 8])]
    streams = {}
    for spec_k in (0, 4):
        eng = engine(model, chunk_size=4, kv_block_size=4, kv_dtype="int8", spec_k=spec_k)
        sched = Scheduler(eng)
        tickets = [sched.submit(r) for r in reqs]
        drain(sched, tickets)
        streams[spec_k] = [t.result["tokens"] for t in tickets]
    assert streams[4] == streams[0]
    if not temperature:
        assert streams[4] == [reference(model, r) for r in reqs]


def test_stop_token_inside_a_draft_window_truncates(model):
    free = TG.generate(model[3], [[5, 9, 2]], model[2], 10, device="cpu")[0].tolist()
    stop = free[4]
    req = GenRequest(prompt=(5, 9, 2), max_new_tokens=10, seed=0, stop_token=stop)
    eng = engine(model, num_slots=1, spec_k=4)
    eng.speculator = OracleProposer({0: free})
    sched = Scheduler(eng)
    ticket = sched.submit(req)
    drain(sched, [ticket])
    assert ticket.result["finish_reason"] == "stop"
    assert ticket.result["tokens"] == reference(model, req)
    assert ticket.result["tokens"][-1] == stop


def test_per_request_opt_out(model):
    eng = engine(model, spec_k=4)
    sched = Scheduler(eng)
    r_out = GenRequest(prompt=(5, 9, 2, 11, 3), max_new_tokens=8, seed=0, speculate=False)
    r_in = GenRequest(prompt=(7, 1, 4), max_new_tokens=8, seed=1)
    t1, t2 = sched.submit(r_out), sched.submit(r_in)
    sched.tick()
    live = {s for s in range(2) if eng._active[s]}
    assert len({s for s in live if eng._spec_ok[s]}) <= 1
    drain(sched, [t1, t2])
    assert t1.result["tokens"] == reference(model, r_out)
    assert t2.result["tokens"] == reference(model, r_in)


def test_rejected_drafts_leak_no_blocks(model):
    """Heavy rejection over a paged pool, with a mid-stream cancel:
    every block returns, every refcount is zero."""
    eng = engine(model, chunk_size=4, kv_block_size=4, spec_k=4)
    eng.speculator = JunkProposer(V - 1)
    sched = Scheduler(eng)
    tickets = [
        sched.submit(GenRequest(prompt=(5, 9, 2, 11, 3), max_new_tokens=8, seed=0)),
        sched.submit(GenRequest(prompt=(7, 1, 4), max_new_tokens=10, temperature=0.8, top_k=20,
                                seed=7)),
        sched.submit(GenRequest(prompt=(1, 2, 3), max_new_tokens=9, seed=3)),
    ]
    sched.tick()
    sched.tick()
    tickets[1].cancel()
    drain(sched, tickets)
    kv = eng.kv_stats()
    assert kv["blocks_free"] == kv["num_blocks"]
    assert all(eng.block_pool.refcount(b) == 0 for b in range(eng.block_pool.num_blocks))
    assert eng.spec_stats()["rejected_tokens"] > 0


def test_verify_widths_bounded_by_the_buckets(model):
    """Draft lengths 1..4 run the verify program at the bucketed widths
    T in {2, 3, 5} alone; decode stays at one shape."""
    eng = engine(model, max_len=64, chunk_size=8, spec_k=4)

    class Varying(JunkProposer):
        n = 0

        def propose(self, slot, cap):
            self.n += 1
            return [1] * max(1, min(cap, self.n % 4 + 1))

    eng.speculator = Varying(1)
    sched = Scheduler(eng)
    tickets = [sched.submit(GenRequest(prompt=tuple((i + j) % 60 for j in range(n)),
                                       max_new_tokens=8, seed=i))
               for i, n in enumerate([1, 3, 7, 8, 12, 17])]
    drain(sched, tickets, limit=200)
    counts = eng.compile_counts()
    assert 1 <= counts["verify:dense"] <= 3 and counts["decode:dense"] <= 1
    assert set(counts["buckets"]["verify"]) <= {2, 3, 5}


def test_warm_spec_runs_every_width_and_leaves_no_trace(model):
    eng = engine(model, chunk_size=4, kv_block_size=4, spec_k=4)
    assert eng.warm_spec() == 3  # widths {1, 2, 4}
    assert eng.compile_counts()["buckets"]["verify"] == [2, 3, 5]
    ss = eng.spec_stats()
    assert ss["draft_tokens"] == 0 and ss["spec_ticks"] == 0
    assert ss["hist_tokens_per_tick"]["count"] == 0
    kv = eng.kv_stats()
    assert kv["blocks_free"] == kv["num_blocks"] and not any(eng._active)
    assert engine(model).warm_spec() == 0


def test_spec_stats_reach_scheduler_and_metrics(model):
    eng = engine(model, num_slots=1, spec_k=4)
    eng.speculator = JunkProposer(V - 1)
    srv = ServeServer(Scheduler(eng), port=0, host="127.0.0.1")
    try:
        sched = srv._scheduler
        t1 = sched.submit(GenRequest(prompt=(5, 9, 2), max_new_tokens=6, seed=0))
        drain(sched, [t1])
        assert sched.stats()["spec"]["rejected_tokens"] > 0
        m = parse_metrics_text(srv.render_metrics())
        assert m["nanodiloco_spec_draft_tokens_total"] > 0
        assert m["nanodiloco_spec_rejected_total"] > 0
        assert "nanodiloco_spec_acceptance_rate" in m
        assert m["nanodiloco_spec_tokens_per_tick_count"] > 0
    finally:
        srv._httpd.server_close()  # never started: no serve_forever to stop
    eng0 = engine(model, num_slots=1)
    assert eng0.spec_stats() is None and "spec" not in Scheduler(eng0).stats()


@pytest.mark.parametrize("kv", KV_MODES)
def test_greedy_spec_streams_token_identical_to_the_jax_engine(model, kv):
    jc, jp, tc, tp = model
    streams = {}
    with jax.default_matmul_precision("highest"):
        for name, eng, sched_cls, req_cls in (
            ("jax", JaxEngine(jp, jc, num_slots=2, max_len=32, spec_k=3, **kv), JaxScheduler,
             JaxRequest),
            ("port", InferenceEngine(tp, tc, num_slots=2, max_len=32, spec_k=3, device="cpu",
                                     **kv), Scheduler, GenRequest),
        ):
            sched = sched_cls(eng)
            tickets = [sched.submit(req_cls(prompt=p, max_new_tokens=9, seed=i))
                       for i, p in enumerate([(5, 9, 2, 11, 3, 5, 9), (7, 1, 4, 7, 1)])]
            drain(sched, tickets)
            streams[name] = ([t.result["tokens"] for t in tickets],
                             eng.spec_stats()["accepted_tokens"])
    assert streams["port"] == streams["jax"]


# -- the copied proposer (no device) ---------------------------------------------


def _ramp_to_max(p, slot):
    for _ in range(p.max_k):
        p.feedback(slot, proposed=1, accepted=1)


def test_proposer_matches_longest_ngram_continuation():
    p = PromptLookupProposer(max_k=4, max_ngram=3)
    p.begin(0, [5, 9, 2, 7, 1, 5, 9], 2)
    assert p.propose(0, 4) == [7, 1]
    _ramp_to_max(p, 0)
    assert p.propose(0, 4) == [7, 1, 5, 9]
    assert p.propose(0, 2) == [7, 1]


def test_proposer_backs_off_to_shorter_ngrams_then_nothing():
    p = PromptLookupProposer(max_k=4, max_ngram=3)
    p.begin(0, [1, 2, 3, 4], 2)
    _ramp_to_max(p, 0)
    assert p.propose(0, 4) == [3, 4, 2, 3]
    p.begin(1, [1, 2, 3], 4)
    assert p.propose(1, 4) == []


def test_proposer_cycles_short_periodic_continuation():
    p = PromptLookupProposer(max_k=6, max_ngram=3)
    p.begin(0, [9, 9, 9, 7, 8, 7, 8, 7], 8)
    _ramp_to_max(p, 0)
    assert p.propose(0, 6) == [7, 8, 7, 8, 7, 8]


def test_proposer_ema_floor_suppresses_and_probe_recovers():
    p = PromptLookupProposer(max_k=4, max_ngram=2)
    p.begin(0, [7, 8, 7, 8, 7], 8)
    assert len(p.propose(0, 4)) == p.START_K
    for _ in range(4):
        p.feedback(0, proposed=4, accepted=0)
    assert p._ema[0] < p.ACCEPT_FLOOR
    probes = 0
    for _ in range(2 * p.PROBE_PERIOD):
        p.new_tick()
        d = p.propose(0, 4)
        assert len(d) <= 1
        probes += bool(d)
    assert probes == 2
    p.feedback(0, proposed=1, accepted=1)
    p.feedback(0, proposed=1, accepted=1)
    assert p._ema[0] >= p.ACCEPT_FLOOR
    p.new_tick()
    assert len(p.propose(0, 4)) == 3


def test_proposer_adaptive_k_feedback():
    p = PromptLookupProposer(max_k=8, max_ngram=2)
    p.begin(0, [1, 2, 1, 2, 1], 2)
    assert p.current_k(0) == p.START_K
    for _ in range(8):
        p.feedback(0, proposed=2, accepted=2)
    assert p.current_k(0) == 8
    p.feedback(0, proposed=8, accepted=0)
    assert p.current_k(0) == 4
    for n in (4, 2, 1):
        p.feedback(0, proposed=n, accepted=0)
    assert p.current_k(0) == 1
    p.feedback(0, proposed=1, accepted=1)
    assert p.current_k(0) == 2
    p.feedback(0, proposed=2, accepted=1)
    assert p.current_k(0) == 2
    p.release(0)
    assert p.current_k(0) == 0 and p.propose(0, 4) == []
