"""The port's paged KV arena and int8 KV (nanodiloco_tpu_torch/models/
generate.py's paged programs, serve/engine.py's paged mode) on the CPU at
a tiny size (2 layers, hidden 64, vocab 128, MHA and GQA), from one numpy
parameter tree.

- The storage pieces against the JAX package's: ``init_kv_pool`` and
  ``kv_bytes_per_token`` equal; ``_quantize_rows`` gives the same int8
  rows and float32 scales bit for bit (both divide in float32 and round
  half to even).
- The paged programs against JAX's on the same inputs:
  ``prefill_chunk_paged_fn`` (aligned, the bucket-overflow re-feed at an
  unaligned start, pad rows past the allocation) and the paged verify
  block (T = 1 and a window that crosses a block boundary, an inactive
  slot, rows past a slot's allocation), fp and int8. Logits and the fp
  arena agree within TOL of their largest magnitude; the int8 arena's
  rows are equal and its scales within TOL.
- The two out-of-range index cases XLA hides: a sentinel table entry is
  read clamped to the last block and never raises; a write through one
  is dropped.
- The paged engine against the JAX paged engine (greedy streams equal,
  fp and int8) and the cases of the JAX package's tests/test_kv_paging.py
  against the port's solo ``generate()``: copy-on-write prefix blocks,
  release on cancel and expiry, block-gated admission with rollback,
  reclaiming cache-only blocks, the int8 contract (greedy streams equal,
  first-token logits within 0.05 of the span, the JAX test's bound), the
  re-feed corner, the bounded program shapes and the block gauges.

Tolerance TOL = 1e-5: both sides compute in float32 (JAX at matmul
precision "highest") and differ only in summation order (~1e-7 relative
per sum of 64 terms; two layers compound it).
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
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy
from nanodiloco_tpu_torch.serve import BlocksExhausted, GenRequest, InferenceEngine, Scheduler

JG = importlib.import_module("nanodiloco_tpu.models.generate")
TG = importlib.import_module("nanodiloco_tpu_torch.models.generate")

SIZE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_hidden_layers=2, max_position_embeddings=64)
LAYOUTS = {"mha": None, "gqa": 2}
TOL = 1e-5
# the int8 contract's logit bound: 5% of the fp logits' span, as the JAX
# package's tests/test_kv_paging.py holds its own int8 arena
INT8_SPAN_TOL = 0.05


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


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3e} of max|want| > {tol}"


def engine(models, layout="mha", **kw):
    _, _, cfg, params = models[layout]
    return InferenceEngine(params, cfg, device="cpu",
                           **{"num_slots": 2, "max_len": 32, "chunk_size": 4,
                              "kv_block_size": 4, **kw})


def reference(models, req, layout="mha"):
    _, _, cfg, params = models[layout]
    return TG.generate(params, [list(req.prompt)], cfg, req.max_new_tokens,
                       temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                       seed=req.seed, device="cpu")[0].tolist()


def drain(sched, tickets, n=200):
    for _ in range(n):
        if sched.tick() == 0 and all(t.done() for t in tickets):
            return
    raise AssertionError("requests did not finish")


# -- storage -------------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_pool_and_bytes_per_token_match_jax(kv_dtype, dtype):
    jc = JaxConfig(**SIZE, num_key_value_heads=2, dtype=dtype)
    tc = LlamaConfig(**SIZE, num_key_value_heads=2, dtype=dtype)
    jpool = JG.init_kv_pool(jc, 6, 4, kv_dtype)
    tpool = TG.init_kv_pool(tc, 6, 4, kv_dtype, device="cpu")
    assert sorted(jpool) == sorted(tpool)
    for name in jpool:
        assert tuple(tpool[name].shape) == jpool[name].shape
        assert str(tpool[name].dtype).removeprefix("torch.") == str(jpool[name].dtype)
        assert not tpool[name].any()
    assert TG.kv_bytes_per_token(tc, kv_dtype) == JG.kv_bytes_per_token(jc, kv_dtype)


@pytest.mark.parametrize("shape", [(3, 5, 4, 8), (2, 2, 7, 2, 16)])
def test_quantize_rows_bits_equal_jax(shape):
    """int8 rows and float32 scales at equality, not a tolerance: rows of
    mixed magnitude, an all-zero row (the 1e-8 amax floor) and a row with
    exact halves (round half to even)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape) * rng.uniform(0.01, 10, size=shape[:-2] + (1, 1))
    x = x.astype(np.float32)
    x.reshape(-1, *shape[-2:])[0] = 0.0
    halves = np.arange(-8, 8, dtype=np.float32) + 0.5
    row = x.reshape(-1, shape[-2] * shape[-1])[1]
    row[:halves.size] = halves
    row[halves.size] = 127.0  # amax 127: scale 1, so the halves stay halves
    jq, js = JG._quantize_rows(jnp.asarray(x))
    tq, ts = TG._quantize_rows(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    jd = JG._dequantize_rows(jq, js, jnp.float32)
    assert np.array_equal(TG._dequantize_rows(tq, ts, torch.float32).numpy(), np.asarray(jd))


# -- the paged programs against JAX's -------------------------------------------

NB, BS = 12, 4


def random_pool(cfg: LlamaConfig, kv_dtype, seed: int) -> dict:
    """A numpy arena of NB blocks of BS rows with random contents."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_hidden_layers, NB, BS, cfg.kv_heads, cfg.head_dim)
    if kv_dtype == "int8":
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "ks": rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32),
                "vs": rng.uniform(0.001, 0.02, shape[:3]).astype(np.float32)}
    return {"k": rng.normal(size=shape).astype(np.float32),
            "v": rng.normal(size=shape).astype(np.float32)}


def pools_agree(tpool: dict, jpool: dict) -> None:
    for name, want in jpool.items():
        got = tpool[name].numpy()
        if got.dtype == np.int8:
            assert np.array_equal(got, np.asarray(want)), f"int8 rows {name} differ"
        else:
            close(got, want)


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("c, pos", [(4, 4), (8, 8), (2, 8), (4, 6)],
                         ids=["aligned", "pads_past_allocation", "short_chunk",
                              "refeed_unaligned"])
def test_prefill_chunk_paged_matches_jax(models, kv_dtype, c, pos):
    """One chunk through a slot whose table maps 3 blocks (12 rows) and
    ends in two sentinel entries: the chunk's logits and token, and the
    whole arena after the scatter, against JAX's program. Rows past the
    allocation (the 8-row chunk at 8) are dropped on both sides, and an
    unaligned start (the re-feed) rewrites the blocks it touches."""
    jc, jp, tc, tp = models["gqa"]
    table = np.array([4, 8, 2, NB, NB], np.int32)
    base = random_pool(tc, kv_dtype, seed=c + pos)
    chunk = np.random.default_rng(pos).integers(0, SIZE["vocab_size"], (1, c)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        jtok, jl, jpool = JG.prefill_chunk_paged_fn(jc, kv_dtype)(
            jp, {k: jnp.asarray(v) for k, v in base.items()}, jnp.asarray(table),
            jnp.asarray(chunk), jnp.ones((1, c), jnp.int32), jnp.int32(pos), jnp.int32(c - 1),
            jax.random.key_data(jax.random.key(0)), jnp.float32(0.0), jnp.int32(0),
            jnp.float32(1.0))
    sp = TG.serving_params(tp, tc)
    tpool = {k: torch.as_tensor(v.copy()) for k, v in base.items()}
    ttok, tl, tpool = TG.prefill_chunk_paged_fn(tc, kv_dtype)(
        sp, tpool, table, torch.as_tensor(chunk).long(), pos, c - 1, None, 0.0, 0, 1.0)
    assert int(ttok) == int(jtok)
    close(tl, jl)
    pools_agree(tpool, jpool)
    untouched = [b for b in range(NB) if b not in (4, 8, 2)]
    for name in base:
        assert np.array_equal(tpool[name].numpy()[:, untouched], base[name][:, untouched])


@pytest.mark.parametrize("kv_dtype", [None, "int8"], ids=["fp", "int8"])
@pytest.mark.parametrize("t", [1, 4], ids=["decode", "window_crosses_block"])
@pytest.mark.parametrize("layout", ["mha", "gqa"])
def test_verify_slots_paged_matches_jax(models, kv_dtype, t, layout):
    """Three slots: slot 0 live at 6 (a 4-wide window crosses from its
    second block into its third), slot 1 inactive, slot 2 live at 6 with
    two blocks (a 4-wide window runs past its allocation into sentinel
    entries). Logits of every position and the whole arena against
    JAX's paged verify block; the inactive slot's blocks are untouched."""
    jc, jp, tc, tp = models[layout]
    tables = np.array([[3, 7, 1, NB, NB], [0, 2, NB, NB, NB], [5, 9, NB, NB, NB]], np.int32)
    pos = np.array([6, 2, 6], np.int32)
    active = np.array([1, 0, 1], np.int32)
    tokens = np.random.default_rng(t).integers(0, SIZE["vocab_size"], (3, t)).astype(np.int32)
    base = random_pool(tc, kv_dtype, seed=10 + t)
    quant = kv_dtype == "int8"
    with jax.default_matmul_precision("highest"):
        jl, jpool = JG._verify_slots_paged_block(
            jp, jc, jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in base.items()},
            jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(active), quant)
    tpool = {k: torch.as_tensor(v.copy()) for k, v in base.items()}
    tl, tpool = TG._verify_slots_paged_block(TG.serving_params(tp, tc), tc,
                                             torch.as_tensor(tokens).long(), tpool, tables, pos,
                                             active, quant)
    close(tl[active > 0], np.asarray(jl)[active > 0])
    pools_agree(tpool, jpool)
    for name in base:  # slot 1's blocks
        assert np.array_equal(tpool[name].numpy()[:, [0, 2]], base[name][:, [0, 2]])


def test_out_of_range_reads_clamp_and_writes_drop(models):
    """A table of sentinels (NB, one past the arena) gathers the last
    block, as XLA's clamped gather does, instead of raising; a decode
    write whose address is a sentinel (an inactive slot, a row past the
    allocation) leaves the arena as it was. On the card either index
    would trip a device-side assert, so neither may reach an index."""
    _, _, tc, tp = models["gqa"]
    pool = {k: torch.as_tensor(v) for k, v in random_pool(tc, None, seed=0).items()}
    before = {k: v.clone() for k, v in pool.items()}
    read = TG._read_index(np.full((2, 3), NB), NB, "cpu")
    assert read.max().item() == NB - 1
    rows = TG._gather_rows(pool["k"][0], None, read, torch.float32)
    assert torch.equal(rows[1, 2], pool["k"][0, NB - 1])
    # slot 0 live at row 8 of a 2-block table: its row is past the
    # allocation; slot 1 is inactive
    tables = np.array([[1, 2, NB], [3, NB, NB]])
    TG._decode_slots_paged_block(TG.serving_params(tp, tc), tc, torch.tensor([5, 6]), pool,
                                 tables, np.array([8, 1]), np.array([1, 0]), False)
    for name in pool:
        assert torch.equal(pool[name], before[name])


def test_paged_streams_token_identical_to_the_jax_engine(models):
    """Greedy requests (chunk boundaries, a shared prefix) through the JAX
    paged engine and the port's, fp and int8: identical streams, and the
    two int8 arenas hold the same int8 rows at the end."""
    jc, jp, tc, tp = models["gqa"]
    prefix = (5, 9, 2, 11, 3, 8, 1, 7)
    prompts = [(5, 9, 2, 11, 3), prefix + (4, 6), prefix + (2, 10, 12),
               tuple((3 * j) % 50 + 1 for j in range(13))]
    kw = dict(num_slots=2, max_len=32, chunk_size=4, prefix_cache_tokens=64, kv_block_size=4)
    for kv_dtype in ("model", "int8"):
        streams = {}
        with jax.default_matmul_precision("highest"):
            for name, eng, req_cls in (
                ("jax", JaxEngine(jp, jc, kv_dtype=kv_dtype, **kw), JaxRequest),
                ("port", InferenceEngine(tp, tc, kv_dtype=kv_dtype, device="cpu", **kw),
                 GenRequest),
            ):
                out = []
                for i, p in enumerate(prompts):
                    req = req_cls(prompt=p, max_new_tokens=5, seed=i)
                    toks = [eng.prefill(0, req)]
                    for _ in range(req.max_new_tokens - 1):
                        toks += eng.step()[0]
                    eng.release(0)
                    out.append(toks)
                streams[name] = (out, eng)
        assert streams["port"][0] == streams["jax"][0], kv_dtype
        assert streams["port"][1].prefix_stats()["hits"] >= 1
        assert streams["port"][1].kv_stats() == streams["jax"][1].kv_stats()


# -- the engine against its solo generate() (tests/test_kv_paging.py) ---------


def test_cow_prefix_blocks_shared_not_copied(models):
    """A prefix hit maps the cached chunks' blocks into the new slot's
    table by refcount (only the suffix blocks are allocated), and a
    shared block outlives its slot while the cache holds it, then frees
    once evicted and released."""
    eng = engine(models, prefix_cache_tokens=8)
    sched = Scheduler(eng)
    prefix = (5, 9, 2, 11, 3, 8, 1, 7)  # exactly two chunks/blocks
    ta = sched.submit(GenRequest(prompt=prefix + (4, 6), max_new_tokens=2, seed=1))
    drain(sched, [ta])
    assert eng.block_pool.used_blocks == 2
    cached = [b for chunk in eng.prefix_cache._blocks.values() for b in chunk]
    assert len(cached) == 2 and all(eng.block_pool.refcount(b) == 1 for b in cached)
    free_before = eng.block_pool.free_blocks
    req = GenRequest(prompt=prefix + (2, 10), max_new_tokens=2, seed=2)
    assert eng.start_prefill(0, req) == 1
    assert eng.block_pool.free_blocks == free_before - 1
    assert all(eng.block_pool.refcount(b) == 2 for b in cached)
    toks = [eng.prefill_step(0)]
    toks += eng.step()[0]
    assert toks == reference(models, req)
    eng.release(0)
    assert all(eng.block_pool.refcount(b) == 1 for b in cached)
    assert eng.block_pool.free_blocks == free_before
    # capacity 8 tokens = 2 chunks: another prompt's insert evicts
    tc = sched.submit(GenRequest(prompt=tuple(range(90, 99)), max_new_tokens=2, seed=3))
    drain(sched, [tc])
    assert eng.kv_block_evictions >= 1
    assert eng.block_pool.used_blocks == 2
    stats = eng.kv_stats()
    assert stats["block_evictions"] == eng.kv_block_evictions and stats["blocks_used"] == 2


def test_release_on_cancel_mid_prefill_frees_blocks(models):
    eng = engine(models, num_slots=1)
    sched = Scheduler(eng)
    t = sched.submit(GenRequest(prompt=tuple(range(1, 14)), max_new_tokens=4, seed=0))
    sched.tick()  # admit + first chunk
    assert eng.block_pool.used_blocks > 0 and eng.blocks_held(0) == 5
    t.cancel()
    sched.tick()
    assert t.done() and t.result["finish_reason"] == "cancelled"
    assert eng.block_pool.free_blocks == eng.block_pool.num_blocks


def test_expiry_mid_prefill_frees_blocks(models):
    clock = {"t": 0.0}
    eng = engine(models, num_slots=1)
    sched = Scheduler(eng, clock=lambda: clock["t"])
    t = sched.submit(GenRequest(prompt=tuple(range(1, 14)), max_new_tokens=4, seed=0,
                                deadline_s=1.0))
    sched.tick()
    assert eng.block_pool.used_blocks > 0
    clock["t"] = 5.0
    sched.tick()
    assert t.done() and t.result["finish_reason"] == "deadline"
    assert eng.block_pool.used_blocks == 0


def test_admission_gates_on_blocks_and_rolls_back(models):
    """A pool that holds one live request: the second stays queued
    (nothing leaked by the failed attempts), is admitted when the first
    retires, and both streams equal their solo runs."""
    eng = engine(models, num_slots=3, kv_pool_blocks=8)
    sched = Scheduler(eng)
    reqs = [GenRequest(prompt=tuple(range(1, 21)), max_new_tokens=8, seed=1),
            GenRequest(prompt=tuple(range(2, 22)), max_new_tokens=8, temperature=0.8,
                       seed=2)]  # 28 tokens -> 7 of the 8 blocks each
    t1, t2 = (sched.submit(r) for r in reqs)
    free_floor = eng.block_pool.num_blocks
    for _ in range(60):
        sched.tick()
        free_floor = min(free_floor, eng.block_pool.free_blocks)
        if t1.done() and t2.done():
            break
    assert [t1.result["tokens"], t2.result["tokens"]] == [reference(models, r) for r in reqs]
    assert free_floor == 1
    s = sched.stats()
    assert s["admission_blocked_no_blocks"] > 0 and s["admission_blocked_no_slot"] == 0
    assert s["errors"] == 0 and s["served"] == 2
    assert eng.block_pool.free_blocks == eng.block_pool.num_blocks
    with pytest.raises(BlocksExhausted):
        eng.start_prefill(0, reqs[0])
        eng.start_prefill(1, reqs[1])


def test_admission_reclaims_cache_only_blocks_under_pressure(models):
    eng = engine(models, max_len=24, prefix_cache_tokens=16, kv_pool_blocks=4)
    sched = Scheduler(eng)
    t1 = sched.submit(GenRequest(prompt=(5, 9, 2, 11, 3, 8, 1, 7, 4), max_new_tokens=2,
                                 seed=1))
    drain(sched, [t1])
    assert eng.block_pool.used_blocks == 2
    req = GenRequest(prompt=tuple(range(90, 99)), max_new_tokens=2, seed=2)
    t2 = sched.submit(req)
    drain(sched, [t2])
    assert t2.result["tokens"] == reference(models, req)
    assert eng.kv_block_evictions >= 1 and eng.prefix_cache.stats()["evictions"] >= 1


def test_request_that_can_never_fit_is_rejected_loudly(models):
    eng = engine(models, kv_pool_blocks=4)
    with pytest.raises(ValueError, match="never"):
        eng.validate([1] * 18, 4)  # 22 tokens -> 6 blocks > 4 in all
    sched = Scheduler(eng)
    t = sched.submit(GenRequest(prompt=tuple(range(1, 19)), max_new_tokens=4, seed=0))
    sched.tick()
    assert t.done() and t.result["finish_reason"] == "error" and "never" in t.result["error"]
    assert eng.block_pool.free_blocks == eng.block_pool.num_blocks


@pytest.mark.parametrize("layout", ["mha", "gqa"])
def test_int8_kv_greedy_parity_and_logit_tolerance(models, layout):
    """Across chunk-boundary prompt lengths, greedy streams of the
    paged-fp and paged-int8 engines equal solo generate(), and int8's
    first-token logits lie within INT8_SPAN_TOL of the fp logits' span."""
    lens = [3, 4, 5, 8, 13]
    reqs = [GenRequest(prompt=tuple((7 * i + 3 * j) % 50 + 1 for j in range(n)),
                       max_new_tokens=4, seed=40 + i) for i, n in enumerate(lens)]
    logits, streams = {}, {}
    for kv_dtype in ("model", "int8"):
        eng = engine(models, layout, num_slots=1, kv_dtype=kv_dtype)
        eng.capture_prefill_logits = True
        logits[kv_dtype], streams[kv_dtype] = [], []
        for req in reqs:
            toks = [eng.prefill(0, req)]
            logits[kv_dtype].append(eng.last_prefill_logits.copy())
            for _ in range(req.max_new_tokens - 1):
                toks += eng.step()[0]
            streams[kv_dtype].append(toks)
            eng.release(0)
    refs = [reference(models, r, layout) for r in reqs]
    assert streams["model"] == refs and streams["int8"] == refs
    for lf, li in zip(logits["model"], logits["int8"]):
        span = float(lf.max() - lf.min())
        assert float(np.abs(lf - li).max()) <= INT8_SPAN_TOL * max(span, 1e-6)


def test_bucket_overflow_corner_never_rewrites_shared_blocks(models):
    """max_len 22, chunk 16: done=16, remaining=5 buckets to 8 and would
    poke past a 22-row view; the widened paged table keeps the right-pad
    path in range, the stream equals solo generate(), and an int8 engine's
    shared prefix blocks keep their bits through a second admission."""
    corner = dict(num_slots=1, max_len=22, chunk_size=16, kv_block_size=2)
    prompt = tuple((11 * j + 5) % 50 + 1 for j in range(21))
    req = GenRequest(prompt=prompt, max_new_tokens=1, seed=0)
    eng = engine(models, **corner)
    assert [eng.prefill(0, req)] == reference(models, req)
    eng8 = engine(models, prefix_cache_tokens=32, kv_dtype="int8", **corner)
    sched = Scheduler(eng8)
    drain(sched, [sched.submit(GenRequest(prompt=prompt, max_new_tokens=1, seed=1))])
    shared = sorted({b for chunk in eng8.prefix_cache._blocks.values() for b in chunk})
    assert shared
    before = eng8.pool["k"][:, shared].clone()
    drain(sched, [sched.submit(GenRequest(prompt=prompt, max_new_tokens=1, seed=2))])
    assert torch.equal(eng8.pool["k"][:, shared], before)
    assert eng8.prefix_cache.stats()["hits"] >= 1


def test_program_shapes_bounded_under_paging(models):
    """Twelve prompt lengths run the paged chunk program at the bucket
    lengths {1, 2, 4, 8} alone and the decode program at one shape; paged
    mode has no extract/insert programs (prefix blocks are shared by
    reference)."""
    eng = engine(models, max_len=64, chunk_size=8, prefix_cache_tokens=64, kv_block_size=8)
    sched = Scheduler(eng)
    lens = [1, 2, 3, 5, 7, 8, 9, 12, 15, 17, 23, 31]
    tickets = [sched.submit(GenRequest(prompt=tuple((i + j) % 60 for j in range(n)),
                                       max_new_tokens=2, seed=i)) for i, n in enumerate(lens)]
    drain(sched, tickets)
    counts = eng.compile_counts()
    assert counts["layout"] == "paged"
    assert 1 <= counts["prefill_chunk:paged"] <= 4 and counts["decode:paged"] == 1
    assert set(counts["buckets"]["prefill_chunk"]) <= {1, 2, 4, 8}
    assert not any(k.startswith(("extract", "insert")) for k in counts)
    assert eng.devtime_stats()["dispatches_by_program"]["decode:1:paged"] >= 1


def test_kv_stats_blocks_held_histogram_and_bytes(models):
    _, _, cfg, _ = models["mha"]
    eng = engine(models, kv_dtype="int8")
    sched = Scheduler(eng)
    t = sched.submit(GenRequest(prompt=(1, 2, 3, 4, 5), max_new_tokens=3, seed=0))
    drain(sched, [t])
    kv = eng.kv_stats()
    assert kv["hist_blocks_per_request"]["count"] == 1
    assert kv["hist_blocks_per_request"]["sum"] == 2.0  # 8 tokens -> 2 blocks of 4
    assert kv["blocks_free"] == kv["num_blocks"] == 2 * 8
    assert kv["kv_dtype"] == "int8" and eng.kv_layout == "paged-int8"
    assert kv["kv_bytes"] == eng.kv_bytes() == 16 * 4 * TG.kv_bytes_per_token(cfg, "int8")
    assert sched.stats()["kv_pool"]["blocks_free"] == kv["blocks_free"]


def test_block_size_clamps_to_a_power_of_two_within_the_chunk(models):
    eng = engine(models, chunk_size=8, kv_block_size=6)
    assert eng.kv_block_size == 4 and eng.max_blocks == 8 and eng.table_blocks == 10
    assert engine(models, chunk_size=4, kv_block_size=64).kv_block_size == 4
    with pytest.raises(ValueError, match="paged"):
        engine(models, kv_block_size=0, kv_dtype="int8")
