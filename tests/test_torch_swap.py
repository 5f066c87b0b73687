"""The port's hot weight swap (``InferenceEngine.swap_weights`` and
``POST /admin/swap``) on the CPU at a tiny size (2 layers, hidden 64,
vocab 128): the swap cases of the JAX package's tests/test_fleet.py
against the port's solo ``generate()``.

A stream in flight at the swap finishes token-identical to solo
generate() on the OLD weights and an admission after it on the NEW ones,
dense and paged, mid-decode and mid-prefill; the prefix cache is cleared
and never refilled from old-generation rows; a swap back restores the
first stream; a tree that does not fit is a ValueError with nothing
swapped; the old generation's serving copy is freed when its last slot
retires; and the server's /admin/swap answers over a real socket. Float32
on both sides: identity, not a tolerance.
"""

import gc
import weakref

import pytest
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.generate import generate
from nanodiloco_tpu_torch.models.llama import init_params, tree_map
from nanodiloco_tpu_torch.serve import (
    GenRequest,
    InferenceEngine,
    Scheduler,
    ServeServer,
    http_post_json,
)

CFG = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
                  num_hidden_layers=2, max_position_embeddings=64)
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
def params():
    return init_params(torch.Generator().manual_seed(0), CFG, device="cpu")


@pytest.fixture(scope="module")
def params2():
    return init_params(torch.Generator().manual_seed(1), CFG, device="cpu")


def reference(params, req):
    return generate(params, [list(req.prompt)], CFG, req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                    seed=req.seed, device="cpu")[0].tolist()


def engine(params, **kw):
    return InferenceEngine(params, CFG, device="cpu", **{"num_slots": 2, "max_len": 32, **kw})


def drain(sched, tickets, limit=60):
    for _ in range(limit):
        if sched.tick() == 0 and all(t.done() for t in tickets):
            return
    raise AssertionError("scheduler did not drain")


@pytest.mark.parametrize("kv", KV_MODES)
def test_swap_mid_decode_old_stream_old_weights_new_admission_new(params, params2, kv):
    eng = engine(params, **kv)
    sched = Scheduler(eng)
    old_req = GenRequest(prompt=(5, 9, 2, 11, 3), max_new_tokens=10, temperature=0.8, top_k=20,
                         seed=7)
    new_req = GenRequest(prompt=(7, 1, 4), max_new_tokens=6, temperature=0.7, top_p=0.9, seed=3)
    t_old = sched.submit(old_req)
    for _ in range(3):
        sched.tick()  # the old stream is mid-decode
    handle = sched.call_on_tick(lambda: eng.swap_weights(params2))
    t_new = sched.submit(new_req)
    drain(sched, (t_old, t_new))
    assert handle.done() and handle.error is None
    assert handle.result == 1 == eng.deploy_generation
    assert t_old.result["tokens"] == reference(params, old_req)
    assert t_new.result["tokens"] == reference(params2, new_req)
    assert set(eng._params_by_gen) == {1}  # released with its last stream
    assert eng.devtime_stats()["dispatches_by_program"][f"swap:0:{eng.kv_layout}"] == 1


@pytest.mark.parametrize("kv", KV_MODES)
def test_swap_mid_prefill_completes_on_admission_weights(params, params2, kv):
    eng = engine(params, chunk_size=4, **kv)
    sched = Scheduler(eng)
    req = GenRequest(prompt=tuple((7 * i + 3) % 50 + 1 for i in range(13)), max_new_tokens=4,
                     temperature=0.8, top_k=12, seed=40)
    ticket = sched.submit(req)
    sched.tick()  # admit + first chunk only
    handle = sched.call_on_tick(lambda: eng.swap_weights(params2))
    drain(sched, (ticket,))
    assert handle.error is None
    assert ticket.result["tokens"] == reference(params, req)


def test_swap_invalidates_prefix_cache(params, params2):
    eng = engine(params, chunk_size=4, prefix_cache_tokens=64, kv_block_size=4)
    sched = Scheduler(eng)
    prompt = tuple((3 * i + 1) % 50 + 1 for i in range(10))
    req = GenRequest(prompt=prompt, max_new_tokens=4, seed=0)
    drain(sched, (sched.submit(req),))
    assert eng.prefix_cache.match(list(prompt) + [9], record=False) != []
    used = eng.block_pool.used_blocks
    assert used == 2  # the cache's two chunks
    handle = sched.call_on_tick(lambda: eng.swap_weights(params2))
    t2 = sched.submit(req)
    drain(sched, (t2,))
    assert handle.error is None
    pc = eng.prefix_cache.stats()
    assert pc["generation"] == 1 and pc["invalidations"] >= 1 and pc["hit_tokens"] == 0
    assert t2.result["tokens"] == reference(params2, req)
    assert eng.prefix_cache.cached_tokens > 0 and eng.kv_block_evictions >= 2


def test_old_generation_prefill_never_populates_new_cache(params, params2):
    eng = engine(params, chunk_size=4, prefix_cache_tokens=64, kv_block_size=4)
    sched = Scheduler(eng)
    req = GenRequest(prompt=tuple((5 * i + 2) % 50 + 1 for i in range(13)), max_new_tokens=3,
                     seed=1)
    t1 = sched.submit(req)
    sched.tick()  # admit + first chunk under generation 0
    sched.call_on_tick(lambda: eng.swap_weights(params2))
    drain(sched, (t1,))
    assert eng.prefix_cache.cached_tokens == 0
    t2 = sched.submit(req)
    drain(sched, (t2,))
    assert eng.prefix_cache.stats()["hit_tokens"] == 0
    assert t1.result["tokens"] == reference(params, req)
    assert t2.result["tokens"] == reference(params2, req)


def test_swap_rollback_restores_prior_snapshot(params, params2):
    eng = engine(params)
    sched = Scheduler(eng)
    req = GenRequest(prompt=(5, 9, 2), max_new_tokens=8, temperature=0.9, top_k=10, seed=11)
    t0 = sched.submit(req)
    drain(sched, (t0,))
    sched.call_on_tick(lambda: eng.swap_weights(params2))
    sched.tick()
    sched.call_on_tick(lambda: eng.swap_weights(params))
    t1 = sched.submit(req)
    drain(sched, (t1,))
    assert eng.deploy_generation == 2
    assert t1.result["tokens"] == t0.result["tokens"] == reference(params, req)


def test_swap_validates_tree_and_shapes(params):
    """Another architecture's tree, a wrong dtype, a missing leaf: each a
    ValueError naming swap_weights, with nothing swapped."""
    eng = engine(params, num_slots=1, max_len=16)
    other = LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                        num_attention_heads=4, num_hidden_layers=2, max_position_embeddings=64)
    bad_dtype = {**params, "final_norm": params["final_norm"].double()}
    missing = {k: v for k, v in params.items() if k != "final_norm"}
    for bad in (init_params(torch.Generator().manual_seed(2), other, device="cpu"), bad_dtype,
                missing):
        with pytest.raises(ValueError, match="swap_weights"):
            eng.swap_weights(bad)
    assert eng.deploy_generation == 0 and eng.params is eng._params_by_gen[0]


def test_old_serving_copy_is_freed_with_its_last_slot(params, params2):
    """While the pre-swap stream runs both serving copies are resident;
    when it retires, nothing holds the old copy any more (on the card that
    is the ~17 GB a second 8B copy costs)."""
    eng = engine(tree_map(torch.clone, params), num_slots=1)  # the engine's alone
    eng.prefill(0, GenRequest(prompt=(5, 9, 2), max_new_tokens=6, seed=0))
    old = weakref.ref(eng.params["layers"]["wq"])
    eng.swap_weights(params2)
    eng.step()
    gc.collect()
    assert old() is not None and set(eng._params_by_gen) == {0, 1}
    eng.release(0)
    gc.collect()
    assert old() is None and set(eng._params_by_gen) == {1}


def test_admin_swap_over_a_real_socket(params, params2):
    """POST /admin/swap loads through the server's loader and swaps
    between ticks: 200 with the new generation, and the next request runs
    on the new weights; a loader failure or a tree that does not fit is a
    400; a server without a loader answers 404."""
    loads = []

    def loader(ckpt, step):
        loads.append((ckpt, step))
        if ckpt == "missing":
            raise FileNotFoundError(ckpt)
        return params2 if ckpt == "new" else {"embed": params["embed"]}

    eng = engine(params)
    srv = ServeServer(Scheduler(eng), port=0, host="127.0.0.1", swap_loader=loader,
                      request_timeout_s=60.0).start()
    bare = ServeServer(Scheduler(engine(params)), port=0, host="127.0.0.1").start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, out = http_post_json(base + "/admin/swap", {"checkpoint_dir": "new", "step": 4})
        assert code == 200, out
        assert out == {"swapped": True, "deploy_generation": 1, "checkpoint_dir": "new",
                       "step": 4}
        req = GenRequest(prompt=(7, 1, 4), max_new_tokens=5, seed=0)
        code, out = http_post_json(base + "/v1/generate", {
            "token_ids": list(req.prompt), "max_new_tokens": 5, "stop": False})
        assert code == 200 and out["token_ids"] == reference(params2, req)
        assert http_post_json(base + "/admin/swap", {"checkpoint_dir": "missing"})[0] == 400
        code, out = http_post_json(base + "/admin/swap", {"checkpoint_dir": "partial"})
        assert code == 400 and "swap_weights" in out["error"]
        assert eng.deploy_generation == 1 and loads[0] == ("new", 4)
        code, out = http_post_json(f"http://127.0.0.1:{bare.port}/admin/swap",
                                   {"checkpoint_dir": "new"})
        assert code == 404 and "swap loader" in out["error"]
    finally:
        srv.stop()
        bare.stop()
