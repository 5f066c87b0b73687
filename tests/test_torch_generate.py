"""The port's generation (nanodiloco_tpu_torch/models/generate.py) against
the JAX package's, on the CPU at a tiny size (2 layers, hidden 64, vocab
128, MHA and GQA), from one numpy parameter tree.

Tolerances. Both sides compute in float32 (JAX at matmul precision
"highest") and differ only in summation order: logits and cache rows
agree within 1e-5 of their largest magnitude (float32 rounding of
sums of 64 terms is ~1e-7 relative; 1e-5 leaves two orders for the
layers compounding it). Tokens are compared for identity: greedy picks
the first maximal logit on both sides, and the sampler is fed the same
Gumbel noise (``jax.random.gumbel``), since JAX's ``categorical`` is
``argmax(logits + gumbel)``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy

JG = importlib.import_module("nanodiloco_tpu.models.generate")
TG = importlib.import_module("nanodiloco_tpu_torch.models.generate")

SIZE = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_attention_heads=4,
            num_hidden_layers=2, max_position_embeddings=64)
KV_HEADS = {"mha": None, "gqa": 2}
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: six test workers each using every core run
    5-10x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """{"mha"|"gqa": (jax cfg, jax params, port cfg, port params)} from
    one numpy tree per layout."""
    out = {}
    for name, nkv in KV_HEADS.items():
        jc = JaxConfig(**SIZE, num_key_value_heads=nkv)
        jp = jax_init(jax.random.key(0), jc)
        tree = jax.tree.map(np.asarray, jp)
        out[name] = (jc, jp, LlamaConfig(**SIZE, num_key_value_heads=nkv),
                     params_from_numpy(tree, device="cpu"))
    return out


def prompts(padded: bool):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, SIZE["vocab_size"], (2, 7)).astype(np.int32)
    valid = np.ones((2, 7), np.int32)
    if padded:
        valid[1, :3] = 0
        toks[1, :3] = 0
    return toks, valid


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3e} of max|want| > {tol}"


@pytest.mark.parametrize("layout", ["mha", "gqa"])
@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left_padded"])
@pytest.mark.parametrize("block", [0, 4], ids=["dense", "blockwise"])
def test_greedy_generate_token_identical_to_jax(models, layout, padded, block):
    jc, jp, tc, tp = models[layout]
    toks, valid = prompts(padded)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JG.generate(jp, jnp.asarray(toks), jc, 10,
                                     prompt_valid=jnp.asarray(valid), decode_block=block))
    got = TG.generate(tp, toks, tc, 10, prompt_valid=valid, decode_block=block, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 10)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("layout", ["mha", "gqa"])
def test_stop_token_pins_finished_rows_like_jax(models, layout):
    """A stop token the greedy run emits at its third step: every later
    position of that row is the stop token, on both sides."""
    jc, jp, tc, tp = models[layout]
    toks, valid = prompts(False)
    free = TG.generate(tp, toks, tc, 8, device="cpu").numpy()
    stop = int(free[0, 2])
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JG.generate(jp, jnp.asarray(toks), jc, 8, stop_token=stop))
    got = TG.generate(tp, toks, tc, 8, stop_token=stop, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[0, 2:] == stop).all()


@pytest.mark.parametrize("layout", ["mha", "gqa"])
@pytest.mark.parametrize("block", [0, 4], ids=["dense", "blockwise"])
def test_cached_block_logits_and_cache_match_jax(models, layout, block):
    """Prefill of a left-padded prompt, then one decode step, through
    both: logits and every cache row within TOL."""
    jc, jp, tc, tp = models[layout]
    toks, valid = prompts(True)
    s = 12
    kv = np.concatenate([valid, np.ones((2, s - 7), np.int32)], axis=1)
    with jax.default_matmul_precision("highest"):
        jl, jcache = JG._cached_block(jp, jc, jnp.asarray(toks), JG.init_kv_cache(jc, 2, s),
                                      jnp.int32(0), jnp.asarray(kv), jnp.asarray(valid),
                                      block=block)
        nxt = jnp.argmax(jl, axis=-1)[:, None].astype(jnp.int32)
        jl2, jcache = JG._cached_block(jp, jc, nxt, jcache, jnp.int32(7), jnp.asarray(kv),
                                       jnp.ones((2, 1), jnp.int32), block=block)
    sp = TG.serving_params(tp, tc)
    kvt = torch.as_tensor(kv)
    tl, tcache = TG._cached_block(sp, tc, torch.as_tensor(toks).long(),
                                  TG.init_kv_cache(tc, 2, s, "cpu"), 0, kvt, block=block)
    tl2, tcache = TG._cached_block(sp, tc, torch.as_tensor(np.array(nxt)).long(), tcache, 7,
                                   kvt, block=block)
    close(tl, jl)
    close(tl2, jl2)
    close(tcache["k"], jcache["k"])
    close(tcache["v"], jcache["v"])


def test_a_write_past_the_cache_raises(models):
    """``dynamic_update_slice`` clamps an out-of-range write backwards
    over real rows; the port refuses it."""
    _, _, tc, tp = models["gqa"]
    cache = TG.init_kv_cache(tc, 1, 8, "cpu")
    with pytest.raises(ValueError, match="overruns the cache"):
        TG._cached_block(TG.serving_params(tp, tc), tc, torch.zeros((1, 4), dtype=torch.long),
                         cache, 5, torch.ones((1, 8), dtype=torch.int32))


# -- the sampler ---------------------------------------------------------------

V = 128
SETTINGS = [
    pytest.param(0.0, 0, 1.0, id="greedy"),
    pytest.param(0.8, 0, 1.0, id="temperature"),
    pytest.param(1.0, 10, 1.0, id="top_k"),
    pytest.param(1.2, 0, 0.7, id="top_p"),
    pytest.param(0.9, 20, 0.8, id="top_k_and_top_p"),
    pytest.param(0.7, V, 1.0, id="top_k_whole_vocab"),
]


def logits_batch(b=6, scale=3.0):
    return np.random.default_rng(1).normal(size=(b, V)).astype(np.float32) * scale


@pytest.mark.parametrize("temperature, top_k, top_p", SETTINGS)
def test_sample_token_identical_to_jax(temperature, top_k, top_p):
    lg = logits_batch()
    key = jax.random.key(9)
    ref = np.asarray(JG._sample(jnp.asarray(lg), key, temperature, top_k, top_p))
    noise = torch.as_tensor(np.array(jax.random.gumbel(key, lg.shape, jnp.float32)))
    got = TG._sample(torch.as_tensor(lg), noise, temperature, top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_slots_mixed_batch_token_identical_to_jax(seed):
    """Greedy and sampled rows in one batch, each with its own settings
    (and a batch whose only sampled rows use neither cut)."""
    lg = logits_batch()
    keys = jax.random.split(jax.random.key(seed), 6)
    cases = [
        (np.array([0, .7, 1.0, .9, 1.2, .5], np.float32), np.array([0, 0, 10, 0, 5, 40]),
         np.array([1, 1, 1, .8, .7, .95], np.float32)),
        (np.array([0, .7, 0, 1.3, 0, .5], np.float32), np.zeros(6, np.int64),
         np.ones(6, np.float32)),
    ]
    noise = torch.as_tensor(np.stack([np.asarray(jax.random.gumbel(k, (V,), jnp.float32))
                                      for k in keys]))
    for temp, top_k, top_p in cases:
        ref = np.asarray(JG._sample_slots(jnp.asarray(lg), keys, jnp.asarray(temp),
                                          jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p)))
        got = TG._sample_slots(torch.as_tensor(lg), noise, temp, top_k, top_p)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_noise_depends_only_on_seed_stream_step():
    """Row b's uniforms are a function of (seed, stream, step) alone: the
    same triple in another batch, at another row, gives the same bits;
    any change of one of the three changes them; all lie in (0, 1)."""
    a = TG.noise_uniforms([7, 7, 8, 7], [0, 0, 0, 1], [3, 4, 3, 3], V, "cpu")
    b = TG.noise_uniforms([1, 7], [0, 0], [0, 3], V, "cpu")
    assert torch.equal(a[0], b[1])
    for i in (1, 2, 3):
        assert not torch.equal(a[0], a[i])
    assert 0.0 < a.min().item() and a.max().item() < 1.0
    big = TG.noise_uniforms([2**40 + 7, -3], [0, 0], [0, 0], V, "cpu")
    assert torch.isfinite(big).all() and not torch.equal(big[0], big[1])
    g = TG.gumbel_noise([7], [0], [3], V, "cpu")
    assert torch.equal(g[0], (-torch.log(-torch.log(a[0].double()))).float())


# -- the slot programs -------------------------------------------------------


@pytest.mark.parametrize("layout", ["mha", "gqa"])
def test_slot_programs_match_jax_and_spare_dead_slots(models, layout):
    """prefill_chunk_fn writes one chunk of slot 1's prompt, then
    decode_slots_fn advances slot 0 alone (slot 1 dead, mid-prefill): the
    chunk's logits and the decode tokens agree with JAX's, the caches
    agree within TOL, and the dead slot's rows are what the chunk wrote."""
    jc, jp, tc, tp = models[layout]
    s, b = 16, 2
    rng = np.random.default_rng(3)
    base_k = rng.normal(size=(2, b, s, tc.kv_heads, tc.head_dim)).astype(np.float32)
    base_v = rng.normal(size=base_k.shape).astype(np.float32)
    chunk = rng.integers(0, V, (1, 4)).astype(np.int32)
    greedy = (np.float32(0.0), np.int32(0), np.float32(1.0))
    with jax.default_matmul_precision("highest"):
        jtok, jl, jcache = JG.prefill_chunk_fn(jc)(
            jp, {"k": jnp.asarray(base_k), "v": jnp.asarray(base_v)}, jnp.asarray(chunk),
            jnp.ones((1, 4), jnp.int32), jnp.int32(1), jnp.int32(4), jnp.int32(3),
            jax.random.key_data(jax.random.key(0)), *greedy)
        after_chunk = {k: np.asarray(v) for k, v in jcache.items()}
        kv = np.zeros((b, s), np.int32)
        kv[0, :6] = 1
        jnext, jcache = JG.decode_slots_fn(jc)(
            jp, jcache, jnp.asarray([5, 0], jnp.int32), jnp.asarray([5, 0], jnp.int32),
            jnp.asarray(kv), jnp.zeros((b, 2), jnp.uint32), jnp.zeros(b, jnp.float32),
            jnp.zeros(b, jnp.int32), jnp.ones(b, jnp.float32), jnp.asarray([1, 0], jnp.int32))
    sp = TG.serving_params(tp, tc)
    cache = {"k": torch.as_tensor(base_k), "v": torch.as_tensor(base_v)}
    ttok, tl, cache = TG.prefill_chunk_fn(tc)(sp, cache, torch.as_tensor(chunk).long(), 1, 4, 3,
                                             None, 0.0, 0, 1.0)
    assert int(ttok) == int(jtok)
    close(tl, jl)
    close(cache["k"], after_chunk["k"])
    slot1 = {k: v[:, 1].clone() for k, v in cache.items()}
    tnext, cache = TG.decode_slots_fn(tc)(
        sp, cache, torch.tensor([5, 0]), np.array([5, 0]), torch.as_tensor(kv), None,
        np.zeros(b, np.float32), np.zeros(b, np.int64), np.ones(b, np.float32), np.array([1, 0]))
    assert int(tnext[0]) == int(jnext[0])
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])
    assert torch.equal(cache["k"][:, 1], slot1["k"]) and torch.equal(cache["v"][:, 1], slot1["v"])


def test_extract_and_insert_round_trip(models):
    _, _, tc, _ = models["gqa"]
    cache = TG.init_kv_cache(tc, 2, 8, "cpu")
    cache["k"].normal_()
    cache["v"].normal_()
    k, v = TG.extract_chunk_fn(tc)(cache, 0, 4, 4)
    TG.insert_chunk_fn(tc)(cache, k, v, 1, 0)
    assert torch.equal(cache["k"][:, 1, :4], cache["k"][:, 0, 4:])
    assert torch.equal(cache["v"][:, 1, :4], cache["v"][:, 0, 4:])
    with pytest.raises(ValueError, match="overrun"):
        TG.insert_chunk_fn(tc)(cache, k, v, 1, 6)


# -- arguments and entry point ------------------------------------------------


@pytest.mark.parametrize("kwargs, match", [
    ({"max_new_tokens": 0}, "max_new_tokens"),
    ({"temperature": -1.0}, "temperature"),
    ({"top_k": -1}, "top_k"),
    ({"top_p": 0.0}, "top_p"),
    ({"top_p": 1.5}, "top_p"),
    ({"temperature": 0.5}, "seed"),
    ({"decode_block": -4}, "decode_block"),
    ({"prompt": [1, 2, 3]}, r"\[batch, prompt_len\]"),
])
def test_generate_argument_checks(models, kwargs, match):
    _, _, tc, tp = models["gqa"]
    args = {"prompt": [[1, 2, 3]], "max_new_tokens": 2, **kwargs}
    with pytest.raises(ValueError, match=match):
        TG.generate(tp, args.pop("prompt"), tc, args.pop("max_new_tokens"), device="cpu",
                    **args)


def test_generate_runs_on_the_card_unless_asked_for_the_cpu(models, monkeypatch):
    """The default device is the card; without one it raises rather than
    carry on on the CPU."""
    _, _, tc, tp = models["gqa"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TG.generate(tp, [[1, 2]], tc, 2)


def test_sampled_generate_is_deterministic_per_seed(models):
    _, _, tc, tp = models["gqa"]
    toks, _ = prompts(False)
    kw = dict(temperature=0.9, top_k=20, device="cpu")
    a = TG.generate(tp, toks, tc, 8, seed=3, **kw)
    assert torch.equal(a, TG.generate(tp, toks, tc, 8, seed=3, **kw))
    assert not torch.equal(a, TG.generate(tp, toks, tc, 8, seed=4, **kw))
    # row 0 of a batch samples what a one-row call with the same seed does
    assert torch.equal(a[0], TG.generate(tp, toks[:1], tc, 8, seed=3, **kw)[0])


def test_serving_params_cast_once_and_share_what_fits():
    cfg = LlamaConfig(**SIZE, dtype="bfloat16", tie_word_embeddings=True)
    from nanodiloco_tpu_torch.models.llama import init_params

    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    sp = TG.serving_params(params, cfg)
    assert all(sp["layers"][k].dtype == torch.bfloat16 for k in TG.MATMUL_KEYS)
    assert sp["layers"]["attn_norm"] is params["layers"]["attn_norm"]
    assert sp["embed"] is params["embed"] and sp["embed"].dtype == torch.float32
    assert torch.equal(sp["lm_head"], params["embed"].t().to(torch.bfloat16))
    again = TG.serving_params(sp, cfg)
    assert all(again["layers"][k] is sp["layers"][k] for k in TG.MATMUL_KEYS)


def test_pad_prompts():
    toks, valid = TG.pad_prompts([[1, 2, 3], [4], []])
    assert toks.tolist() == [[1, 2, 3], [0, 0, 4], [0, 0, 0]]
    assert valid.tolist() == [[1, 1, 1], [0, 0, 1], [0, 0, 0]]
    with pytest.raises(ValueError):
        TG.pad_prompts([])
