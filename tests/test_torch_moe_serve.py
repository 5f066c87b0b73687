"""MoE through the port's serving (nanodiloco_tpu_torch/models/generate.py
and serve/engine.py) on the CPU at a tiny size (2 layers, hidden 64, vocab
128, 4 experts top-2), from one numpy tree.

- Against the JAX package: greedy ``generate()`` gives the same tokens
  for dense dispatch at an ample capacity and for ragged dispatch, with
  and without left pads; the slot programs (a final chunk's right pads,
  a tick with a dead slot) give the same logits and tokens at a capacity
  that binds. Both sides compute in float32 (JAX at "highest"): logits
  within 1e-5 of their largest magnitude, tokens identical.
- Against the port's solo ``generate()``: with ragged dispatch (no
  capacity, so routing never depends on the batch), every stream of the
  dense, the paged and the speculative engine, greedy and sampled, is the
  request run alone, token for token. On the CPU a row's bits do not
  depend on the rows beside it (``models/moe.py``'s ``_mm``), so identity
  is the bar.
"""

import dataclasses
import importlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu_torch import __main__ as cli
from nanodiloco_tpu_torch.data.tokenizer import ByteTokenizer
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy
from nanodiloco_tpu_torch.serve import GenRequest, InferenceEngine, Scheduler, http_post_json
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JG = importlib.import_module("nanodiloco_tpu.models.generate")
TG = importlib.import_module("nanodiloco_tpu_torch.models.generate")

SIZE = dict(vocab_size=128, hidden_size=64, intermediate_size=96, num_attention_heads=4,
            num_key_value_heads=2, num_hidden_layers=2, max_position_embeddings=64,
            num_experts=4, num_experts_per_tok=2)
MODES = {"dense": dict(expert_capacity_factor=4.0), "ragged": dict(moe_dispatch="ragged"),
         "binding": dict(expert_capacity_factor=0.5)}
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    """Random weights (std 0.1, the router 0.5 so routing is decided by
    clear margins, norms near 1) in the JAX layout."""
    rng = np.random.default_rng(0)
    shapes = jax.tree.map(lambda x: x.shape,
                          jax_init(jax.random.key(0), JaxConfig(**SIZE)))

    def make(path, shape):
        name = jax.tree_util.keystr(path)
        base, std = (1.0, 0.1) if "norm" in name else (0.0, 0.5 if "router" in name else 0.1)
        return (base + std * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(make, shapes, is_leaf=lambda x: isinstance(x, tuple))


def sides(tree, mode):
    """(jax cfg, jax params, port cfg, port params) for ``mode``."""
    cfg = LlamaConfig(**SIZE, **MODES[mode])
    return (JaxConfig(**cfg.to_dict()), jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, device="cpu"))


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"max error {err:.3e} of max|want| > {tol}"


def prompts(padded: bool):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, SIZE["vocab_size"], (2, 9)).astype(np.int32)
    valid = np.ones((2, 9), np.int32)
    if padded:
        valid[1, :4] = 0
        toks[1, :4] = 0
    return toks, valid


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left_padded"])
@pytest.mark.parametrize("mode", ["dense", "ragged"])
def test_greedy_generate_token_identical_to_jax(tree, mode, padded):
    jc, jp, tc, tp = sides(tree, mode)
    toks, valid = prompts(padded)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JG.generate(jp, jnp.asarray(toks), jc, 10,
                                     prompt_valid=jnp.asarray(valid)))
    got = TG.generate(tp, toks, tc, 10, prompt_valid=valid, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)


def test_left_pads_claim_no_capacity(tree):
    """At a capacity that binds, whatever the left pads hold, the padded
    row generates the same tokens: pads route nowhere (and attention
    masks them), as in JAX."""
    jc, jp, tc, tp = sides(tree, "binding")
    toks, valid = prompts(True)
    other = toks.copy()
    other[1, :4] = [7, 7, 7, 7]
    a = TG.generate(tp, toks, tc, 8, prompt_valid=valid, device="cpu")
    b = TG.generate(tp, other, tc, 8, prompt_valid=valid, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(JG.generate(jp, jnp.asarray(other), jc, 8,
                                     prompt_valid=jnp.asarray(valid)))
    np.testing.assert_array_equal(b.numpy(), ref)


def test_slot_programs_mask_right_pads_and_dead_slots_like_jax(tree):
    """At a binding capacity: a final chunk right-padded from 5 to 8
    tokens (its pads marked invalid), then a decode tick over 3 slots with
    slot 1 dead. The chunk's logits and token and the live slots' tokens
    agree with JAX's programs, which size a tick's capacity from all B
    rows with the dead ones masked."""
    jc, jp, tc, tp = sides(tree, "binding")
    s, b = 16, 3
    nkv, hd = tc.kv_heads, tc.head_dim
    rng = np.random.default_rng(3)
    base_k = rng.normal(size=(2, b, s, nkv, hd)).astype(np.float32)
    base_v = rng.normal(size=base_k.shape).astype(np.float32)
    chunk = rng.integers(0, SIZE["vocab_size"], (1, 8)).astype(np.int32)
    cvalid = np.array([[1, 1, 1, 1, 1, 0, 0, 0]], np.int32)
    kv = np.zeros((b, s), np.int32)
    kv[:, :6] = 1
    toks, pos, active = np.array([5, 9, 17]), np.array([5, 5, 5]), np.array([1, 0, 1])
    greedy = (np.float32(0.0), np.int32(0), np.float32(1.0))
    with jax.default_matmul_precision("highest"):
        jtok, jl, jcache = JG.prefill_chunk_fn(jc)(
            jp, {"k": jnp.asarray(base_k), "v": jnp.asarray(base_v)}, jnp.asarray(chunk),
            jnp.asarray(cvalid), jnp.int32(2), jnp.int32(0), jnp.int32(4),
            jax.random.key_data(jax.random.key(0)), *greedy)
        jnext, _ = JG.decode_slots_fn(jc)(
            jp, jcache, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
            jnp.asarray(kv), jnp.zeros((b, 2), jnp.uint32), jnp.zeros(b, jnp.float32),
            jnp.zeros(b, jnp.int32), jnp.ones(b, jnp.float32), jnp.asarray(active, jnp.int32))
    sp = TG.serving_params(tp, tc)
    cache = {"k": torch.as_tensor(base_k), "v": torch.as_tensor(base_v)}
    ttok, tl, cache = TG.prefill_chunk_fn(tc)(sp, cache, torch.as_tensor(chunk).long(), 2, 0, 4,
                                             None, 0.0, 0, 1.0, torch.as_tensor(cvalid))
    assert int(ttok) == int(jtok)
    close(tl, jl)
    tnext, _ = TG.decode_slots_fn(tc)(
        sp, cache, torch.as_tensor(toks), pos, torch.as_tensor(kv), None,
        np.zeros(b, np.float32), np.zeros(b, np.int64), np.ones(b, np.float32), active)
    assert [int(tnext[i]) for i in (0, 2)] == [int(jnext[i]) for i in (0, 2)]


def requests():
    return [
        GenRequest(prompt=(5, 9, 2, 11, 3), max_new_tokens=8, seed=7),
        GenRequest(prompt=(7, 1, 4), max_new_tokens=6, temperature=0.9, top_k=20, seed=3),
        GenRequest(prompt=tuple((3 * j) % 50 + 1 for j in range(13)), max_new_tokens=6,
                   seed=4),
        GenRequest(prompt=(4, 6, 4, 6, 4, 6, 4, 6, 4), max_new_tokens=10, seed=5),
        GenRequest(prompt=(8, 2, 8, 2, 8), max_new_tokens=7, temperature=0.7, top_p=0.9,
                   seed=9),
    ]


@pytest.mark.parametrize("engine_kw", [{}, {"kv_block_size": 4}, {"spec_k": 2},
                                       {"kv_block_size": 4, "spec_k": 3}],
                         ids=["dense", "paged", "spec", "paged_spec"])
def test_ragged_engine_streams_equal_solo_generate(tree, engine_kw):
    """Overlapping admissions, chunked prefill with a right-padded final
    chunk, slot refill, speculation: every stream is its request run
    alone through ``generate()`` with its seed."""
    _, _, cfg, params = sides(tree, "ragged")
    eng = InferenceEngine(params, cfg, num_slots=2, max_len=32, chunk_size=4, device="cpu",
                          **engine_kw)
    sched = Scheduler(eng)
    reqs = requests()
    tickets = [sched.submit(r) for r in reqs]
    for _ in range(400):
        if sched.tick() == 0 and all(t.done() for t in tickets):
            break
    for req, t in zip(reqs, tickets):
        solo = TG.generate(params, [list(req.prompt)], cfg, req.max_new_tokens,
                           temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                           seed=req.seed, device="cpu")[0].tolist()
        assert t.result["tokens"] == solo, req


def test_expert_choice_is_refused_for_sampling(tree):
    _, _, cfg, params = sides(tree, "dense")
    ec = dataclasses.replace(cfg, router_type="experts_choose")
    with pytest.raises(ValueError, match="expert-choice"):
        TG.generate(params, [[1, 2, 3]], ec, 4, device="cpu")
    with pytest.raises(ValueError, match="expert-choice"):
        InferenceEngine(params, ec, device="cpu")


def test_cli_generate_and_serve_from_a_ragged_checkpoint(tmp_path, capsys):
    """train() writes a ragged MoE checkpoint; ``generate`` on it prints
    the continuation solo ``generate()`` gives on the final snapshot, and
    ``serve`` in a subprocess answers POST /v1/generate with those tokens."""
    cfg = LlamaConfig(**{**SIZE, "vocab_size": 384}, moe_dispatch="ragged")
    summary = train(TrainConfig(seed=0, batch_size=2, per_device_batch_size=1, seq_length=32,
                                warmup_steps=1, total_steps=2, inner_steps=2, num_workers=2,
                                model=cfg, checkpoint_dir=str(tmp_path / "ck"),
                                log_dir=str(tmp_path / "runs"), quiet=True), device="cpu")
    texts = cli.generate_main(["--checkpoint-dir", str(tmp_path / "ck"), "--device", "cpu",
                               "--prompt", "Hello", "--max-new-tokens", "6",
                               "--temperature", "0", "--no-stop-at-eos"])
    assert capsys.readouterr().out == texts[0] + "\n"
    tok = ByteTokenizer()
    want = TG.generate(summary["state"].snapshot, [tok.encode("Hello")], cfg, 6,
                       device="cpu")[0].tolist()
    assert texts == ["Hello" + tok.decode(want)]

    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "nanodiloco_tpu_torch", "serve", "--checkpoint-dir",
         str(tmp_path / "ck"), "--device", "cpu", "--host", "127.0.0.1", "--slots", "2",
         "--max-len", "64", "--chunk-size", "8", "--kv-block-size", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving"), line + proc.stdout.read()
        port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
        code, out = http_post_json(f"http://127.0.0.1:{port}/v1/generate",
                                   {"prompt": "Hello", "max_new_tokens": 6, "stop": False},
                                   timeout=120)
        assert code == 200 and out["token_ids"] == want, out
    finally:
        proc.terminate()
        assert proc.wait(timeout=60) == 0
