"""The port's HF weight interop (nanodiloco_tpu_torch/models/hf_interop.py)
against the JAX package's and against ``transformers``, on the CPU.

- Import and export are pure layout (transposes, stacking, copies): the
  port's ``from_hf_state_dict`` / ``to_hf_state_dict`` agree with the JAX
  package's on the same numpy-seeded inputs bit for bit, and files either
  package writes import to the same tree in the other.
- The sharded writer's files, index and pruning, as in
  tests/test_hf_sharded.py; ``transformers.LlamaForCausalLM.from_pretrained``
  loads a sharded export.
- Logits against transformers' eager Llama at 2e-4 (the JAX tests' bound:
  float32, different summation orders) for kv heads in {heads, heads/2,
  1}, and the loss at 1e-4 relative.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import from_hf_pretrained as jax_from_hf_pretrained
from nanodiloco_tpu.models import from_hf_state_dict as jax_from_hf_state_dict
from nanodiloco_tpu.models import save_hf_pretrained as jax_save_hf_pretrained
from nanodiloco_tpu.models import to_hf_state_dict as jax_to_hf_state_dict
from nanodiloco_tpu_torch.models import hf_interop as hf
from nanodiloco_tpu_torch.models import safetensors_io as st
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import (
    causal_lm_loss,
    forward,
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
)

CFG = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=3,
                  max_position_embeddings=64)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch thread per test worker process, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(cfg: LlamaConfig, seed: int) -> dict:
    """A parameter tree in the shared layout, numpy float32 from a seed."""
    rng = np.random.default_rng(seed)
    d, f, v, n = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_hidden_layers
    q, kv = cfg.num_attention_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim

    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    tree = {"embed": w(v, d), "final_norm": 1 + w(d), "layers": {
        "attn_norm": 1 + w(n, d), "wq": w(n, d, q), "wk": w(n, d, kv), "wv": w(n, d, kv),
        "wo": w(n, q, d), "mlp_norm": 1 + w(n, d), "w_gate": w(n, d, f), "w_up": w(n, d, f),
        "w_down": w(n, f, d)}}
    if not cfg.tie_word_embeddings:
        tree["lm_head"] = w(d, v)
    return tree


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in flat(tree[k], f"{prefix}{k}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def hf_state_dict(cfg, seed):
    """An HF-layout state dict (numpy) built by the JAX exporter."""
    return jax_to_hf_state_dict(jax.tree.map(jnp.asarray, numpy_params(cfg, seed)),
                                JaxConfig(**cfg.to_dict()))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_from_hf_state_dict_matches_jax_bit_for_bit(tied):
    cfg = dataclasses.replace(CFG, tie_word_embeddings=tied)
    sd = hf_state_dict(cfg, 0)
    want = jax_from_hf_state_dict(sd, JaxConfig(**cfg.to_dict()))
    got = hf.from_hf_state_dict(sd, cfg, device="cpu")
    assert_trees_equal(params_to_numpy(got), jax.tree.map(np.asarray, want))
    # torch tensors in (as model.state_dict() gives them) import the same
    got_t = hf.from_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg, "cpu")
    assert_trees_equal(params_to_numpy(got_t), params_to_numpy(got))
    assert all(t.is_contiguous() for t in tree_leaves(got))


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_to_hf_state_dict_matches_jax_bit_for_bit(tied):
    cfg = dataclasses.replace(CFG, tie_word_embeddings=tied)
    tree = numpy_params(cfg, 1)
    want = jax_to_hf_state_dict(jax.tree.map(jnp.asarray, tree), JaxConfig(**cfg.to_dict()))
    got = hf.to_hf_state_dict(params_from_numpy(tree, "cpu"), cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_import_never_aliases_its_input():
    sd = {k: torch.from_numpy(v) for k, v in hf_state_dict(CFG, 2).items()}
    params = hf.from_hf_state_dict(sd, CFG, "cpu")
    before = params["embed"].clone()
    sd["model.embed_tokens.weight"].add_(1.0)
    assert torch.equal(params["embed"], before)


def test_files_cross_between_packages(tmp_path):
    """The port reads what the JAX package writes and the JAX package reads
    what the port writes, to the same trees."""
    tree = numpy_params(CFG, 3)
    jcfg = JaxConfig(**CFG.to_dict())
    jax_save_hf_pretrained(jax.tree.map(jnp.asarray, tree), jcfg, str(tmp_path / "j"),
                           max_shard_bytes=200_000)
    assert_trees_equal(params_to_numpy(hf.from_hf_pretrained(str(tmp_path / "j"), CFG, "cpu")),
                       tree)
    hf.save_hf_pretrained(params_from_numpy(tree, "cpu"), CFG, str(tmp_path / "p"),
                          max_shard_bytes=200_000)
    assert_trees_equal(jax.tree.map(np.asarray,
                                    jax_from_hf_pretrained(str(tmp_path / "p"), jcfg)), tree)


def test_multi_shard_roundtrip_exact(tmp_path):
    params = params_from_numpy(numpy_params(CFG, 4), "cpu")
    written = hf.save_hf_pretrained(params, CFG, str(tmp_path), max_shard_bytes=200_000)
    shard_files = [w for w in written if w.endswith(".safetensors")]
    assert len(shard_files) > 1
    assert shard_files == [f"model-{i + 1:05d}-of-{len(shard_files):05d}.safetensors"
                           for i in range(len(shard_files))]
    index = json.load(open(tmp_path / "model.safetensors.index.json"))
    assert set(index["weight_map"].values()) == set(shard_files)
    assert index["metadata"]["total_size"] == sum(
        t.numel() * 4 for t in hf.to_hf_state_dict(params, CFG).values())
    assert_trees_equal(params_to_numpy(hf.from_hf_pretrained(str(tmp_path), CFG, "cpu")),
                       params_to_numpy(params))


def test_single_file_roundtrip(tmp_path):
    params = params_from_numpy(numpy_params(CFG, 5), "cpu")
    assert hf.save_hf_pretrained(params, CFG, str(tmp_path)) == ["model.safetensors"]
    assert not (tmp_path / "model.safetensors.index.json").exists()
    for path in (tmp_path, tmp_path / "model.safetensors"):  # a bare file works too
        assert_trees_equal(params_to_numpy(hf.from_hf_pretrained(str(path), CFG, "cpu")),
                           params_to_numpy(params))


def test_tied_export_omits_lm_head(tmp_path):
    cfg = dataclasses.replace(CFG, tie_word_embeddings=True)
    params = params_from_numpy(numpy_params(cfg, 6), "cpu")
    hf.save_hf_pretrained(params, cfg, str(tmp_path), max_shard_bytes=200_000)
    index = json.load(open(tmp_path / "model.safetensors.index.json"))
    assert "lm_head.weight" not in index["weight_map"]
    assert_trees_equal(params_to_numpy(hf.from_hf_pretrained(str(tmp_path), cfg, "cpu")),
                       params_to_numpy(params))


def test_plan_shapes_match_produced_tensors():
    params = params_from_numpy(numpy_params(CFG, 7), "cpu")
    for key, dtype, shape, produce in hf._export_plan(params, CFG):
        t = produce()
        assert tuple(t.shape) == shape and t.dtype == dtype == torch.float32, key
        assert t.is_contiguous() and t.device.type == "cpu", key
    assert ({k for k, *_ in hf._export_plan(params, CFG)}
            == set(hf.to_hf_state_dict(params, CFG)))


def test_bf16_export_imports_in_bf16_without_loss(tmp_path):
    """A bf16 file (as Meta ships) into bf16 params: the same bits."""
    cfg = dataclasses.replace(CFG, param_dtype="bfloat16")
    params = {k: v for k, v in params_from_numpy(numpy_params(CFG, 8), "cpu").items()}
    params = jax.tree.map(lambda t: t.bfloat16(), params)
    # the export plan's float32 tensors back in bf16 (exact), in one file
    entries = [(key, torch.bfloat16, shape, lambda p=produce: p().bfloat16())
               for key, _, shape, produce in hf._export_plan(params, cfg, False)]
    st.write_file(str(tmp_path / "model.safetensors"), entries, {"format": "pt"})
    back = hf.from_hf_pretrained(str(tmp_path), cfg, "cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(back)):
        assert b.dtype == torch.bfloat16 and b.is_contiguous() and torch.equal(a, b)


def test_reexport_prunes_stale_shards(tmp_path):
    a = params_from_numpy(numpy_params(CFG, 9), "cpu")
    b = params_from_numpy(numpy_params(CFG, 10), "cpu")
    (tmp_path / "unrelated.safetensors").write_bytes(b"keep me")
    hf.save_hf_pretrained(a, CFG, str(tmp_path), max_shard_bytes=200_000)
    hf.save_hf_pretrained(b, CFG, str(tmp_path))
    assert not (tmp_path / "model.safetensors.index.json").exists()
    assert [p.name for p in tmp_path.glob("model-*.safetensors")] == []
    assert (tmp_path / "unrelated.safetensors").read_bytes() == b"keep me"
    assert_trees_equal(params_to_numpy(hf.from_hf_pretrained(str(tmp_path), CFG, "cpu")),
                       params_to_numpy(b))


def hf_llama_config(cfg: LlamaConfig) -> transformers.LlamaConfig:
    return transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_attention_heads=cfg.num_attention_heads, num_key_value_heads=cfg.kv_heads,
        num_hidden_layers=cfg.num_hidden_layers, rms_norm_eps=cfg.rms_norm_eps,
        use_cache=False, max_position_embeddings=cfg.max_position_embeddings,
        tie_word_embeddings=cfg.tie_word_embeddings, attn_implementation="eager",
    )


def tokens(cfg, seed, shape=(2, 32)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, size=shape)


def test_transformers_loads_sharded_export(tmp_path):
    params = params_from_numpy(numpy_params(CFG, 11), "cpu")
    hf.save_hf_pretrained(params, CFG, str(tmp_path), max_shard_bytes=200_000)
    (tmp_path / "config.json").write_text(json.dumps(hf.hf_config(CFG)))
    model = transformers.LlamaForCausalLM.from_pretrained(
        str(tmp_path), attn_implementation="eager").eval()
    toks = tokens(CFG, 0, (2, 16))
    with torch.no_grad():
        want = model(input_ids=torch.tensor(toks)).logits.numpy()
        got = forward(params, torch.tensor(toks), CFG).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kv_heads", [4, 2, 1])
def test_hf_llama_logit_parity(kv_heads):
    cfg = LlamaConfig(vocab_size=256, hidden_size=128, intermediate_size=512,
                      num_attention_heads=4, num_key_value_heads=kv_heads,
                      num_hidden_layers=3, max_position_embeddings=64)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_llama_config(cfg)).eval()
    params = hf.from_hf_state_dict(model.state_dict(), cfg, "cpu")
    toks = torch.tensor(tokens(cfg, 0))
    with torch.no_grad():
        want = model(input_ids=toks).logits
        got = forward(params, toks, cfg)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
        hf_loss = model(input_ids=toks, labels=toks).loss.item()
        loss, _ = causal_lm_loss(params, toks, cfg)
    np.testing.assert_allclose(float(loss), hf_loss, rtol=1e-4)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_hf_roundtrip(tied):
    cfg = dataclasses.replace(CFG, tie_word_embeddings=tied)
    params = params_from_numpy(numpy_params(cfg, 12), "cpu")
    back = hf.from_hf_state_dict(hf.to_hf_state_dict(params, cfg), cfg, "cpu")
    assert_trees_equal(params_to_numpy(back), params_to_numpy(params))


def test_hf_export_logit_parity():
    cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                      max_position_embeddings=64)
    params = params_from_numpy(numpy_params(cfg, 13), "cpu")
    model = hf.load_into_hf(params, transformers.LlamaForCausalLM(hf_llama_config(cfg)).eval(),
                            cfg)
    toks = torch.tensor(tokens(cfg, 1, (2, 16)))
    with torch.no_grad():
        np.testing.assert_allclose(forward(params, toks, cfg).numpy(),
                                   model(input_ids=toks).logits.numpy(), rtol=2e-4, atol=2e-4)


def test_hf_interop_rejects_moe_and_layer_mismatch():
    moe = dataclasses.replace(CFG, num_experts=4)
    with pytest.raises(ValueError, match="dense Llama only"):
        hf.to_hf_state_dict(params_from_numpy(numpy_params(CFG, 0), "cpu"), moe)
    cfg4 = dataclasses.replace(CFG, num_hidden_layers=4)
    sd = hf_state_dict(cfg4, 0)
    with pytest.raises(ValueError, match="more than 2 layers"):
        hf.from_hf_state_dict(sd, dataclasses.replace(CFG, num_hidden_layers=2), "cpu")
    with pytest.raises(ValueError, match="embed_tokens shape"):
        hf.from_hf_state_dict(sd, dataclasses.replace(cfg4, vocab_size=128), "cpu")
    if not torch.cuda.is_available():
        # the card unless the caller asks for the CPU: no silent fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hf.from_hf_state_dict(sd, cfg4)
