"""HF Llama weights in and out: port of ``nanodiloco_tpu/models/hf_interop.py``.

- ``from_hf_state_dict`` / ``from_hf_pretrained`` build the port's
  parameter tree from ``transformers.LlamaForCausalLM`` weights, in memory
  or from disk (sharded safetensors with their index, a directory with
  one ``model.safetensors``, or a bare file);
- ``to_hf_state_dict`` / ``load_into_hf`` give a trained snapshot back
  to the HF toolchain, and ``save_hf_pretrained`` writes it to disk in
  the sharded layout ``from_pretrained`` reads.

The files are read and written by ``models/safetensors_io.py``; only
``load_into_hf`` needs ``transformers``, imported when it is called.

Layout: HF projections are ``[out, in]``, the port's ``[in, out]``, and
the port stacks each per-layer weight on a leading layer axis; a tied
config has no ``lm_head`` (the export leaves it out of the files, as
``save_pretrained`` does). Every import is pure layout: each stacked
leaf is allocated once on the target device, in ``param_dtype``, and
filled layer by layer; a layer's tensor goes to the device as stored and
is transposed and cast there. Host memory therefore holds at most one
per-layer tensor beyond the memory maps of the file being read, and the
leaves come out contiguous. MoE configs are rejected: HF's
LlamaForCausalLM has no MoE variant.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any, Callable, Mapping

import numpy as np
import torch

from nanodiloco_tpu_torch.models import safetensors_io as st
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import Params, dtype_of, resolve_device

# the port's layer-stack leaf -> (HF per-layer key template, transpose?)
_LAYER_MAP: dict[str, tuple[str, bool]] = {
    "attn_norm": ("model.layers.{}.input_layernorm.weight", False),
    "wq": ("model.layers.{}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{}.self_attn.o_proj.weight", True),
    "mlp_norm": ("model.layers.{}.post_attention_layernorm.weight", False),
    "w_gate": ("model.layers.{}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{}.mlp.down_proj.weight", True),
}
INDEX = "model.safetensors.index.json"
_OWN_FILE = re.compile(r"^model(-\d{5}-of-\d{5})?\.safetensors$")


def _check_dense(cfg: LlamaConfig) -> None:
    if cfg.num_experts:
        raise ValueError(
            "HF interop supports dense Llama only (transformers' "
            "LlamaForCausalLM has no MoE variant)"
        )


def _build_params(get: Callable[[str], torch.Tensor], has: Callable[[str], bool],
                  cfg: LlamaConfig, device: torch.device) -> Params:
    """The import core over per-tensor reads: ``get(key)`` returns one HF
    tensor in its stored dtype (KeyError when absent), ``has(key)`` says
    whether it exists."""
    _check_dense(cfg)
    n = cfg.num_hidden_layers
    pdt = dtype_of(cfg.param_dtype)
    extra = f"model.layers.{n}.self_attn.q_proj.weight"
    if has(extra):
        raise ValueError(
            f"HF state dict has more than {n} layers (found {extra!r}); "
            "cfg.num_hidden_layers does not match the checkpoint — "
            "importing would silently truncate the model"
        )

    def leaf(w: torch.Tensor, transpose: bool = False) -> torch.Tensor:
        # a fresh buffer: the result never aliases the file's map or the
        # caller's tensor
        w = w.to(device)
        w = w.T if transpose else w
        return torch.empty(tuple(w.shape), dtype=pdt, device=device).copy_(w)

    embed = get("model.embed_tokens.weight")
    if tuple(embed.shape) != (cfg.vocab_size, cfg.hidden_size):
        raise ValueError(
            f"embed_tokens shape {tuple(embed.shape)} does not match config "
            f"({cfg.vocab_size}, {cfg.hidden_size})"
        )
    params: Params = {"embed": leaf(embed)}
    del embed
    layers = {}
    for ours, (fmt, transpose) in _LAYER_MAP.items():
        buf = None
        for i in range(n):
            w = get(fmt.format(i)).to(device)
            w = w.T if transpose else w
            if buf is None:
                buf = torch.empty((n,) + tuple(w.shape), dtype=pdt, device=device)
            buf[i].copy_(w)
            del w
        layers[ours] = buf
    params["layers"] = layers
    params["final_norm"] = leaf(get("model.norm.weight"))
    if not cfg.tie_word_embeddings:
        params["lm_head"] = leaf(get("lm_head.weight"), transpose=True)
    return params


def from_hf_state_dict(sd: Mapping[str, Any], cfg: LlamaConfig,
                       device: str | torch.device = "cuda") -> Params:
    """The port's tree from an in-memory HF Llama state dict whose values
    are torch tensors or numpy arrays (e.g. ``model.state_dict()``); the
    result never aliases them."""
    device = resolve_device(device)

    def get(key: str) -> torch.Tensor:
        if key not in sd:
            raise KeyError(f"HF state dict is missing {key!r}")
        v = sd[key]
        if torch.is_tensor(v):
            return v.detach()
        with warnings.catch_warnings():
            # read-only arrays are only read: the import copies out of them
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(np.asarray(v))

    return _build_params(get, lambda k: k in sd, cfg, device)


class _HFWeightSource:
    """Per-tensor reader over an HF checkpoint: a directory with sharded
    ``model-XXXXX-of-XXXXX.safetensors`` and ``model.safetensors.index.json``
    (the index is probed first), a directory with one
    ``model.safetensors``, or a bare safetensors file."""

    def __init__(self, path: str):
        self._dir = path if os.path.isdir(path) else os.path.dirname(path)
        self._files: dict[str, st.SafetensorsFile] = {}
        index = os.path.join(self._dir, INDEX)
        if os.path.isdir(path) and os.path.exists(index):
            with open(index) as f:
                self._weight_map: dict[str, str] = json.load(f)["weight_map"]
            return
        single = os.path.join(path, "model.safetensors") if os.path.isdir(path) else path
        if not os.path.exists(single):
            raise FileNotFoundError(
                f"no model.safetensors or {INDEX} under {path!r}"
            )
        fname = os.path.basename(single)
        self._files[fname] = st.SafetensorsFile(single)
        self._weight_map = dict.fromkeys(self._files[fname].keys(), fname)

    def has(self, key: str) -> bool:
        return key in self._weight_map

    def get(self, key: str) -> torch.Tensor:
        if key not in self._weight_map:
            raise KeyError(f"HF checkpoint is missing {key!r}")
        fname = self._weight_map[key]
        if fname not in self._files:
            self._files[fname] = st.SafetensorsFile(os.path.join(self._dir, fname))
        return self._files[fname].get(key)

    def close(self) -> None:
        self._files.clear()

    def __enter__(self) -> "_HFWeightSource":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def from_hf_pretrained(path: str, cfg: LlamaConfig,
                       device: str | torch.device = "cuda") -> Params:
    """Import an HF Llama checkpoint from disk one tensor at a time onto
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    with _HFWeightSource(path) as src:
        return _build_params(src.get, src.has, cfg, device)


def _export_plan(params: Params, cfg: LlamaConfig,
                 include_tied_head: bool = True) -> list[st.Entry]:
    """Ordered ``(hf_key, dtype, shape, produce)`` entries. ``produce()``
    materializes that one tensor on the host, contiguous, in float32, in
    HF's orientation; shapes are known up front, so the sharded writer
    plans its files without touching data."""
    _check_dense(cfg)
    dtype = torch.float32

    def of(t: torch.Tensor, transpose: bool = False) -> Callable[[], torch.Tensor]:
        # transposed and cast where the tensor lives, then one copy out
        return lambda: (t.T if transpose else t).detach().float().contiguous().cpu()

    def shape(t: torch.Tensor, transpose: bool = False) -> tuple[int, ...]:
        return tuple(t.shape)[::-1] if transpose else tuple(t.shape)

    embed = params["embed"]
    plan: list[st.Entry] = [("model.embed_tokens.weight", dtype, shape(embed), of(embed))]
    for ours, (fmt, transpose) in _LAYER_MAP.items():
        stack = params["layers"][ours]
        for i in range(cfg.num_hidden_layers):
            plan.append((fmt.format(i), dtype, shape(stack[i], transpose),
                         of(stack[i], transpose)))
    plan.append(("model.norm.weight", dtype, shape(params["final_norm"]),
                 of(params["final_norm"])))
    if cfg.tie_word_embeddings:
        if include_tied_head:
            plan.append(("lm_head.weight", dtype, shape(embed), of(embed)))
    else:
        head = params["lm_head"]
        plan.append(("lm_head.weight", dtype, shape(head, True), of(head, True)))
    return plan


def to_hf_state_dict(params: Params, cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """Inverse of ``from_hf_state_dict``: HF Llama keys, float32 CPU
    tensors in HF's ``[out, in]`` orientation; a tied head is emitted as
    the embedding (what HF's tying gives). Holds the whole model in
    float32; ``save_hf_pretrained`` writes to disk a tensor at a time."""
    return {k: produce() for k, _dtype, _shape, produce in _export_plan(params, cfg)}


def hf_config(cfg: LlamaConfig, torch_dtype: str = "float32") -> dict[str, Any]:
    """The ``config.json`` ``LlamaForCausalLM.from_pretrained`` reads."""
    return {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.kv_heads,
        "num_hidden_layers": cfg.num_hidden_layers,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "max_position_embeddings": cfg.max_position_embeddings,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "torch_dtype": torch_dtype,
    }


def save_hf_pretrained(params: Params, cfg: LlamaConfig, out_dir: str,
                       max_shard_bytes: int = 5 * 1024**3) -> list[str]:
    """Write an HF-layout checkpoint under ``out_dir``, one tensor in
    host memory at a time: ``model-XXXXX-of-XXXXX.safetensors`` files
    plus ``model.safetensors.index.json`` when the tensors exceed
    ``max_shard_bytes`` (5 GiB by default), else one ``model.safetensors``.
    Tensors are written in float32, as the JAX package exports. A tied ``lm_head.weight`` is left out, as
    ``save_pretrained`` does. Files this writer names that a previous
    export left in ``out_dir`` are removed first (a stale index would
    win the reader's index-first probe); nothing else there is touched.
    Returns the written file names."""
    plan = _export_plan(params, cfg, include_tied_head=False)
    shards: list[list[int]] = [[]]
    acc = 0
    for idx, (_key, _dt, shape, _produce) in enumerate(plan):
        nbytes = 4 * int(np.prod(shape, dtype=np.int64))
        if shards[-1] and acc + nbytes > max_shard_bytes:
            shards.append([])
            acc = 0
        shards[-1].append(idx)
        acc += nbytes

    os.makedirs(out_dir, exist_ok=True)
    for fname in sorted(os.listdir(out_dir)):
        if _OWN_FILE.match(fname) or fname == INDEX:
            print(f"[nanodiloco] export: pruning previous {fname}")
            os.remove(os.path.join(out_dir, fname))

    n = len(shards)
    names = (["model.safetensors"] if n == 1
             else [f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i in range(n)])
    weight_map: dict[str, str] = {}
    total = 0
    for name, idxs in zip(names, shards):
        entries = [plan[i] for i in idxs]
        total += st.write_file(os.path.join(out_dir, name), entries, {"format": "pt"})
        weight_map.update(dict.fromkeys((e[0] for e in entries), name))
    written = list(names)
    if n > 1:
        with open(os.path.join(out_dir, INDEX), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map},
                      f, indent=1)
        written.append(INDEX)
    return written


def load_into_hf(params: Params, hf_model, cfg: LlamaConfig):
    """Copy a snapshot into an existing ``transformers.LlamaForCausalLM``
    of the same architecture (in place; returns the model)."""
    missing, unexpected = hf_model.load_state_dict(to_hf_state_dict(params, cfg),
                                                   strict=False)
    # rotary tables may be non-persistent buffers; real weights must match
    real_missing = [k for k in missing if "rotary" not in k and "inv_freq" not in k]
    if real_missing or unexpected:
        raise ValueError(
            f"state dict mismatch: missing={real_missing} unexpected={list(unexpected)}"
        )
    return hf_model
