"""The port's sharding rules (nanodiloco_tpu_torch.parallel.sharding and
the inner axes of parallel/mesh.py) in one process, on the CPU.

- ``param_specs`` against the JAX package's ``param_specs``, leaf for leaf
  (its ``PartitionSpec``s' entries): untied, tied and MoE trees, with and
  without the worker axis.
- ``shard`` at every rank of a layout: the boxes tile the whole tree, each
  element held by exactly the ranks of the axes it is whole along, bit for
  bit (the gathers of ``unshard`` run in tests/test_torch_dist_shard.py).
- The vocab-parallel cross-entropy (``ops/fused_ce.py``) over 2 simulated
  tp shards (two threads whose collectives meet at a barrier) against the
  plain loss, chunked and whole: the loss 1e-6 relative, the gradients of
  the hidden rows and of each shard's head columns 1e-6 relative + 1e-6
  absolute (float32; the sum of exponentials is added in two partial sums
  and the max all-reduced, the plain ``logsumexp`` in one pass, so the
  softmax differs by float32 roundoff, and a hidden row's gradient sums
  32 such terms of either sign: ~8 ulps of its largest element).
- The layouts the port refuses: ``ValueError`` naming the dim, for a world
  or a W or a batch that the mesh does not divide, for nodes that split a
  worker group; NotImplementedError for MoE under fsdp or tp.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.parallel import sharding as jax_sharding
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import init_params, tree_leaves
from nanodiloco_tpu_torch.ops.fused_ce import chunked_softmax_xent, softmax_xent
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.parallel.mesh import WorkerMesh, check_node_layout
from nanodiloco_tpu_torch.parallel.sharding import (
    counted,
    local_box,
    named_leaves,
    param_specs,
    shard,
    spec_of,
)
from nanodiloco_tpu_torch.parallel.tensor import copy_to_tp

CFG = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=32)
CONFIGS = {"untied": CFG, "tied": LlamaConfig(**{**CFG.to_dict(), "tie_word_embeddings": True}),
           "moe": LlamaConfig(**{**CFG.to_dict(), "num_experts": 4})}


@pytest.mark.parametrize("worker_axis", [False, True], ids=["plain", "worker_axis"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_param_specs_match_jax(name, worker_axis):
    cfg = CONFIGS[name]
    want = jax_sharding.param_specs(JaxConfig(**cfg.to_dict()), worker_axis=worker_axis)
    want = jax.tree.map(tuple, want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert param_specs(cfg, worker_axis) == want


def test_init_leaf_hook_keeps_the_draws():
    """``init_params(leaf=...)`` sees every whole leaf by name as it is
    drawn, and the generator's draws do not change."""
    seen = []
    hooked = init_params(torch.Generator().manual_seed(0), CFG, "cpu",
                         leaf=lambda n, t: seen.append(n) or t)
    plain = init_params(torch.Generator().manual_seed(0), CFG, "cpu")
    assert sorted(seen) == [n for n, _ in named_leaves(plain)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(hooked), tree_leaves(plain)))


# (G, fsdp, tp) at W = 2
LAYOUTS = {"tp2": (1, 1, 2), "fsdp2": (1, 2, 1), "fsdp2xtp2": (1, 2, 2), "G2xtp2": (2, 1, 2),
           "tp4": (1, 1, 4)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_shards_tile_the_whole(layout):
    """Every rank's ``shard`` of a [W, ...] tree placed at its box gives the
    whole tree back bit for bit, and each element is written by exactly
    the ranks of the axes its leaf is whole along (and of its worker's
    group)."""
    G, fsdp, tp = LAYOUTS[layout]
    cfg = LlamaConfig(**{**CFG.to_dict(), "num_key_value_heads": 4})
    W = 2
    whole = dict(named_leaves(init_params(torch.Generator().manual_seed(1), cfg, "cpu")))
    stacked = {n: torch.stack([t, t + 1.0]) for n, t in whole.items()}
    tree = {"embed": stacked["embed"], "final_norm": stacked["final_norm"],
            "lm_head": stacked["lm_head"],
            "layers": {n.split("/")[1]: t for n, t in stacked.items() if "/" in n}}
    got = {n: torch.zeros_like(t) for n, t in stacked.items()}
    hits = {n: torch.zeros(t.shape, dtype=torch.int32) for n, t in stacked.items()}
    world = G * fsdp * tp
    for r in range(world):
        mesh = WorkerMesh(W, r, world, True, "gloo", fsdp, tp)
        parts = shard(tree, mesh, worker_axis=True)
        for n, part in named_leaves(parts):
            box = local_box(spec_of(n, worker_axis=True), stacked[n].shape, mesh)
            got[n][box] = part
            hits[n][box] += 1
            assert part.is_contiguous()
    for n in stacked:
        assert torch.equal(got[n], stacked[n]), n
        spec = spec_of(n)
        want = (1 if "fsdp" in spec else fsdp) * (1 if "tp" in spec else tp)
        assert torch.all(hits[n] == want), n
        # a worker group's sums count each distinct piece once
        assert sum(counted(spec, WorkerMesh(W, r, world, True, "gloo", fsdp, tp))
                   for r in range(fsdp * tp)) == fsdp * tp // want


class _ThreadGroup:
    """A tp group of threads: each collective waits for every thread's
    tensor at a barrier and sums (or maxes) them in thread order."""

    def __init__(self, n: int):
        self.n, self.slots, self.barrier = n, [None] * n, threading.Barrier(n, timeout=30)


class _ThreadRank:
    sharded, fsdp = True, 1

    def __init__(self, group: _ThreadGroup, index: int):
        self.group, self.tp, self.tp_index = group, group.n, index

    def all_reduce_(self, x, op="sum", tag="", group="tp"):
        g = self.group
        g.slots[self.tp_index] = x.detach().clone()
        g.barrier.wait()
        out = g.slots[0].clone()
        for part in g.slots[1:]:
            out = out + part if op == "sum" else torch.maximum(out, part)
        g.barrier.wait()
        return x.copy_(out)


@pytest.mark.parametrize("chunk", [8, 0], ids=["chunked", "whole"])
def test_vocab_parallel_xent_matches_plain(chunk):
    rng = np.random.default_rng(0)
    W, N, d, V, tp = 2, 21, 16, 32, 2
    hidden = torch.tensor(rng.standard_normal((W, N, d)), dtype=torch.float32)
    head = torch.tensor(rng.standard_normal((d, V)) * 0.5, dtype=torch.float32)
    targets = torch.tensor(rng.integers(0, V, (W, N)))
    weights = torch.tensor(rng.integers(0, 2, (W, N)), dtype=torch.float32)

    h, w = hidden.clone().requires_grad_(True), head.clone().requires_grad_(True)
    want, _ = chunked_softmax_xent(h, w, targets, weights, chunk=chunk or N)
    want.sum().backward()

    group, results, errors = _ThreadGroup(tp), [None] * tp, []

    def rank(t):
        try:
            mesh = _ThreadRank(group, t)
            h_t = hidden.clone().requires_grad_(True)
            w_t = head[:, t * V // tp:(t + 1) * V // tp].clone().requires_grad_(True)
            rows = copy_to_tp(h_t, mesh)
            if chunk:
                loss, _ = chunked_softmax_xent(rows, w_t, targets, weights, chunk=chunk,
                                               mesh=mesh)
            else:
                nll = softmax_xent(torch.matmul(rows, w_t).float(), targets, mesh)
                loss = (nll * weights).sum(dim=-1)
            loss.sum().backward()
            results[t] = (loss.detach(), h_t.grad, w_t.grad)
        except BaseException as e:  # surfaced below; a dead thread breaks the barrier
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=rank, args=(t,)) for t in range(tp)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not errors, errors
    for t, (loss, h_grad, w_grad) in enumerate(results):
        np.testing.assert_allclose(loss.numpy(), want.detach().numpy(), rtol=1e-6)
        np.testing.assert_allclose(h_grad.numpy(), h.grad.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(w_grad.numpy(),
                                   w.grad[:, t * V // tp:(t + 1) * V // tp].numpy(),
                                   rtol=1e-6, atol=1e-6)


def _cfg(**kw):
    return LlamaConfig(**{**CFG.to_dict(), **kw})


# what the port refuses, and a fragment of each message (the dim it names)
REFUSED = {
    "heads": (lambda: Diloco(_cfg(num_attention_heads=2, num_key_value_heads=1,
                                   hidden_size=64), DilocoConfig(num_workers=2), "cpu",
                             WorkerMesh(2, 0, 4, True, "gloo", 1, 4)),
              ValueError, "num_attention_heads=2 is not a multiple of tp=4"),
    "kv_heads": (lambda: Diloco(CFG, DilocoConfig(num_workers=2), "cpu",
                                WorkerMesh(2, 0, 4, True, "gloo", 1, 4)),
                 ValueError, "num_key_value_heads=2 is not a multiple of tp=4"),
    "intermediate": (lambda: Diloco(_cfg(intermediate_size=65), DilocoConfig(num_workers=2),
                                    "cpu", WorkerMesh(2, 0, 4, True, "gloo", 2, 2)),
                     ValueError, "intermediate_size=65 is not a multiple of tp=2"),
    "vocab_tp": (lambda: Diloco(_cfg(vocab_size=65), DilocoConfig(num_workers=2), "cpu",
                                WorkerMesh(2, 0, 2, True, "gloo", 1, 2)),
                 ValueError, "lm_head's columns"),
    "hidden_fsdp": (lambda: Diloco(_cfg(hidden_size=42, num_attention_heads=3,
                                        num_key_value_heads=1),
                                   DilocoConfig(num_workers=2), "cpu",
                                   WorkerMesh(2, 0, 4, True, "gloo", 4, 1)),
                    ValueError, "hidden_size=42 is not a multiple of fsdp=4"),
    "vocab_fsdp": (lambda: Diloco(_cfg(vocab_size=66, tie_word_embeddings=True),
                                  DilocoConfig(num_workers=2), "cpu",
                                  WorkerMesh(2, 0, 4, True, "gloo", 4, 1)),
                   ValueError, "the embedding's rows"),
    "world": (lambda: WorkerMesh(2, 0, 4, True, "gloo", 3, 1), ValueError,
              "world size 4 is not a multiple of fsdp * tp"),
    "workers": (lambda: WorkerMesh(3, 0, 4, True, "gloo", 1, 2), ValueError,
                "num_workers=3 is not a multiple of the 2 worker groups"),
    "batch": (lambda: WorkerMesh(2, 0, 4, True, "gloo", 2, 2).check_batch(3), ValueError,
              "per_device_batch_size=3 is not a multiple of fsdp=2"),
    "moe": (lambda: Diloco(_cfg(num_experts=4), DilocoConfig(num_workers=2), "cpu",
                           WorkerMesh(2, 0, 2, True, "gloo", 1, 2)),
            NotImplementedError, "Queue A item 7e"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_layouts(case):
    make, exc, fragment = REFUSED[case]
    with pytest.raises(exc, match=fragment.replace("*", r"\*").replace("(", r"\(")):
        make()


@pytest.mark.parametrize("local,world,fsdp,tp,slices,ok", [
    (None, 4, 2, 2, 1, True),          # no torchrun nodes: one node
    (None, 4, 2, 2, 2, False),         # slices without torchrun's LOCAL_WORLD_SIZE
    ("4", 8, 2, 2, 2, True),           # two nodes of one worker group each
    ("4", 8, 2, 2, 1, False),          # two nodes, one slice declared
    ("2", 8, 2, 2, 4, False),          # a worker group across nodes
])
def test_dcn_slices_map_worker_groups_to_nodes(monkeypatch, local, world, fsdp, tp, slices,
                                               ok):
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    if ok:
        check_node_layout(world, fsdp, tp, slices)
    else:
        with pytest.raises(ValueError, match="dcn-slices|whole worker groups"):
            check_node_layout(world, fsdp, tp, slices)
