"""Streaming DiLoCo in the port (nanodiloco_tpu_torch.parallel.streaming)
against the JAX package's, on the CPU from numpy-seeded inputs: fragment
partitioning, the stagger cadence, classic equivalence at (P=1, delay 0,
alpha 1), multi-fragment merges, and train()'s streaming runs with
checkpoints. Mirrors tests/test_streaming.py.

Tolerances: three rounds at P=2, delay 1, alpha 0.5 against JAX, the
classic path's 1e-5 on losses and 1e-4 relative + 5e-5 absolute on the
snapshot and the pending fragments (tests/test_torch_diloco.py); the
blend 1e-6 absolute (three float32 operations on values near 1). Within
the port, bit for bit: P=1, delay 0, alpha 1 against classic (under the
quantized and integer wires too), and a resumed streaming run against the
uninterrupted one.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.parallel import DilocoConfig as JaxDilocoConfig
from nanodiloco_tpu.parallel import MeshConfig, build_mesh
from nanodiloco_tpu.parallel import streaming as jax_streaming
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import (
    init_params,
    params_from_numpy,
    params_to_numpy,
    tree_leaves,
    tree_map,
)
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.parallel.streaming import (
    StreamingConfig,
    StreamingDiloco,
    fragment_bounds,
    fragment_slice,
    fragment_write,
)
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train
from test_torch_diloco import CFG, numpy_params

FOUR = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                   num_attention_heads=4, num_hidden_layers=4, max_position_embeddings=32)
SMALL = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                    num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                    max_position_embeddings=64, attention_impl="flash", loss_chunk=16)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on one machine; one
    torch thread per worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def steps(n, W, seed=1, vocab=64):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, vocab, (n, W, 1, 2, 8))
    return tok, np.ones_like(tok)


def leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("L,P", [(4, 1), (4, 2), (6, 4), (7, 3)])
def test_fragment_bounds_match_jax(L, P):
    b = fragment_bounds(L, P)
    assert b == jax_streaming.fragment_bounds(L, P)
    assert b[0][0] == 0 and b[-1][1] == L
    assert all(ahi == blo and ahi > alo for (alo, ahi), (blo, _) in zip(b, b[1:]))


def test_fragment_bounds_reject_more_fragments_than_layers():
    with pytest.raises(ValueError):
        fragment_bounds(2, 3)


def test_fragment_slice_write_roundtrip():
    params = init_params(torch.Generator().manual_seed(0), FOUR, device="cpu")
    bounds = fragment_bounds(FOUR.num_hidden_layers, 2)
    rebuilt = tree_map(torch.zeros_like, params)
    for p in range(2):
        fragment_write(rebuilt, fragment_slice(params, p, bounds, stacked=False), p, bounds,
                       stacked=False)
    assert leaves_equal(rebuilt, params)
    f0, f1 = (fragment_slice(params, p, bounds, stacked=False) for p in range(2))
    assert "embed" in f0 and "embed" not in f1
    assert "final_norm" in f1 and "final_norm" not in f0
    assert f0["layers"]["wq"].shape[0] + f1["layers"]["wq"].shape[0] == 4
    # views: a write through a fragment reaches the full tree
    f0["layers"]["wq"].zero_()
    assert not params["layers"]["wq"][:2].any() and params["layers"]["wq"][2:].any()


def test_stagger_cadence_matches_jax():
    """H=4, P=2, delay 1: fragment 0 launches at t % 4 == 2, fragment 1 at
    the classic sync point; applies land one step later."""
    cfg = dict(num_workers=2, inner_steps=4)
    sd = StreamingDiloco(FOUR, DilocoConfig(**cfg), StreamingConfig(num_fragments=2, delay=1),
                         device="cpu")
    jsd = jax_streaming.StreamingDiloco(JaxConfig(**FOUR.to_dict()), JaxDilocoConfig(**cfg),
                                        build_mesh(MeshConfig(diloco=2)),
                                        jax_streaming.StreamingConfig(num_fragments=2, delay=1))
    assert [sd.due(t) for t in range(1, 13)] == [jsd.due(t) for t in range(1, 13)]
    assert sd.due(2) == ((0,), ()) and sd.due(3) == ((), (0,)) and sd.due(5) == ((), (1,))
    sd0 = StreamingDiloco(FOUR, DilocoConfig(**cfg), StreamingConfig(num_fragments=1, delay=0),
                          device="cpu")
    assert sd0.due(4) == ((0,), (0,)) and sd0.due(3) == ((), ())


@pytest.mark.parametrize("wire,collective", [
    (None, False), ("int8", False), ("int8", True), ("int4", True),
])
def test_p1_delay0_equals_classic_bitwise(wire, collective):
    """One fragment, delay 0, alpha 1: classic DiLoCo exactly, under the
    quantized wires too (a fragment launch is the classic outer step)."""
    W, H = 4, 2
    cfg = DilocoConfig(num_workers=W, inner_steps=H, warmup_steps=2, total_steps=20, lr=1e-3,
                       outer_comm_dtype=wire, outer_wire_collective=collective)
    params = init_params(torch.Generator().manual_seed(0), FOUR, device="cpu")
    tok, mask = steps(2 * H, W)
    classic = Diloco(FOUR, cfg, device="cpu")
    cs = classic.init_state(params=params)
    for t in range(2 * H):
        _, closs = classic.inner_step(cs, tok[t], mask[t])
        if (t + 1) % H == 0:
            classic.outer_step(cs)
    stream = StreamingDiloco(FOUR, cfg, StreamingConfig(num_fragments=1, delay=0),
                             device="cpu")
    ss = stream.init_state(params=params)
    for t in range(2 * H):
        _, sloss = stream.step(ss, tok[t], mask[t], t + 1)
    assert torch.equal(sloss, closs)
    assert leaves_equal(ss.snapshot, cs.snapshot) and leaves_equal(ss.params, cs.params)


def test_two_fragments_merge_on_their_stagger():
    """P=2, delay 1: fragment 0 launches at t=2 and applies at t=3 (its
    snapshot moves, fragment 1's does not); fragment 1 follows at 4/5."""
    W, H = 4, 4
    sd = StreamingDiloco(FOUR, DilocoConfig(num_workers=W, inner_steps=H, warmup_steps=1,
                                            total_steps=40, lr=1e-2),
                         StreamingConfig(num_fragments=2, delay=1), device="cpu")
    state = sd.init_state(torch.Generator().manual_seed(0))
    snap0 = tree_map(torch.clone, state.snapshot)
    tok, mask = steps(5, W, seed=100)
    for t in range(1, 4):
        _, loss = sd.step(state, tok[t - 1], mask[t - 1], t)
    assert torch.isfinite(loss).all()
    frag = lambda tree, p: fragment_slice(tree, p, sd.bounds, stacked=False)  # noqa: E731
    assert not leaves_equal(frag(state.snapshot, 0), frag(snap0, 0))
    assert leaves_equal(frag(state.snapshot, 1), frag(snap0, 1))
    for t in range(4, 6):
        sd.step(state, tok[t - 1], mask[t - 1], t)
    assert not leaves_equal(frag(state.snapshot, 1), frag(snap0, 1))


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_merge_alpha_blends(alpha):
    """At the apply every worker becomes alpha * global + (1 - alpha) *
    local, and the fragment's snapshot the merged value exactly."""
    sd = StreamingDiloco(FOUR, DilocoConfig(num_workers=2, inner_steps=2, warmup_steps=1,
                                            total_steps=20, lr=1e-2),
                         StreamingConfig(num_fragments=1, delay=1, merge_alpha=alpha),
                         device="cpu")
    state = sd.init_state(torch.Generator().manual_seed(0))
    tok, mask = steps(2, 2, seed=10)
    for t in (1, 2):  # t=2 launches fragment 0
        sd.step(state, tok[t - 1], mask[t - 1], t)
    # copies: the apply writes the live tensors in place
    local = jax.tree.map(np.copy, params_to_numpy(state.params))
    pending = jax.tree.map(np.copy, params_to_numpy(state.pending[0]))
    sd._apply_fragment(state, 0)
    for g, w, got in zip(jax.tree.leaves(pending), jax.tree.leaves(local),
                         jax.tree.leaves(params_to_numpy(state.params))):
        np.testing.assert_allclose(got, alpha * g[None] + (1 - alpha) * w, atol=1e-6)
    assert leaves_equal(state.snapshot, state.pending[0])


@pytest.fixture(scope="module")
def two_fragment_rounds():
    """Three rounds at P=2, delay 1, alpha 0.5 (the module's 2-layer CFG,
    W=2, H=2) on both sides from one numpy tree."""
    W, H, R = 2, 2, 3
    rng = np.random.default_rng(6)
    tok = rng.integers(0, CFG.vocab_size, (R, H, W, 1, 2, 16)).astype(np.int32)
    mask = np.ones_like(tok)
    tree = numpy_params(CFG)
    kw = dict(num_workers=W, inner_steps=H, warmup_steps=1, total_steps=8, lr=1e-2)
    jsd = jax_streaming.StreamingDiloco(
        JaxConfig(**CFG.to_dict()), JaxDilocoConfig(**kw), build_mesh(MeshConfig(diloco=W)),
        jax_streaming.StreamingConfig(num_fragments=2, delay=1, merge_alpha=0.5))
    sd = StreamingDiloco(CFG, DilocoConfig(**kw),
                         StreamingConfig(num_fragments=2, delay=1, merge_alpha=0.5), device="cpu")
    state = sd.init_state(params=params_from_numpy(tree, device="cpu"))
    jl, pl = [], []
    with jax.default_matmul_precision("highest"):
        js = jsd.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, tree))
        for r in range(R):
            js, jloss, _ = jsd.round_step(js, tok[r], mask[r])
            _, ploss, _ = sd.round_step(state, tok[r], mask[r])
            jl.append(np.asarray(jloss))
            pl.append(ploss.numpy())
    return np.stack(pl), np.stack(jl), state, js


def test_two_fragments_match_jax(two_fragment_rounds):
    pl, jl, state, js = two_fragment_rounds
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert state.inner_step_count == int(js.inner_step_count) == 6
    pairs = [(params_to_numpy(state.snapshot), js.snapshot)]
    pairs += [(params_to_numpy(p), jp) for p, jp in zip(state.pending, js.pending)]
    for ours, want in pairs:
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5)


def small_run(tmp_path, **kw):
    base = dict(seed=1337, batch_size=4, per_device_batch_size=2, seq_length=32,
                warmup_steps=2, total_steps=12, inner_steps=4, lr=1e-3, num_workers=2,
                model=SMALL, log_dir=str(tmp_path / "runs"), quiet=True,
                streaming_fragments=2, streaming_delay=1, merge_alpha=0.5)
    return TrainConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def stream_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    summary = train(small_run(d, run_name="s", checkpoint_dir=str(d / "ck")), device="cpu")
    return d, summary


def test_train_streaming_records(stream_run):
    """Sync records carry the stagger as outer_staleness (delay / H
    rounds) and the wire keys; no dynamics (no whole-model sync point)."""
    d, summary = stream_run
    recs = [json.loads(line) for line in open(d / "runs" / "s.jsonl")]
    syncs = [r for r in recs if r.get("outer_synced")]
    assert [r["step"] for r in syncs] == [4, 8, 12]
    assert all(r["outer_staleness"] == 0.25 and "wire_bytes_per_sync" in r
               and "drift_max" not in r for r in syncs)
    assert np.isfinite(summary["final_loss"]) and all(summary["snapshot_changed"])


def test_train_streaming_resume_bit_exact(stream_run, tmp_path):
    """A resume from the round-1 checkpoint (per-fragment momentum and
    pending merges restored) equals the uninterrupted run; the same
    checkpoint restores elastically into one worker with the fragments'
    global state exact."""
    d, full = stream_run
    ck = tmp_path / "ck"
    shutil.copytree(d / "ck", ck)
    for step in (8, 12):
        os.remove(ck / f"step_{step}.pt")
    resumed = train(small_run(tmp_path, checkpoint_dir=str(ck), run_name="r"), device="cpu")
    assert resumed["rounds"] == 2 and resumed["losses"] == full["losses"][4:]
    assert leaves_equal(resumed["state"].params, full["state"].params)
    assert leaves_equal(resumed["state"].snapshot, full["state"].snapshot)

    mgr = CheckpointManager(str(d / "ck"))
    saved = mgr.restore_raw(only={"outer_opt_states", "pending"})
    one = StreamingDiloco(SMALL, DilocoConfig(num_workers=1, inner_steps=4),
                          StreamingConfig(num_fragments=2), device="cpu")
    restored = mgr.restore_elastic(one.init_state(torch.Generator().manual_seed(3)))
    assert leaves_equal(restored.snapshot, full["state"].snapshot)
    for live, sv in zip(restored.pending, saved["pending"]):
        assert leaves_equal(live, sv)
    for live, sv in zip(restored.outer_opt_states, saved["outer_opt_states"]):
        assert all(torch.equal(b, sv[n]["momentum_buffer"])
                   for n, b in zip(sorted(sv), tree_leaves(live)))


def test_streaming_rejects_offload_and_hetero(tmp_path):
    with pytest.raises(ValueError, match="classic-DiLoCo-only"):
        StreamingDiloco(FOUR, DilocoConfig(num_workers=2, inner_steps=4, offload_snapshot=True),
                        StreamingConfig(num_fragments=2, delay=1), device="cpu")
    with pytest.raises(ValueError, match="classic-rounds-only"):
        train(small_run(tmp_path, inner_steps_per_worker=(4, 2)), device="cpu")
