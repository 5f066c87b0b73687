"""The port's outer wires (nanodiloco_tpu_torch.parallel.diloco: the float
cast, the per-worker absmax integer quantizer, the integer wire with one
shared scale, and their byte accounting) against the JAX package's, on
the CPU, from numpy-seeded inputs. Mirrors tests/test_diloco.py's wire
tests (the bf16 and int8 hand math, bounded error, masked NaN workers,
the integer wire, int4, the payload report).

Tolerances:
- the quantizer on identical inputs: bit for bit (integers, scales and
  the dequantized values). Both divide in float32, round half to even
  and clip at q_max; the integer wire's sum is exact.
- the pseudo-gradient on identical inputs: bit for bit under the integer
  wire; otherwise 1e-6 relative plus 4 float32 ulps of the snapshot's
  largest element absolute: where the JAX package contracts a weight
  vector with ``snapshot - p_w`` the port may take ``snapshot -
  mean_w(p_w)`` (uniform weights), the same sum rounded in another order,
  whose roundoff is in units of the snapshot's magnitude.
- whole rounds under a lossy wire: the deltas entering the quantizer
  already differ at float32 roundoff (the inner steps' summation order),
  so an element near a bin edge may land one bin off, moving the
  snapshot by up to outer_lr * (1 + momentum) * scale; the tolerance is
  that plus the classic path's 1e-4 relative + 5e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.parallel import Diloco as JaxDiloco
from nanodiloco_tpu.parallel import DilocoConfig as JaxDilocoConfig
from nanodiloco_tpu.parallel import MeshConfig, build_mesh
from nanodiloco_tpu.parallel import diloco as jax_diloco_mod
from nanodiloco_tpu.parallel.streaming import StreamingConfig as JaxStreamingConfig
from nanodiloco_tpu.parallel.streaming import StreamingDiloco as JaxStreamingDiloco
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy, params_to_numpy, tree_leaves
from nanodiloco_tpu_torch.parallel import diloco as port_diloco_mod
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig, DilocoState
from nanodiloco_tpu_torch.parallel.streaming import StreamingConfig, StreamingDiloco
from nanodiloco_tpu_torch.training.optim import inner_optimizer
from test_torch_diloco import CFG, numpy_params

TINY = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                   num_attention_heads=4, num_hidden_layers=2, max_position_embeddings=32)
JTINY = JaxConfig(**TINY.to_dict())


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on one machine; one
    torch thread per worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_dl(W, **kw):
    return JaxDiloco(JTINY, JaxDilocoConfig(num_workers=W, **kw),
                     build_mesh(MeshConfig(diloco=W)))


def port_dl(W, **kw):
    return Diloco(TINY, DilocoConfig(num_workers=W, **kw), device="cpu")


def deltas(W=4, seed=0, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((W, 16, 8)) * scale).astype(np.float32)


def snapshot_and_workers(W=4, seed=1, spread=0.1):
    """{"w": [16], "b": [4, 4]} snapshots and [W, ...] replicas near them."""
    rng = np.random.default_rng(seed)
    snap = {"w": rng.standard_normal(16).astype(np.float32),
            "b": (rng.standard_normal((4, 4)) * 5.0).astype(np.float32)}
    workers = {k: (v[None] + rng.standard_normal((W,) + v.shape) * spread).astype(np.float32)
               for k, v in snap.items()}
    return snap, workers


def port_pseudograd(dl, snap, workers, mask=None):
    weights = None if mask is None else [float(m) for m in mask]
    return {k: dl._pseudograd_of(torch.from_numpy(snap[k]), torch.from_numpy(workers[k]),
                                 weights).numpy()
            for k in snap}


def jax_pseudograd(dl, snap, workers, mask=None):
    m = None if mask is None else jnp.asarray(mask, jnp.float32)
    out = dl._pseudograd(jax.tree.map(jnp.asarray, snap), jax.tree.map(jnp.asarray, workers), m)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("wire", ["int8", "int4", "int16", "bfloat16", "float16"])
def test_wire_quantize_bit_identical_to_jax(wire):
    """Identical [W, ...] deltas through both quantizers: the dequantized
    values bit for bit; on an integer wire also the integers (half to
    even, clipped at q_max) and the per-(worker, tensor) scales."""
    d = deltas()
    dl = port_dl(4, outer_comm_dtype=wire)
    want = np.asarray(jax_dl(4, outer_comm_dtype=wire)._wire_quantize(jnp.asarray(d)))
    got = dl._wire_quantize(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)
    if wire.startswith("int"):
        q_max = port_diloco_mod.INT_WIRES[wire][0]
        q, scale = dl.quantize_wire(torch.from_numpy(d))
        want_scale = np.maximum(np.abs(d).max(axis=(1, 2), keepdims=True) / np.float32(q_max),
                                np.finfo(np.float32).tiny)
        np.testing.assert_array_equal(scale.numpy(), want_scale)
        np.testing.assert_array_equal(
            q.numpy(), np.clip(np.round(d / want_scale), -q_max, q_max).astype(q.numpy().dtype))
        assert q.dtype == port_diloco_mod.INT_WIRES[wire][1] and q.abs().max() <= q_max
        np.testing.assert_array_equal(q.float().numpy() * scale.numpy(), want)


def test_int8_wire_bounded_error_and_garbage_rejected():
    d = deltas()
    dl = port_dl(4, outer_comm_dtype="int8")
    q = dl._wire_quantize(torch.from_numpy(d)).numpy()
    scale = np.abs(d).max(axis=(1, 2), keepdims=True) / 127.0
    assert (np.abs(q - d) <= scale / 2 + 1e-7).all()
    with pytest.raises(ValueError, match="float .* or signed-int"):
        port_dl(2, outer_comm_dtype="uint8")


@pytest.mark.parametrize("wire,collective", [
    (None, False), ("bfloat16", False), ("int8", False), ("int4", False),
    ("int8", True), ("int4", True),
])
@pytest.mark.parametrize("mask", [None, (1, 1, 0, 1)], ids=["unmasked", "worker-2-masked"])
def test_pseudograd_matches_jax(wire, collective, mask):
    """The pseudo-gradient of identical replicas, each wire, unmasked and
    with worker 2 masked out. A masked worker holding NaN changes nothing
    (a hard ``where``, never 0 * NaN), under per-worker scales and under
    the shared scale."""
    snap, workers = snapshot_and_workers()
    kw = dict(outer_comm_dtype=wire, outer_wire_collective=collective)
    dl, jdl = port_dl(4, **kw), jax_dl(4, **kw)
    got = port_pseudograd(dl, snap, workers, mask)
    want = jax_pseudograd(jdl, snap, workers, mask)
    for k in snap:
        if collective:
            np.testing.assert_array_equal(got[k], want[k])
        else:
            ulps = 4 * np.finfo(np.float32).eps * np.abs(snap[k]).max()
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=ulps)
    if mask is not None and 0 in mask:
        poisoned = {k: v.copy() for k, v in workers.items()}
        for v in poisoned.values():
            v[2] = np.nan
        nan_got = port_pseudograd(dl, snap, poisoned, mask)
        for k in snap:
            np.testing.assert_array_equal(nan_got[k], got[k])
            assert np.isfinite(nan_got[k]).all()


@pytest.mark.parametrize("wire,collective", [
    (None, False), ("bfloat16", False), ("int8", False), ("int4", True), ("int16", True),
])
def test_all_ones_mask_is_the_unmasked_mean(wire, collective):
    """An all-true mask (quarantine with every replica finite) and equal
    weights (uniform budgets; never with the integer wire, which refuses
    heterogeneous H) give the unmasked pseudo-gradient bit for bit."""
    snap, workers = snapshot_and_workers()
    dl = port_dl(4, outer_comm_dtype=wire, outer_wire_collective=collective)
    plain = port_pseudograd(dl, snap, workers)
    for mask in ((1, 1, 1, 1),) + (() if collective else ((3, 3, 3, 3),)):
        got = port_pseudograd(dl, snap, workers, mask)
        for k in snap:
            np.testing.assert_array_equal(got[k], plain[k])


@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_integer_wire_error_bounded_by_shared_scale(wire):
    """The shared scale is the survivors' absmax / q_max: each element of
    the mean is within one scale of the exact float32 mean."""
    snap, workers = snapshot_and_workers()
    q_max = port_diloco_mod.INT_WIRES[wire][0]
    got = port_pseudograd(port_dl(4, outer_comm_dtype=wire, outer_wire_collective=True),
                          snap, workers)
    for k in snap:
        exact = snap[k] - workers[k].mean(axis=0)
        scale = np.abs(snap[k][None] - workers[k]).max() / q_max
        assert (np.abs(got[k] - exact) <= scale + 1e-7).all(), k


@pytest.mark.parametrize("W", [2, 4, 18, 19, 300])
@pytest.mark.parametrize("wire", ["int4", "int8", "int16"])
def test_accumulator_dtype_matches_jax(W, wire):
    q_max = float(port_diloco_mod.INT_WIRES[wire][0])
    ours = port_diloco_mod._wire_accumulator_dtype(W, q_max)
    want = jnp.dtype(jax_diloco_mod._wire_accumulator_dtype(W, q_max))
    assert str(ours).removeprefix("torch.") == want.name


def toy_state(dl, snapshot, workers):
    """A port state over a toy tree (the JAX tests' custom-loss states)."""
    snap = {k: torch.tensor(v) for k, v in snapshot.items()}
    params = {k: torch.tensor(v).requires_grad_(True) for k, v in workers.items()}
    return DilocoState(params=params, inner_opt=inner_optimizer(tree_leaves(params)),
                       snapshot=snap, outer_opt_state={k: torch.zeros_like(v)
                                                       for k, v in snap.items()})


def test_outer_comm_dtype_bf16_hand_math():
    """bf16 rounds 1 +- 2^-10 to exactly 1 and keeps +-2^-10: the outer
    update is the hand math on the rounded deltas (the cast happens per
    worker, before the mean)."""
    eps = 2.0 ** -10
    dl = port_dl(2, outer_comm_dtype="bfloat16")
    state = toy_state(dl, {"w": np.array([2.0, 1.0], np.float32)},
                      {"w": np.array([[1 - eps, 1 - eps], [1 + eps, 1 + eps]], np.float32)})
    dl.outer_step(state)
    expect = np.array([2.0, 1.0]) - 0.7 * 1.9 * np.array([1.0, 0.0])
    np.testing.assert_allclose(state.snapshot["w"].numpy(), expect, rtol=1e-6)


def test_outer_comm_dtype_int8_hand_math():
    """absmax 1.27 -> scale 0.01: 1.27 is q = 127 exactly, 0.004 rounds
    away."""
    dl = port_dl(2, outer_comm_dtype="int8")
    state = toy_state(dl, {"w": np.array([2.27, 1.004], np.float32)},
                      {"w": np.ones((2, 2), np.float32)})
    dl.outer_step(state)
    expect = np.array([2.27, 1.004]) - 0.7 * 1.9 * np.array([1.27, 0.0])
    np.testing.assert_allclose(state.snapshot["w"].numpy(), expect, rtol=1e-5)


def test_integer_wire_outer_step_within_tolerance_of_default():
    """The shared-scale wire's outer step against the per-worker int8 one:
    within outer_lr * (1 + momentum) * 2 * scale per element."""
    rng = np.random.default_rng(1)
    snap = {"w": rng.standard_normal(32).astype(np.float32)}
    workers = {"w": (snap["w"][None] + rng.standard_normal((4, 32)) * 0.05).astype(np.float32)}
    out = {}
    for collective in (True, False):
        dl = port_dl(4, outer_comm_dtype="int8", outer_wire_collective=collective)
        state = toy_state(dl, snap, workers)
        out[collective] = dl.outer_step(state)[0].snapshot["w"].numpy()
    scale = np.abs(snap["w"][None] - workers["w"]).max() / 127.0
    assert (np.abs(out[True] - out[False]) <= 0.7 * 1.9 * 2 * scale + 1e-7).all()


def test_integer_wire_and_hetero_refusals():
    for bad in (None, "bfloat16", "float32"):
        with pytest.raises(ValueError, match="outer_wire_collective requires"):
            port_dl(2, outer_comm_dtype=bad, outer_wire_collective=True)
    with pytest.raises(ValueError, match="not narrow"):
        port_dl(2, outer_comm_dtype="int32", outer_wire_collective=True)


MODES = [dict(), dict(outer_comm_dtype="bfloat16"), dict(outer_comm_dtype="int8"),
         dict(outer_comm_dtype="int8", outer_wire_collective=True),
         dict(outer_comm_dtype="int4", outer_wire_collective=True),
         dict(outer_comm_dtype="int16", outer_wire_collective=True)]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(map(str, m.values())) or "f32")
def test_byte_accounting_matches_jax(mode):
    """``sync_payload_report``'s bytes and guarantee, and the per-round
    ``sync_wire_bytes`` ledger, from the config and from an actual tree,
    equal the JAX package's (int8 payload -> s16 sum, int4 at W=4 -> s8)."""
    dl, jdl = port_dl(4, **mode), jax_dl(4, **mode)
    ours, want = dl.sync_payload_report(), jdl.sync_payload_report()
    for k in ("bytes_per_sync", "guaranteed", "f32_bytes"):
        assert ours[k] == want[k], k
    tree = numpy_params(TINY)
    assert dl.sync_wire_bytes() == jdl.sync_wire_bytes()
    assert (dl.sync_wire_bytes(params_from_numpy(tree, device="cpu"))
            == jdl.sync_wire_bytes(jax.tree.map(jnp.asarray, tree)))


def test_streaming_payload_report_is_per_fragment():
    kw = dict(num_workers=4, inner_steps=4, outer_comm_dtype="int4",
              outer_wire_collective=True)
    ours = StreamingDiloco(TINY, DilocoConfig(**kw), StreamingConfig(num_fragments=2),
                           device="cpu").sync_payload_report()
    want = JaxStreamingDiloco(JTINY, JaxDilocoConfig(**kw), build_mesh(MeshConfig(diloco=4)),
                              JaxStreamingConfig(num_fragments=2)).sync_payload_report()
    assert ours["bytes_per_sync"] == want["bytes_per_sync"] == TINY.num_params() // 2
    assert ours["guaranteed"] and "fragment" in ours["wire"]


W, H, A, B, S = 2, 2, 2, 2, 16


@pytest.fixture(scope="module")
def lossy_rounds():
    """Two rounds of the module's model under the int4 integer wire (the
    coarsest), on both sides, from one numpy tree and one token stream."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, CFG.vocab_size, (2, H, W, A, B, S)).astype(np.int32)
    mask = np.ones_like(tokens)
    tree = numpy_params(CFG)
    common = dict(num_workers=W, inner_steps=H, warmup_steps=1, total_steps=8, lr=1e-2,
                  grad_accum=A)
    out = {}
    for wire, collective in (("int4", True),):
        kw = dict(common, outer_comm_dtype=wire, outer_wire_collective=collective)
        jdl = JaxDiloco(JaxConfig(**CFG.to_dict()), JaxDilocoConfig(**kw),
                        build_mesh(MeshConfig(diloco=W)))
        dl = Diloco(CFG, DilocoConfig(**kw), device="cpu")
        state = dl.init_state(params=params_from_numpy(tree, device="cpu"))
        scales, jl, pl = [], [], []
        with jax.default_matmul_precision("highest"):
            jstate = jdl.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, tree))
            for r in range(2):
                jstate, jloss, _ = jdl.round_step(jstate, tokens[r], mask[r])
                state, loss = dl.inner_round(state, tokens[r], mask[r])
                # the largest scale of the replicas about to be quantized
                q_max = port_diloco_mod.INT_WIRES[wire][0]
                scales.append(max(
                    float((s[None] - p.detach()).abs().max()) / q_max
                    for s, p in zip(tree_leaves(state.snapshot), tree_leaves(state.params))))
                dl.outer_step(state)
                jl.append(np.asarray(jloss))
                pl.append(loss.numpy())
        out[wire] = (np.stack(pl), np.stack(jl), params_to_numpy(state.snapshot),
                     jax.tree.map(np.asarray, jstate.snapshot), scales)
    return out


@pytest.mark.parametrize("wire", ["int4"])
def test_lossy_wire_rounds_match_jax(lossy_rounds, wire):
    pl, jl, snap, jsnap, scales = lossy_rounds[wire]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    # the quantized sums land one bin off at most; the scale is measured
    # on the replicas about to be quantized
    bin_tol = 0.7 * 1.9 * max(scales)
    for a, b in zip(jax.tree.leaves(snap), jax.tree.leaves(jsnap)):
        assert (np.abs(a - b) <= 5e-5 + 1e-4 * np.abs(b) + bin_tol).all()


def test_int4_wire_trains():
    """Rounds under the one-byte wire on a learnable task (each row counts
    up from a random start): the loss comes down."""
    dl = Diloco(TINY, DilocoConfig(num_workers=2, inner_steps=4, warmup_steps=4,
                                   total_steps=200, lr=3e-3, outer_comm_dtype="int4",
                                   outer_wire_collective=True), device="cpu")
    state = dl.init_state(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    means = []
    for _ in range(6):
        start = rng.integers(0, TINY.vocab_size, (4, 2, 1, 2, 1))
        tok = (start + np.arange(16)) % TINY.vocab_size
        state, losses, _ = dl.round_step(state, tok, np.ones_like(tok))
        means.append(float(losses.mean()))
    assert np.isfinite(means[-1]) and means[-1] < means[0] - 0.3, means


def test_offload_snapshot_is_the_identity_on_the_cpu():
    """On the CPU the snapshot already lives on the host: offloaded rounds
    are the device-resident rounds bit for bit."""
    rng = np.random.default_rng(2)
    tok = rng.integers(0, TINY.vocab_size, (2, 2, 1, 2, 16))
    runs = []
    for offload in (False, True):
        dl = port_dl(2, inner_steps=2, warmup_steps=2, total_steps=50, lr=1e-3,
                     offload_snapshot=offload)
        state = dl.init_state(torch.Generator().manual_seed(0))
        losses = [dl.round_step(state, tok, np.ones_like(tok))[1] for _ in range(3)]
        runs.append((torch.stack(losses), tree_leaves(state.snapshot)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
