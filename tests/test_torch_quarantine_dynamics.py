"""Divergence quarantine and the dynamics readout of the port
(nanodiloco_tpu_torch.parallel.diloco) against the JAX package's, on the
CPU, from numpy-seeded inputs: the masked outer mean, the self-healing
quarantine (replica finiteness, moments zeroed, counts kept), and the
per-sync dynamics (pg_norm, drift_max, drift_mean, outer_momentum_norm,
outer_update_cos). Mirrors tests/test_diloco.py's mask and quarantine
tests.

Tolerances: the outer step on identical toy states, 1e-6 relative plus 4
float32 ulps of the snapshot (another summation order of the same sum,
see tests/test_torch_wire.py); whole rounds, the classic path's 1e-5 on
losses and 1e-4 relative + 5e-5 absolute on the snapshot
(tests/test_torch_diloco.py); the dynamics 1e-4 relative (float32 sums
over replicas that already differ at roundoff; the port sums each pair's
squared distance from its difference where JAX reads it off the
deviation gram, the same number in exact arithmetic).
Within the port the readout is a pure function of the sync's values:
losses and params with it on equal those with it off, bit for bit.
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
from nanodiloco_tpu.parallel.diloco import DilocoState as JaxDilocoState
from nanodiloco_tpu_torch.models.llama import params_from_numpy, params_to_numpy, tree_leaves
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig, DilocoState
from nanodiloco_tpu_torch.parallel.streaming import StreamingConfig, StreamingDiloco
from nanodiloco_tpu_torch.training.optim import inner_optimizer
from test_torch_diloco import CFG, numpy_params

JCFG = JaxConfig(**CFG.to_dict())
W, H, A, B, S = 4, 2, 1, 2, 16
DYN_KEYS = ("pg_norm", "drift_max", "drift_mean", "outer_momentum_norm", "outer_update_cos")


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on one machine; one
    torch thread per worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batches(rounds, seed=3):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, CFG.vocab_size, (rounds, H, W, A, B, S)).astype(np.int32)
    return tok, np.ones_like(tok)


def common(**kw):
    return dict(num_workers=W, inner_steps=H, warmup_steps=1, total_steps=8, lr=1e-2, **kw)


def toy(W=4, seed=1):
    rng = np.random.default_rng(seed)
    snap = {"w": rng.standard_normal(16).astype(np.float32),
            "b": (rng.standard_normal((4, 4)) * 5.0).astype(np.float32)}
    workers = {k: (v[None] + rng.standard_normal((W,) + v.shape) * 0.1).astype(np.float32)
               for k, v in snap.items()}
    return snap, workers


def port_toy_state(snap, workers):
    params = {k: torch.tensor(v).requires_grad_(True) for k, v in workers.items()}
    return DilocoState(params=params, inner_opt=inner_optimizer(tree_leaves(params)),
                       snapshot={k: torch.tensor(v) for k, v in snap.items()},
                       outer_opt_state={k: torch.zeros(v.shape) for k, v in snap.items()})


def jax_toy_state(jdl, snap, workers):
    s = jax.tree.map(jnp.asarray, snap)
    p = jax.tree.map(jnp.asarray, workers)
    return JaxDilocoState(params=p, inner_opt_state=jax.vmap(jdl.inner_tx.init)(p),
                          snapshot=s, outer_opt_state=jdl.outer_tx.init(s),
                          inner_step_count=jnp.zeros((), jnp.int32))


def close_to_snapshot_sum(got, want, snap):
    for k in want:
        ulps = 4 * np.finfo(np.float32).eps * np.abs(snap[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=ulps)


@pytest.mark.parametrize("mask", [(1, 1, 0, 1), (1, 1, 1, 1), (0, 0, 0, 0)],
                         ids=["worker-2-out", "all-on", "all-dead"])
def test_worker_mask_outer_step_matches_jax(mask):
    """The masked outer step on identical replicas: the survivor mean, an
    all-true mask the plain step, all-dead a zero pseudo-gradient (cold
    momentum: the snapshot does not move, nothing turns NaN)."""
    snap, workers = toy()
    jdl = JaxDiloco(JCFG, JaxDilocoConfig(num_workers=4), build_mesh(MeshConfig(diloco=4)))
    want = jdl.outer_step(jax_toy_state(jdl, snap, workers), jnp.asarray(mask, jnp.float32))
    dl = Diloco(CFG, DilocoConfig(num_workers=4), device="cpu")
    state, eff, dyn = dl.outer_step(port_toy_state(snap, workers), torch.tensor(mask))
    assert eff.tolist() == [bool(m) for m in mask] and dyn is None
    got = {k: v.numpy() for k, v in state.snapshot.items()}
    close_to_snapshot_sum(got, jax.tree.map(np.asarray, want.snapshot), snap)
    if not any(mask):
        for k in snap:
            np.testing.assert_array_equal(got[k], snap[k])
    if mask == (1, 1, 0, 1):
        # a NaN replica under the mask leaves the survivors' mean exactly
        poisoned = {k: v.copy() for k, v in workers.items()}
        for v in poisoned.values():
            v[2] = np.nan
        again, _, _ = dl.outer_step(port_toy_state(snap, poisoned), torch.tensor(mask))
        for k in snap:
            np.testing.assert_array_equal(again.snapshot[k].numpy(), got[k])
        # and equals the plain step on replicas where worker 2 is the
        # survivors' mean
        surg = {k: v.copy() for k, v in workers.items()}
        for v in surg.values():
            v[2] = v[[0, 1, 3]].mean(axis=0)
        ref, _, _ = dl.outer_step(port_toy_state(snap, surg))
        for k in snap:
            np.testing.assert_allclose(ref.snapshot[k].numpy(), got[k], atol=1e-6)


def test_effective_mask_counts_a_param_blowup():
    """Replica finiteness is the exact criterion: an inf replica is
    quarantined though its losses looked fine (the mask passed is
    all-true), as JAX's ``_outer_step`` reports."""
    snap, workers = toy()
    workers["w"][2] = np.inf
    jdl = JaxDiloco(JCFG, JaxDilocoConfig(num_workers=4, quarantine_nonfinite=True),
                    build_mesh(MeshConfig(diloco=4)))
    jnew, jeff, _ = jdl._outer_step(jax_toy_state(jdl, snap, workers), jnp.ones(4, bool))
    dl = Diloco(CFG, DilocoConfig(num_workers=4, quarantine_nonfinite=True), device="cpu")
    state, eff, _ = dl.outer_step(port_toy_state(snap, workers), torch.ones(4, dtype=torch.bool))
    assert eff.tolist() == np.asarray(jeff).tolist() == [True, True, False, True]
    got = {k: v.numpy() for k, v in state.snapshot.items()}
    assert all(np.isfinite(v).all() for v in got.values())
    close_to_snapshot_sum(got, jax.tree.map(np.asarray, jnew.snapshot), snap)


@pytest.fixture(scope="module")
def quarantine_rounds():
    """Two rounds with worker 2's replica poisoned (inf) before the
    first, on both sides, quarantine on."""
    tok, mask = batches(2)
    tree = numpy_params(CFG)
    poison = lambda x: x.at[2].set(jnp.inf)  # noqa: E731
    jdl = JaxDiloco(JCFG, JaxDilocoConfig(**common(quarantine_nonfinite=True)),
                    build_mesh(MeshConfig(diloco=W)))
    with jax.default_matmul_precision("highest"):
        js = jdl.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, tree))
        js = js.replace(params=jax.tree.map(poison, js.params))
        jout = []
        for r in range(2):
            js, jl, jeff = jdl.round_step(js, tok[r], mask[r])
            jout.append((np.asarray(jl), np.asarray(jeff),
                         jax.tree.map(np.asarray, js.inner_opt_state)))
    dl = Diloco(CFG, DilocoConfig(**common(quarantine_nonfinite=True)), device="cpu")
    state = dl.init_state(params=params_from_numpy(tree, device="cpu"))
    with torch.no_grad():
        for p in tree_leaves(state.params):
            p[2] = float("inf")
    pout = []
    for r in range(2):
        state, pl, peff = dl.round_step(state, tok[r], mask[r])
        moments = {n: {k: v.clone() for k, v in st.items()}
                   for n, st in zip(range(len(state.inner_opt.params)),
                                    (state.inner_opt.state[p] for p in state.inner_opt.params))}
        pout.append((pl.numpy(), peff.numpy(), moments))
    return jout, pout, js, state


def test_quarantine_self_heals_and_matches_jax(quarantine_rounds):
    jout, pout, js, state = quarantine_rounds
    (jl1, jeff1, _), (jl2, jeff2, _) = jout
    (pl1, peff1, _), (pl2, peff2, _) = pout
    assert not np.isfinite(pl1[:, 2]).any() and not np.isfinite(jl1[:, 2]).any()
    np.testing.assert_allclose(pl1, jl1, rtol=1e-5)  # NaN positions equal too
    assert peff1.tolist() == jeff1.tolist() == [True, True, False, True]
    # the heal sticks: the second round is finite for every worker
    assert np.isfinite(pl2).all()
    np.testing.assert_allclose(pl2, jl2, rtol=1e-5)
    assert peff2.tolist() == jeff2.tolist() == [True] * W
    for p, s in zip(tree_leaves(params_to_numpy(state.params)),
                    tree_leaves(params_to_numpy(state.snapshot))):
        assert np.isfinite(p).all() and all(np.array_equal(p[w], s) for w in range(W))
    for a, b in zip(jax.tree.leaves(params_to_numpy(state.snapshot)),
                    jax.tree.leaves(jax.tree.map(np.asarray, js.snapshot))):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=5e-5)


def test_heal_zeroes_the_quarantined_moments_and_keeps_counts(quarantine_rounds):
    """After round 1 worker 2's Adam moments are zero (a NaN moment never
    decays) and its step count is the others', as JAX's heal leaves its
    integer leaves."""
    jout, pout, _, _ = quarantine_rounds
    moments = pout[0][2]
    for st in moments.values():
        assert not st["exp_avg"][2].any() and not st["exp_avg_sq"][2].any()
        assert st["exp_avg"][0].any()
        assert st["step"].tolist() == [float(H)] * W
    adam = jout[0][2][1][0]
    for mu in jax.tree.leaves(adam.mu):
        assert not mu[2].any()
    assert np.asarray(adam.count).tolist() == [H] * W


def test_quarantine_catches_final_step_blowup():
    """A NaN written after the round's last update (every loss finite)
    is quarantined by the replica check."""
    dl = Diloco(CFG, DilocoConfig(**common(quarantine_nonfinite=True)), device="cpu")
    state = dl.init_state(params=params_from_numpy(numpy_params(CFG), device="cpu"))
    tok, mask = batches(1)
    state, _ = dl.inner_step(state, tok[0, 0], mask[0, 0])
    with torch.no_grad():
        for p in tree_leaves(state.params):
            p[1] = float("nan")
    state, eff, _ = dl.outer_step(state, torch.ones(W, dtype=torch.bool))
    assert eff.tolist() == [True, False, True, True]
    assert all(torch.isfinite(t).all() for t in tree_leaves(state.snapshot)
               + tree_leaves(state.params))


def test_quarantine_off_lets_nan_spread():
    dl = Diloco(CFG, DilocoConfig(**common()), device="cpu")
    state = dl.init_state(params=params_from_numpy(numpy_params(CFG), device="cpu"))
    with torch.no_grad():
        for p in tree_leaves(state.params):
            p[2] = float("inf")
    tok, mask = batches(1)
    dl.round_step(state, tok[0], mask[0])
    assert any(not torch.isfinite(t).all() for t in tree_leaves(state.snapshot))


def test_quarantine_and_dynamics_rejected_for_streaming():
    for kw in (dict(quarantine_nonfinite=True), dict(dynamics_metrics=True)):
        with pytest.raises(ValueError, match="classic-DiLoCo-only"):
            StreamingDiloco(CFG, DilocoConfig(num_workers=2, inner_steps=4, **kw),
                            StreamingConfig(num_fragments=2, delay=1), device="cpu")


# the plain readout is held to JAX's through train() in
# tests/test_torch_train_options.py
DYN_MODES = {"quarantine-int8": dict(quarantine_nonfinite=True, outer_comm_dtype="int8")}


@pytest.fixture(scope="module")
def dynamics_rounds():
    """Two rounds with the readout on, both sides, each mode."""
    tok, mask = batches(2, seed=7)
    tree = numpy_params(CFG)
    out = {}
    for name, kw in DYN_MODES.items():
        cfg = common(dynamics_metrics=True, **kw)
        jdl = JaxDiloco(JCFG, JaxDilocoConfig(**cfg), build_mesh(MeshConfig(diloco=W)))
        dl = Diloco(CFG, DilocoConfig(**cfg), device="cpu")
        state = dl.init_state(params=params_from_numpy(tree, device="cpu"))
        jd, pd = [], []
        with jax.default_matmul_precision("highest"):
            js = jdl.init_state(jax.random.key(0), params=jax.tree.map(jnp.asarray, tree))
            for r in range(2):
                js, _, _, jdyn = jdl.round_step(js, tok[r], mask[r])
                state, _, _, pdyn = dl.round_step(state, tok[r], mask[r])
                jd.append({k: np.asarray(v) for k, v in jdyn.items()})
                pd.append({k: v.numpy() for k, v in pdyn.items()})
        out[name] = (jd, pd)
    return out


@pytest.mark.parametrize("mode", sorted(DYN_MODES))
def test_dynamics_match_jax(dynamics_rounds, mode):
    jd, pd = dynamics_rounds[mode]
    for j, p in zip(jd, pd):
        assert set(p) == set(j) == set(DYN_KEYS)
        assert p["pg_norm"].shape == (W,)
        for k in DYN_KEYS:
            np.testing.assert_allclose(p[k], j[k], rtol=1e-4, err_msg=k)
        assert 0 < p["drift_max"] and p["drift_mean"] <= p["drift_max"]
        assert abs(p["outer_update_cos"]) <= 1 + 1e-6  # round 1: momentum = delta, cos 1


def test_dynamics_on_off_bit_identical():
    """Three rounds with the readout and without: the same losses, params,
    snapshot and momentum, bit for bit (under quarantine too)."""
    tok, mask = batches(3, seed=11)
    tree = numpy_params(CFG)
    runs = []
    for on in (False, True):
        dl = Diloco(CFG, DilocoConfig(**common(dynamics_metrics=on, quarantine_nonfinite=True)),
                    device="cpu")
        state = dl.init_state(params=params_from_numpy(tree, device="cpu"))
        losses = [dl.round_step(state, tok[r], mask[r])[1] for r in range(3)]
        runs.append((torch.stack(losses), tree_leaves(state.params)
                     + tree_leaves(state.snapshot) + tree_leaves(state.outer_opt_state)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_drift_is_well_conditioned_near_a_large_snapshot():
    """Replicas 1e-3 apart around weights of 1e3: the drift matches
    float64 pairwise distances to 1e-3 (a gram of the raw params would
    cancel to noise at this ratio)."""
    rng = np.random.default_rng(4)
    snap = {"w": (1e3 + rng.standard_normal(4096)).astype(np.float32)}
    workers = {"w": (snap["w"][None] + 1e-3 * rng.standard_normal((4, 4096))).astype(np.float32)}
    dl = Diloco(CFG, DilocoConfig(num_workers=4, dynamics_metrics=True), device="cpu")
    _, _, dyn = dl.outer_step(port_toy_state(snap, workers))
    p = workers["w"].astype(np.float64)
    pair = [np.linalg.norm(p[i] - p[j]) for i in range(4) for j in range(i + 1, 4)]
    norm = np.linalg.norm(snap["w"].astype(np.float64))
    np.testing.assert_allclose(float(dyn["drift_max"]), max(pair) / norm, rtol=1e-3)
    np.testing.assert_allclose(float(dyn["drift_mean"]),
                               np.sqrt(np.mean(np.square(pair))) / norm, rtol=1e-3)
    one = Diloco(CFG, DilocoConfig(num_workers=1, dynamics_metrics=True), device="cpu")
    _, _, dyn1 = one.outer_step(port_toy_state(snap, {"w": workers["w"][:1]}))
    assert float(dyn1["drift_max"]) == float(dyn1["drift_mean"]) == 0.0
