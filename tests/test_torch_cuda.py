"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card (decided inside the test,
so every xdist worker collects the same tests). This file imports neither
jax nor the JAX package, so it also runs on a machine that has only
PyTorch; there, skip the repo's JAX-side conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

Tolerance, as in chip_smoke.py: ``atol * max|ref| + rtol * |ref|``. The
FMA kernels compute in float32 from the same inputs as the plain versions
and differ in summation order, ~1e-6 relative in float32, and bf16
outputs may land one bf16 ulp (2**-7 relative) apart: atol 2e-3, rtol
1e-4 (f32) or 2**-7 (bf16). The tensor-core kernels (bf16: B1, B2, B3 at
hd 128; B1 and B3 at hd 64 and 32) also round P (B1), dS (B2), P and dS
(B3) to bf16 before the last product, where the plain versions keep
float32: atol 2**-8.
"""

import pytest
import torch

from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import init_params, tree_leaves, tree_map
from nanodiloco_tpu_torch.ops.cuda import flash_attention as fa
from nanodiloco_tpu_torch.ops.flash_attention import flash_attention
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager
from nanodiloco_tpu_torch.training.evaluate import Evaluator, holdout_batches

RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
ATOL = {"fma": 2e-3, "wgmma": 2.0 ** -8}


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def close(got, want, dtype, variant="fma"):
    want = want.float()
    atol = ATOL[variant] * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=RTOL[dtype], atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, hd", [(torch.float32, 64), (torch.bfloat16, 64),
                                       (torch.bfloat16, 128), (torch.float32, 16),
                                       (torch.bfloat16, 80), (torch.float32, 96)])
@pytest.mark.parametrize("causal", [True, False])
def test_kernels_match_plain(dtype, hd, causal):
    """B1, B2, B3 at GQA group 4 and a ragged S of 200; bf16 at hd 128 runs
    the tensor-core kernels for all three, and their variant counts say so."""
    gen = card()
    q, do = (torch.randn(8, 200, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(2, 200, hd, generator=gen, device="cuda").to(dtype) for _ in range(2))
    variant = {name: fa.ROUTES[name, dtype, hd] for name in fa.KERNEL_NAMES}
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, causal)
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    close(o, o_ref, dtype, variant["flash_fwd"])
    close(lse, lse_ref, torch.float32)
    close(fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal),
          fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal), dtype,
          variant["flash_bwd_dq"])
    for got, want in zip(fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal),
                         fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)):
        close(got, want, dtype, variant["flash_bwd_dkv"])
    assert fa.launch_counts() == {"flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    assert fa.variant_counts() == {
        name: {v: int(v == variant[name]) for v in fa.VARIANTS} for name in fa.KERNEL_NAMES
    }
    if dtype == torch.bfloat16 and hd == 128:
        assert variant == {"flash_fwd": "wgmma", "flash_bwd_dq": "wgmma", "flash_bwd_dkv": "wgmma"}


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 32])
@pytest.mark.parametrize("h, hkv, s, causal", [(8, 4, 1024, True), (4, 4, 200, True),
                                               (4, 2, 77, False)])
def test_tensor_core_forward_and_dkv_at_hd_64_and_32(hd, h, hkv, s, causal):
    """bf16 at hd 64 and 32: B1 and B3 launch the tensor-core kernels, B2
    the FMA kernel, and each matches its plain version (GQA and MHA, a
    ragged S, causal and not). B3 sums its query group in registers: two
    launches give dK and dV identical bit for bit."""
    gen = card()
    bf16 = torch.bfloat16
    q, do = (torch.randn(2 * h, s, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    k, v = (torch.randn(2 * hkv, s, hd, generator=gen, device="cuda").to(bf16) for _ in range(2))
    o_ref, lse_ref = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do.float() * o_ref.float()).sum(-1, keepdim=True)
    fa.reset_launch_counts()
    o, lse = fa.flash_fwd(q, k, v, causal)
    close(o, o_ref, bf16, "wgmma")
    close(lse, lse_ref, torch.float32)
    close(fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal),
          fa.flash_bwd_dq_plain(q, k, v, do, lse_ref, delta, causal), bf16, "fma")
    first = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    second = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal)
    for got, again, want in zip(first, second,
                                fa.flash_bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal)):
        close(got, want, bf16, "wgmma")
        assert torch.equal(got, again)
    assert fa.variant_counts() == {"flash_fwd": {"fma": 0, "wgmma": 1},
                                   "flash_bwd_dq": {"fma": 1, "wgmma": 0},
                                   "flash_bwd_dkv": {"fma": 0, "wgmma": 2}}


@pytest.mark.cuda
def test_tensor_core_dq_is_bitwise_deterministic():
    """Each CTA of the tensor-core B2 owns its dQ rows and sums over the K
    tiles in one fixed order, without atomics: two launches at a ragged GQA
    shape (group 4, S 1000, causal) give dQ identical bit for bit."""
    gen = card()
    q, do = (torch.randn(8, 1000, 128, generator=gen, device="cuda").to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(2, 1000, 128, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    o, lse = fa.flash_fwd_plain(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1, keepdim=True)
    fa.reset_launch_counts()
    first = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    second = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    assert fa.variant_counts()["flash_bwd_dq"] == {"fma": 0, "wgmma": 2}
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_autograd_on_the_card_matches_the_cpu():
    """The dispatcher's forward and gradients through the kernels on the
    card equal the plain versions on the CPU ([B, S, H, hd] layout)."""
    gen = card()
    shapes = [(2, 130, 8, 128), (2, 130, 2, 128), (2, 130, 2, 128), (2, 130, 8, 128)]
    q, k, v, ct = (torch.randn(*s, generator=gen, device="cuda") for s in shapes)
    results = []
    for device in ("cuda", "cpu"):
        leaves = [x.detach().to(device).requires_grad_(True) for x in (q, k, v)]
        out = flash_attention(*leaves, causal=True)
        (out * ct.to(device)).sum().backward()
        results.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    for got, want in zip(*results):
        close(got, want, torch.float32)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take():
    card()
    q = torch.zeros(4, 64, 40, device="cuda")  # hd 40 is not instantiated
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(q, q, q, True)
    # a storage offset off the 16-byte grid: raised, never routed elsewhere
    x = torch.zeros(4 * 64 * 128 + 1, device="cuda", dtype=torch.bfloat16)[1:]
    q = x.view(4, 64, 128)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(q, q, q, True)
    assert fa.launch_counts()["flash_fwd"] == 0


SMALL = LlamaConfig(vocab_size=384, hidden_size=256, intermediate_size=512,
                    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                    attention_impl="flash", remat=True, loss_chunk=128)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(tmp_path):
    """One round on the card, saved, restored into a fresh state on the
    card: every leaf, AdamW's moments and step counts and the outer
    momentum come back bit for bit."""
    gen = card()
    dl = Diloco(SMALL, DilocoConfig(num_workers=2, inner_steps=2, warmup_steps=1,
                                    total_steps=4, lr=1e-3, grad_accum=2), device="cuda")
    state = dl.init_state(gen)
    toks = torch.randint(0, SMALL.vocab_size, (2, 2, 2, 1, 200), generator=gen,
                         device="cuda")
    dl.round_step(state, toks, torch.ones_like(toks))
    ck = CheckpointManager(str(tmp_path / "ck"))
    ck.save(2, state)
    fresh = ck.restore(dl.init_state(torch.Generator(device="cuda").manual_seed(1)))
    for a, b in zip(tree_leaves(fresh.params) + tree_leaves(fresh.snapshot),
                    tree_leaves(state.params) + tree_leaves(state.snapshot)):
        assert a.is_cuda and torch.equal(a, b)
    for pa, pb in zip(tree_leaves(fresh.params), tree_leaves(state.params)):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(fresh.inner_opt.state[pa][k], state.inner_opt.state[pb][k])
    for ma, mb in zip(tree_leaves(fresh.outer_opt_state), tree_leaves(state.outer_opt_state)):
        assert torch.equal(ma, mb)
    assert fresh.inner_step_count == 2


@pytest.mark.cuda
def test_evaluator_on_the_card_matches_the_cpu():
    """The snapshot's held-out loss through B1 on the card against the
    plain versions on the CPU, float32 with TF32 off: the two differ in
    summation order only, 1e-3 relative bounds it."""
    card()
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_params(torch.Generator().manual_seed(0), SMALL, device="cpu")
    rows = torch.randint(0, SMALL.vocab_size, (6, 200),
                         generator=torch.Generator().manual_seed(1)).numpy()
    batches = holdout_batches(rows, 2)
    fa.reset_launch_counts()
    got = Evaluator(SMALL, "cuda")(tree_map(lambda p: p.cuda(), params), batches)
    assert fa.launch_counts() == {"flash_fwd": 3 * SMALL.num_hidden_layers,
                                  "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    want = Evaluator(SMALL, "cpu")(params, batches)
    assert got["eval_tokens"] == want["eval_tokens"]
    assert abs(got["eval_loss"] - want["eval_loss"]) <= 1e-3 * want["eval_loss"]


@pytest.mark.cuda
def test_generate_and_engine_on_the_card_match_the_cpu():
    """Greedy generate() on the card against the CPU from one parameter
    tree, float32 with TF32 off: identical tokens. The weights are drawn
    at std 0.2 so that the logits' top-2 gaps (~1e-1) dwarf the summation
    order's ~1e-6: a near-tie cannot flip a token here. The engine on the
    card (2 slots, chunk 8) serves a greedy and a sampled request, each
    token-identical to the card's solo generate() with its seed."""
    from nanodiloco_tpu_torch.models.generate import generate, noise_uniforms
    from nanodiloco_tpu_torch.serve import GenRequest, InferenceEngine, Scheduler

    card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = LlamaConfig(vocab_size=384, hidden_size=128, intermediate_size=256,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      initializer_range=0.2)
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.randint(0, 384, (2, 11), generator=torch.Generator().manual_seed(1))
    cpu = generate(params, prompt, cfg, 16, device="cpu")
    gpu = generate(params, prompt, cfg, 16, device="cuda")
    assert torch.equal(gpu.cpu(), cpu)
    assert torch.equal(noise_uniforms([3, 4], [0, 0], [0, 5], 384, "cuda").cpu(),
                       noise_uniforms([3, 4], [0, 0], [0, 5], 384, "cpu"))
    eng = InferenceEngine(params, cfg, num_slots=2, max_len=64, chunk_size=8)
    sched = Scheduler(eng)
    reqs = [GenRequest(prompt=tuple(prompt[0].tolist()), max_new_tokens=12, seed=0),
            GenRequest(prompt=tuple(prompt[1].tolist()), max_new_tokens=12, temperature=0.9,
                       top_k=50, seed=5)]
    tickets = [sched.submit(r) for r in reqs]
    for _ in range(200):
        if sched.tick() == 0 and all(t.done() for t in tickets):
            break
    for ticket, req in zip(tickets, reqs):
        want = generate(params, [list(req.prompt)], cfg, 12, temperature=req.temperature,
                        top_k=req.top_k, seed=req.seed, device="cuda")[0].tolist()
        assert ticket.result["tokens"] == want


@pytest.mark.cuda
def test_offload_snapshot_on_the_card_matches_device_resident():
    """With offload_snapshot the snapshot waits in pinned host memory
    between syncs and comes back to the card for each outer step: three
    rounds equal the device-resident run bit for bit."""
    card()
    tiny = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                       num_attention_heads=4, num_hidden_layers=2, max_position_embeddings=32)
    params = init_params(torch.Generator().manual_seed(0), tiny, device="cpu")
    tok = torch.randint(0, tiny.vocab_size, (2, 2, 1, 2, 16),
                        generator=torch.Generator().manual_seed(1))
    runs = []
    for offload in (False, True):
        dl = Diloco(tiny, DilocoConfig(num_workers=2, inner_steps=2, warmup_steps=2,
                                       total_steps=50, lr=1e-3, offload_snapshot=offload),
                    device="cuda")
        state = dl.init_state(params=params)
        losses = [dl.round_step(state, tok, torch.ones_like(tok))[1] for _ in range(3)]
        leaf = tree_leaves(state.snapshot)[0]
        assert (leaf.device.type == "cpu" and leaf.is_pinned()) == offload
        runs.append((torch.stack(losses).cpu(), [t.cpu() for t in tree_leaves(state.snapshot)]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))

