"""End-to-end training-trajectory parity of the port with the reference
stack: the port of tests/test_train_parity.py.

The reference trains HF ``LlamaForCausalLM`` with torch AdamW, the
transformers cosine-warmup schedule and global-norm clip 1.0. From the
SAME weights (the HF state dict through the JAX package's
``from_hf_state_dict`` into the port's layout) and on the SAME batches,
the port's inner step must reproduce the HF loss trajectory step for
step.

Tolerances, as in the JAX test: step 0 is pure forward parity (2e-5
relative); later steps compound optimizer-state float differences, so
2e-3, still far below any real divergence (losses are ~5.5).
"""

import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import from_hf_state_dict
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig

STEPS = 8
LR = 1e-3
WARMUP = 2


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on one machine; torch's
    default of one intra-op thread per core in each would oversubscribe
    the cores. One thread per worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_inner_training_matches_hf_reference():
    transformers = pytest.importorskip("transformers")

    cfg = LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
        max_position_embeddings=64, loss_chunk=0,
    )
    hf_cfg = transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size,
        num_attention_heads=cfg.num_attention_heads,
        num_key_value_heads=cfg.kv_heads,
        num_hidden_layers=cfg.num_hidden_layers,
        rms_norm_eps=cfg.rms_norm_eps, use_cache=False,
        max_position_embeddings=cfg.max_position_embeddings,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    hf_model = transformers.LlamaForCausalLM(hf_cfg)
    sd = {k: v.detach().to(torch.float32).numpy() for k, v in hf_model.state_dict().items()}
    tree = from_hf_state_dict(sd, JaxConfig(**cfg.to_dict()))
    params = params_from_numpy(tree, device="cpu")

    rng = np.random.default_rng(0)
    batches = rng.integers(0, cfg.vocab_size, size=(STEPS, 2, 32))

    opt = torch.optim.AdamW(hf_model.parameters(), lr=LR)
    sched = transformers.get_cosine_schedule_with_warmup(opt, WARMUP, STEPS)
    hf_losses = []
    for s in range(STEPS):
        ids = torch.tensor(batches[s])
        out = hf_model(input_ids=ids, labels=ids)
        hf_losses.append(out.loss.item())
        out.loss.backward()
        torch.nn.utils.clip_grad_norm_(hf_model.parameters(), 1.0)
        opt.step()
        sched.step()
        opt.zero_grad()

    dl = Diloco(cfg, DilocoConfig(num_workers=1, inner_steps=STEPS, warmup_steps=WARMUP,
                                  total_steps=STEPS, lr=LR, grad_accum=1), device="cpu")
    state = dl.init_state(params=params)
    ours = []
    for s in range(STEPS):
        tok = batches[s][None, None]  # [W=1, accum=1, B, S]
        state, loss = dl.inner_step(state, tok, np.ones_like(tok))
        ours.append(float(loss[0]))

    np.testing.assert_allclose(ours[0], hf_losses[0], rtol=2e-5)
    np.testing.assert_allclose(ours, hf_losses, rtol=2e-3)

