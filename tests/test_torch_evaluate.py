"""The port's held-out evaluation (nanodiloco_tpu_torch.training.evaluate)
against the JAX package's ``Evaluator`` on the CPU, on one numpy
parameter tree and the same ``holdout_batches``.

Tolerance: ``eval_loss`` within 1e-5 relative. Both sides run the same
float32 forward (JAX under ``default_matmul_precision("highest")``) in
another summation order, ~1e-6 relative per op; ``eval_perplexity`` =
exp(loss) multiplies that relative error by the loss (~5 here): 1e-4.
The token count is a sum of 0/1 mask entries and must be equal.
"""

import jax
import numpy as np
import pytest
import torch

from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.models import init_params as jax_init
from nanodiloco_tpu.parallel import MeshConfig, build_mesh
from nanodiloco_tpu.training import evaluate as jax_evaluate
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import params_from_numpy
from nanodiloco_tpu_torch.training.evaluate import Evaluator, holdout_batches

B, S, N = 2, 24, 7  # 7 rows -> 3 full batches, the last row dropped


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """The suite runs in several worker processes on one machine; torch's
    default of one intra-op thread per core in each would oversubscribe
    the cores. One thread per worker, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(cfg: LlamaConfig, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    shapes = jax_init(jax.random.key(0), JaxConfig(**cfg.to_dict()))
    return jax.tree_util.tree_map_with_path(
        lambda path, x: ((1.0 if "norm" in jax.tree_util.keystr(path) else 0.0)
                         + 0.1 * rng.standard_normal(x.shape)).astype(np.float32),
        shapes,
    )


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("layout", ["packed", "padded"])
def test_evaluator_matches_jax(attention, layout):
    cfg = LlamaConfig(vocab_size=96, hidden_size=32, intermediate_size=64,
                      num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                      max_position_embeddings=64, attention_impl=attention, loss_chunk=16)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, cfg.vocab_size, (N, S)).astype(np.int32)
    mask_rows = None
    if layout == "padded":  # tail padding of a random length per row
        lengths = rng.integers(3, S, (N, 1))
        mask_rows = (np.arange(S) < lengths).astype(np.int32)
    batches = holdout_batches(rows, B, mask_rows=mask_rows)
    jbatches = jax_evaluate.holdout_batches(rows, B, mask_rows=mask_rows)
    assert len(batches) == len(jbatches) == 3
    for (t, m), (jt, jm) in zip(batches, jbatches):
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(m, jm)

    tree = numpy_params(cfg)
    mesh = build_mesh(MeshConfig(diloco=1), devices=jax.devices()[:1])
    with jax.default_matmul_precision("highest"):
        want = jax_evaluate.Evaluator(JaxConfig(**cfg.to_dict()), mesh, quiet=True)(
            jax.tree.map(jax.numpy.asarray, tree), jbatches)
    got = Evaluator(cfg, device="cpu")(params_from_numpy(tree, device="cpu"), batches)
    assert got.keys() == want.keys()
    assert got["eval_tokens"] == want["eval_tokens"]
    np.testing.assert_allclose(got["eval_loss"], want["eval_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["eval_perplexity"], want["eval_perplexity"], rtol=1e-4)
