"""The port's HF paths through training, on the CPU, against the JAX
package: ``--init-hf`` and ``export-hf`` end to end, the HF tokenizer,
an HF ``datasets`` directory as ``--dataset-path``, and
``scripts/torch_prepare_data.py`` against ``scripts/prepare_data.py``.

Tolerances: a run started from one HF checkpoint reads the same float32
weights and the same batches in both packages, so its losses differ only
by float32 summation order, 1e-5 relative (tests/test_torch_train_loop.py);
logits against transformers 2e-4 (tests/test_hf_sharded.py). Token ids,
packed rows, shard bytes and manifests are compared exactly.
"""

import dataclasses
import json
import runpy
import sys
import warnings
from pathlib import Path

import datasets
import jax
import numpy as np
import pytest
import torch
import transformers
from tokenizers import Tokenizer, models, pre_tokenizers, trainers

from nanodiloco_tpu.data import pipeline as jax_pipeline
from nanodiloco_tpu.data.tokenizer import HFTokenizer as JaxHFTokenizer
from nanodiloco_tpu.models import LlamaConfig as JaxConfig
from nanodiloco_tpu.training.train_loop import TrainConfig as JaxTrainConfig
from nanodiloco_tpu.training.train_loop import train as jax_train
from nanodiloco_tpu_torch import __main__ as cli
from nanodiloco_tpu_torch.data import pipeline
from nanodiloco_tpu_torch.data.tokenizer import (
    ByteTokenizer,
    HFTokenizer,
    get_tokenizer,
    load_tokenizer,
)
from nanodiloco_tpu_torch.models import hf_interop as hf
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.llama import forward, params_from_numpy, tree_leaves
from nanodiloco_tpu_torch.parallel.diloco import Diloco, DilocoConfig
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

ROOT = Path(__file__).resolve().parents[1]
CFG = LlamaConfig(vocab_size=384, hidden_size=32, intermediate_size=64,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=64, attention_impl="flash", loss_chunk=16)
COMMON = dict(seed=1337, batch_size=4, per_device_batch_size=2, seq_length=32,
              warmup_steps=1, total_steps=4, inner_steps=2, lr=1e-3, num_workers=2,
              quiet=True, cost_analysis=False)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One torch thread per test worker process, restored after this file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(cfg: LlamaConfig, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    d, f, v, n = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.num_hidden_layers
    q, kv = cfg.num_attention_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim

    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    return {"embed": w(v, d), "final_norm": 1 + w(d), "lm_head": w(d, v), "layers": {
        "attn_norm": 1 + w(n, d), "wq": w(n, d, q), "wk": w(n, d, kv), "wv": w(n, d, kv),
        "wo": w(n, q, d), "mlp_norm": 1 + w(n, d), "w_gate": w(n, d, f), "w_up": w(n, d, f),
        "w_down": w(n, f, d)}}


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """An HF checkpoint (shards, index, config.json) of numpy-seeded weights."""
    d = tmp_path_factory.mktemp("hf")
    hf.save_hf_pretrained(params_from_numpy(numpy_params(CFG, 0), "cpu"), CFG, str(d),
                          max_shard_bytes=100_000)
    (d / "config.json").write_text(json.dumps(hf.hf_config(CFG)))
    return d


def losses(path):
    return [r["loss"] for r in map(json.loads, open(path)) if "loss" in r]


def test_init_hf_training_matches_jax(hf_dir, tmp_path):
    """Both packages train from one HF checkpoint: the same losses."""
    jcfg = JaxConfig(**CFG.to_dict())
    with jax.default_matmul_precision("highest"):
        jax_train(JaxTrainConfig(**COMMON, model=jcfg, init_hf=str(hf_dir),
                                 log_dir=str(tmp_path / "jax"), run_name="r",
                                 dynamics_metrics=False, preempt_signals=False))
    summary = train(TrainConfig(**COMMON, model=CFG, init_hf=str(hf_dir),
                                log_dir=str(tmp_path / "port"), run_name="r",
                                dynamics_metrics=False), device="cpu")
    # the import sets the vocabulary: no fit to the tokenizer's 384 -> 384
    assert summary["model"]["vocab_size"] == CFG.vocab_size
    want, got = losses(tmp_path / "jax" / "r.jsonl"), losses(tmp_path / "port" / "r.jsonl")
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_init_hf_seeds_snapshot_and_workers(hf_dir):
    imported = hf.from_hf_pretrained(str(hf_dir), CFG, "cpu")
    dl = Diloco(CFG, DilocoConfig(num_workers=2), device="cpu")
    state = dl.init_state(params=imported)
    for s, p, w in zip(tree_leaves(state.snapshot), tree_leaves(imported),
                       tree_leaves(state.params)):
        assert torch.equal(s, p) and all(torch.equal(w[i], p) for i in range(2))


def test_init_hf_vocab_is_the_checkpoints(tmp_path):
    """fit_vocab is off for an HF import: a 512-token checkpoint keeps 512
    where the byte tokenizer would fit 384."""
    cfg = dataclasses.replace(CFG, vocab_size=512)
    hf.save_hf_pretrained(params_from_numpy(numpy_params(cfg, 1), "cpu"), cfg, str(tmp_path))
    summary = train(TrainConfig(**{**COMMON, "total_steps": 2}, model=cfg,
                                init_hf=str(tmp_path), log_dir=None), device="cpu")
    assert summary["model"]["vocab_size"] == 512


def test_export_hf_cli_roundtrip(tmp_path, capsys):
    """train -> export-hf -> transformers.from_pretrained gives the port's
    logits on the snapshot; --init-hf starts a new CLI run from the export
    with its config.json as the model config."""
    ck, out = str(tmp_path / "ck"), str(tmp_path / "hf")
    model_file = tmp_path / "model.json"
    model_file.write_text(json.dumps(dataclasses.replace(CFG, attention_impl="dense").to_dict()))
    base = ["--device", "cpu", "--total-steps", "2", "--inner-steps", "2", "--batch-size", "4",
            "--per-device-batch-size", "2", "--seq-length", "32", "--warmup-steps", "1",
            "--quiet", "--no-resume", "--no-cost-analysis"]
    summary = cli.main(base + ["--llama-config-file", str(model_file), "--checkpoint-dir", ck,
                               "--log-dir", str(tmp_path / "runs")])
    cli.main(["export-hf", "--checkpoint-dir", ck, "--out", out])
    assert "exported model.safetensors" in capsys.readouterr().out
    model = transformers.LlamaForCausalLM.from_pretrained(out).eval()
    toks = torch.tensor(np.random.default_rng(0).integers(0, CFG.vocab_size, size=(2, 16)))
    cfg = LlamaConfig.from_dict(summary["model"])
    with torch.no_grad():
        np.testing.assert_allclose(forward(summary["state"].snapshot, toks, cfg).numpy(),
                                   model(input_ids=toks).logits.numpy(), rtol=2e-4, atol=2e-4)
    run2 = cli.main(base + ["--init-hf", out, "--attention", "flash", "--loss-chunk", "16",
                            "--log-dir", str(tmp_path / "runs2")])
    assert run2["model"]["attention_impl"] == "flash" and run2["model"]["loss_chunk"] == 16
    assert run2["model"]["hidden_size"] == CFG.hidden_size
    assert np.isfinite(run2["final_loss"])


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """A BPE tokenizer trained here with ``tokenizers`` on the synthetic
    corpus and saved as a transformers fast tokenizer (nothing downloaded)."""
    d = tmp_path_factory.mktemp("tok")
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.train_from_iterator(pipeline.synthetic_corpus(n_docs=200, seed=0),
                            trainers.BpeTrainer(vocab_size=300,
                                                special_tokens=["<unk>", "<s>", "</s>"]))
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>",
                                                eos_token="</s>", unk_token="<unk>")
    fast.save_pretrained(str(d))
    return d


def test_hf_tokenizer_ids_match_jax(tok_dir):
    ours, theirs = HFTokenizer(str(tok_dir)), JaxHFTokenizer(str(tok_dir))
    assert (ours.vocab_size, ours.pad_id, ours.eos_id) == (
        theirs.vocab_size, theirs.pad_id, theirs.eos_id)
    for text in pipeline.synthetic_corpus(n_docs=5, seed=4) + ["", "worker sync ✓ ring"]:
        for kw in ({}, {"add_bos": True}, {"add_eos": True}):
            ids = ours.encode(text, **kw)
            assert ids == theirs.encode(text, **kw), (text, kw)
        assert ours.decode(ids) == theirs.decode(ids)
    assert isinstance(get_tokenizer(str(tok_dir)), HFTokenizer)
    assert isinstance(load_tokenizer(str(tok_dir)), HFTokenizer)


def test_get_tokenizer_falls_back_offline():
    """A name that cannot load from local files falls back with a warning
    (never a download); the strict loader of generate/serve refuses."""
    with pytest.warns(UserWarning, match="falling back"):
        tok = get_tokenizer("nonexistent/model-that-cannot-be-fetched")
    assert isinstance(tok, ByteTokenizer)
    for name in (None, "byte-level"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert isinstance(get_tokenizer(name), ByteTokenizer)
            assert isinstance(load_tokenizer(name), ByteTokenizer)
    with pytest.raises(SystemExit, match="tokenizer 'nonexistent/x' is not available"):
        load_tokenizer("nonexistent/x")


@pytest.fixture(scope="module")
def ds_dir(tmp_path_factory):
    """A ``datasets.save_to_disk`` directory with a train split (and an
    extra column, as c4 has)."""
    d = tmp_path_factory.mktemp("ds")
    texts = pipeline.synthetic_corpus(n_docs=300, seed=7)
    datasets.DatasetDict({"train": datasets.Dataset.from_dict(
        {"text": texts, "url": [f"u{i}" for i in range(len(texts))]})}).save_to_disk(str(d))
    return d


def test_hf_dataset_gives_jax_rows(ds_dir, tok_dir):
    texts = pipeline.load_hf_dataset_texts(str(ds_dir))
    assert texts == jax_pipeline.load_hf_dataset_texts(str(ds_dir))
    assert texts == list(pipeline.iter_hf_dataset_texts(str(ds_dir)))
    for ours, theirs in ((ByteTokenizer(), ByteTokenizer()),
                         (HFTokenizer(str(tok_dir)), JaxHFTokenizer(str(tok_dir)))):
        np.testing.assert_array_equal(pipeline.pack_corpus(texts, ours, 32),
                                      jax_pipeline.pack_corpus(texts, theirs, 32))


def test_train_reads_an_hf_dataset_dir(ds_dir, tmp_path):
    summary = train(TrainConfig(**COMMON, model=CFG, dataset_path=str(ds_dir),
                                eval_every=1, eval_batches=1,
                                log_dir=str(tmp_path)), device="cpu")
    assert np.isfinite(summary["final_loss"]) and np.isfinite(summary["eval_loss"])


PREPARE_CASES = {
    "synthetic": ["--n-docs", "120", "--seed", "3", "--seq-length", "64"],
    "dataset_hf_tokenizer": ["--dataset-path", "{ds}", "--tokenizer", "{tok}",
                             "--seq-length", "48", "--flush-rows", "7"],
    "text_dir": ["--text-dir", "{ds}", "--text-glob", "*.json", "--seq-length", "32"],
}


@pytest.mark.parametrize("case", PREPARE_CASES)
def test_torch_prepare_data_matches_jax_script(case, ds_dir, tok_dir, tmp_path, monkeypatch,
                                               capsys):
    """The same input and tokenizer give the same .tshrd bytes and the
    same manifest apart from its ``created`` time."""
    args = [a.format(ds=ds_dir, tok=tok_dir) for a in PREPARE_CASES[case]]
    for script, out in (("prepare_data.py", "jax.tshrd"), ("torch_prepare_data.py",
                                                          "port.tshrd")):
        monkeypatch.setattr(sys, "argv", [script, "--out", str(tmp_path / out), *args])
        runpy.run_path(str(ROOT / "scripts" / script), run_name="__main__")
    capsys.readouterr()
    assert (tmp_path / "jax.tshrd").read_bytes() == (tmp_path / "port.tshrd").read_bytes()
    mj = json.load(open(tmp_path / "jax.tshrd.manifest.json"))
    mp = json.load(open(tmp_path / "port.tshrd.manifest.json"))
    assert mj.pop("created") and mp.pop("created")
    assert mp == mj and mp["n_sequences"] > 0
