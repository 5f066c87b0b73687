"""The port's tokenshard reader/writer and batchers
(nanodiloco_tpu_torch.data.tokenshard, .pipeline) against the JAX
package's, on shards made from a seed with numpy.

Tolerance: none. Both packages read and write the same file format over
the same C++ source (or its bit-identical numpy fallback) and shuffle with
the same splitmix64 generator, so tokens, masks and batch order must be
identical.
"""

import os

import numpy as np
import pytest

from nanodiloco_tpu.data import pipeline as jax_pipeline
from nanodiloco_tpu.data import tokenshard as jax_ts
from nanodiloco_tpu.data.tokenizer import ByteTokenizer as JaxByteTokenizer
from nanodiloco_tpu_torch.data import pipeline, tokenshard
from nanodiloco_tpu_torch.data.tokenizer import ByteTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(n=41, s=24, seed=0):
    return np.random.default_rng(seed).integers(0, 50_000, (n, s)).astype(np.int32)


@pytest.fixture(params=["native", "numpy"])
def port_reader(request, monkeypatch):
    """Run the port side natively (g++-built library) and through its
    pure-numpy fallback."""
    if request.param == "numpy":
        monkeypatch.setattr(tokenshard, "_lib", None)
        monkeypatch.setattr(tokenshard, "_lib_failed", True)
    else:
        assert tokenshard.native_available()
    return request.param


def test_jax_written_shard_reads_identically_through_the_port(tmp_path, port_reader):
    data = rows()
    path = str(tmp_path / "a.tshrd")
    jax_ts.write_shard(path, data)
    ts = tokenshard.TokenShard(path)
    assert (ts.n_seqs, ts.seq_len) == data.shape
    idx = np.array([40, 0, 7, 7, 13], dtype=np.uint64)
    np.testing.assert_array_equal(ts.batch(idx), data[idx.astype(np.int64)])
    for epoch, worker in ((0, 0), (3, 1)):
        np.testing.assert_array_equal(
            ts.shuffled_indices(11, epoch, worker),
            jax_ts.TokenShard(path).shuffled_indices(11, epoch, worker),
        )
    ts.close()


def test_port_written_shard_reads_identically_through_jax(tmp_path, port_reader):
    data = rows(seed=1)
    path = str(tmp_path / "b.tshrd")
    tokenshard.write_shard(path, data)
    with tokenshard.ShardWriter(str(tmp_path / "c.tshrd"), data.shape[1]) as w:
        w.append(data[:10])
        w.append(data[10:])
    ref = str(tmp_path / "ref.tshrd")
    jax_ts.write_shard(ref, data)
    for p in (path, str(tmp_path / "c.tshrd")):
        assert open(p, "rb").read() == open(ref, "rb").read()
        ts = jax_ts.TokenShard(p)
        np.testing.assert_array_equal(ts.batch(np.arange(len(data), dtype=np.uint64)), data)
        ts.close()


@pytest.mark.parametrize("start", [0, 1, 3, 7])
def test_shard_batcher_matches_jax(tmp_path, start, port_reader):
    path = str(tmp_path / "d.tshrd")
    jax_ts.write_shard(path, rows(n=53, s=16, seed=2))
    kw = dict(num_workers=2, grad_accum=2, per_device_batch=3, seed=5, holdout_rows=6)
    ours = pipeline.ShardBatcher(path, **kw)
    ref = jax_pipeline.ShardBatcher(path, **kw)
    assert ours.steps_per_epoch == ref.steps_per_epoch == 3
    mine, theirs = ours.iter_from(start), ref.iter_from(start)
    for _ in range(5):  # crosses an epoch boundary
        (t1, m1), (t2, m2) = next(mine), next(theirs)
        assert t1.shape == (2, 2, 3, 16)
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(ours.holdout_data(), ref.holdout_data())
    assert ours.holdout_data().shape == (6, 16)
    ours.close()
    ref.close()


def test_pad_corpus_matches_jax():
    texts = pipeline.synthetic_corpus(n_docs=40, seed=3)
    assert texts == jax_pipeline.synthetic_corpus(n_docs=40, seed=3)
    toks, mask = pipeline.pad_corpus(texts, ByteTokenizer(), 96)
    jtoks, jmask = jax_pipeline.pad_corpus(texts, JaxByteTokenizer(), 96)
    np.testing.assert_array_equal(toks, jtoks)
    np.testing.assert_array_equal(mask, jmask)
    assert (mask == 0).any() and (mask == 1).any()


def test_pack_corpus_to_shard_matches_jax(tmp_path):
    texts = pipeline.synthetic_corpus(n_docs=30, seed=4)
    with tokenshard.ShardWriter(str(tmp_path / "p.tshrd"), 64) as w:
        n = pipeline.pack_corpus_to_shard(texts, ByteTokenizer(), 64, w, flush_rows=7)
    ref = str(tmp_path / "ref.tshrd")
    jax_ts.write_shard(ref, jax_pipeline.pack_corpus(texts, JaxByteTokenizer(), 64))
    assert n == jax_ts.TokenShard(ref).n_seqs
    assert open(tmp_path / "p.tshrd", "rb").read() == open(ref, "rb").read()


def test_port_build_writes_nothing_under_csrc(tmp_path, monkeypatch):
    csrc = os.path.join(ROOT, "csrc")

    def listing():
        return {name: os.stat(os.path.join(csrc, name)).st_mtime_ns
                for name in os.listdir(csrc)}

    before = listing()
    monkeypatch.setattr(tokenshard, "_BUILD_ROOT", tmp_path / "build" / "tokenshard")
    monkeypatch.setattr(tokenshard, "_lib", None)
    monkeypatch.setattr(tokenshard, "_lib_failed", False)
    assert tokenshard.native_available()
    lib = tokenshard.lib_path()
    assert lib.exists() and lib.is_relative_to(tmp_path / "build" / "tokenshard")
    assert listing() == before
    # the checkout's own build goes to build/tokenshard/<hash>/, not csrc/
    monkeypatch.undo()
    assert str(tokenshard.lib_path()).startswith(os.path.join(ROOT, "build", "tokenshard"))
