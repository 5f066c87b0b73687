"""Data pipeline: a copy of the numpy-only parts of
``nanodiloco_tpu/data/pipeline.py``: a synthetic corpus, packing into
fixed-length rows (in memory, or streamed into a tokenshard file), the
one-document-per-row padded layout, the texts of an HF ``datasets``
directory (``save_to_disk``; the ``datasets`` package is imported only
when one is read), and the deterministic per-worker batchers whose
batches come out as [W, accum, B, S]: ``DilocoBatcher`` over rows in
memory, ``ShardBatcher`` over a ``.tshrd`` file (written by
``scripts/torch_prepare_data.py``, which needs no ``datasets`` package
for its offline sources)."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from nanodiloco_tpu_torch.data.tokenizer import Tokenizer
from nanodiloco_tpu_torch.data.tokenshard import TokenShard, _py_shuffled_indices


def synthetic_corpus(n_docs: int = 2000, seed: int = 0) -> list[str]:
    """Deterministic pseudo-English corpus (zipfian vocabulary) for
    offline tests and benches."""
    rng = np.random.default_rng(seed)
    vocab = [
        "the", "of", "and", "to", "in", "a", "is", "that", "for", "it",
        "model", "data", "train", "step", "loss", "worker", "sync", "token",
        "mesh", "shard", "device", "batch", "grad", "outer", "inner", "ring",
    ]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    docs = []
    for _ in range(n_docs):
        n_words = int(rng.integers(20, 200))
        words = rng.choice(vocab, size=n_words, p=probs)
        docs.append(" ".join(words) + ".")
    return docs


def iter_hf_dataset_texts(
    path: str, split: str = "train", column: str = "text"
) -> Iterator[str]:
    """Stream texts from a ``datasets.save_to_disk`` directory one row at
    a time off the Arrow memory map (a corpus larger than host memory
    streams through), reading only ``column``."""
    try:
        from datasets import load_from_disk
    except ImportError as e:
        raise ImportError(
            f"reading the HF datasets directory {path!r} needs the datasets package; "
            "without it, make a .tshrd shard with scripts/torch_prepare_data.py"
        ) from e

    ds = load_from_disk(path)
    if hasattr(ds, "keys") and split in getattr(ds, "keys", lambda: [])():
        ds = ds[split]
    if hasattr(ds, "select_columns"):
        ds = ds.select_columns([column])
    for row in ds:
        yield row[column]


def load_hf_dataset_texts(path: str, split: str = "train", column: str = "text") -> list[str]:
    """``iter_hf_dataset_texts`` materialized, for corpora that fit in
    memory."""
    return list(iter_hf_dataset_texts(path, split, column))


def pack_corpus(
    texts: list[str], tokenizer: Tokenizer, seq_length: int = 1024
) -> np.ndarray:
    """Tokenize all docs (eos-separated) and pack the token stream into
    [N, seq_length] int32 rows. The trailing partial block is dropped."""
    stream: list[int] = []
    for t in texts:
        stream.extend(tokenizer.encode(t, add_eos=True))
    n = len(stream) // seq_length
    if n == 0:
        raise ValueError(
            f"corpus too small: {len(stream)} tokens < seq_length {seq_length}"
        )
    arr = np.asarray(stream[: n * seq_length], dtype=np.int32)
    return arr.reshape(n, seq_length)


def pack_corpus_to_shard(
    texts,
    tokenizer: Tokenizer,
    seq_length: int,
    writer,
    flush_rows: int = 1024,
) -> int:
    """Streaming tokenize -> pack: the same packing as ``pack_corpus``
    (eos-separated token stream cut into [seq_length] rows, trailing
    partial dropped) but emitted to a ``tokenshard.ShardWriter`` in
    ``flush_rows``-row blocks, so peak host memory is
    O(flush_rows x seq_length + one document) no matter how large the
    corpus — the past-RAM materialization path. ``texts`` is any
    iterable of documents (a file-walking generator keeps the source
    streaming too). Returns rows written; the shard
    is bit-identical to ``write_shard(pack_corpus(texts, ...))``."""
    if flush_rows < 1:
        raise ValueError(f"flush_rows must be >= 1; got {flush_rows}")
    buf: list[int] = []
    rows = 0
    total_tokens = 0  # all tokens seen, not just the unflushed remainder
    limit = flush_rows * seq_length
    for t in texts:
        enc = tokenizer.encode(t, add_eos=True)
        total_tokens += len(enc)
        buf.extend(enc)
        if len(buf) >= limit:
            n = len(buf) // seq_length
            block = np.asarray(buf[: n * seq_length], dtype=np.int32)
            writer.append(block.reshape(n, seq_length))
            rows += n
            del buf[: n * seq_length]
    n = len(buf) // seq_length
    if n:
        block = np.asarray(buf[: n * seq_length], dtype=np.int32)
        writer.append(block.reshape(n, seq_length))
        rows += n
    if rows == 0:
        raise ValueError(
            f"corpus too small: {total_tokens} tokens < seq_length "
            f"{seq_length}"
        )
    return rows


def pad_corpus(
    texts: list[str], tokenizer: Tokenizer, seq_length: int = 1024
) -> tuple[np.ndarray, np.ndarray]:
    """Reference-style layout: one document per row, truncated at
    seq_length (ref utils.py:50), padded to a multiple of 8 columns
    (ref main.py:84). Returns (tokens [N, S'], mask [N, S']) with pad
    positions masked OUT of the loss (fixing ref main.py:87)."""
    encoded = [tokenizer.encode(t)[:seq_length] for t in texts]
    encoded = [e for e in encoded if len(e) >= 2]
    max_len = max(len(e) for e in encoded)
    max_len = ((max_len + 7) // 8) * 8
    tokens = np.full((len(encoded), max_len), tokenizer.pad_id, dtype=np.int32)
    mask = np.zeros((len(encoded), max_len), dtype=np.int32)
    for i, e in enumerate(encoded):
        tokens[i, : len(e)] = e
        mask[i, : len(e)] = 1
    return tokens, mask


@dataclasses.dataclass
class DilocoBatcher:
    """Yields ([W, accum, B, S] tokens, same-shape mask) batches.

    Worker w reads the strided shard ``data[w::num_workers]`` with a
    per-epoch seeded permutation and drop-last semantics; fully
    reproducible from ``seed``."""

    data: np.ndarray                 # [N, S] int32
    num_workers: int
    grad_accum: int
    per_device_batch: int
    seed: int = 1337
    mask: np.ndarray | None = None   # [N, S]; None -> all-ones

    def __post_init__(self) -> None:
        if self.data.ndim != 2:
            raise ValueError(f"data must be [N, S]; got {self.data.shape}")
        self._shards = [
            np.arange(w, len(self.data), self.num_workers)
            for w in range(self.num_workers)
        ]
        per_step = self.grad_accum * self.per_device_batch
        self.steps_per_epoch = min(len(s) for s in self._shards) // per_step
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"shards of {min(len(s) for s in self._shards)} sequences cannot "
                f"fill one inner step of {per_step} ({self.grad_accum} microbatches "
                f"x {self.per_device_batch})"
            )

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """One pass over every worker's shard, shuffled per (seed, epoch,
        worker), trailing remainder dropped."""
        W, A, B = self.num_workers, self.grad_accum, self.per_device_batch
        S = self.data.shape[1]
        per_step = A * B
        orders = [
            self._shards[w][
                np.random.default_rng((self.seed, epoch, w)).permutation(len(self._shards[w]))
            ]
            for w in range(W)
        ]
        for step in range(start_step, self.steps_per_epoch):
            tokens = np.empty((W, A, B, S), dtype=np.int32)
            mask = np.empty((W, A, B, S), dtype=np.int32)
            for w in range(W):
                idx = orders[w][step * per_step : (step + 1) * per_step]
                tokens[w] = self.data[idx].reshape(A, B, S)
                mask[w] = (
                    self.mask[idx].reshape(A, B, S)
                    if self.mask is not None
                    else np.ones((A, B, S), np.int32)
                )
            yield tokens, mask

    def iter_from(self, global_step: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Endless stream positioned at ``global_step`` inner steps."""
        epoch, offset = divmod(global_step, self.steps_per_epoch)
        while True:
            yield from self.epoch(epoch, start_step=offset)
            epoch, offset = epoch + 1, 0

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return self.iter_from(0)


@dataclasses.dataclass
class ShardBatcher:
    """DilocoBatcher backed by the native tokenshard reader
    (csrc/tokenshard.cpp): mmap'd rows, threaded gather, and the
    in-library deterministic shuffle. Same [W, accum, B, S] output
    contract; batch ORDER differs from DilocoBatcher (different PRNG) but
    is itself fully deterministic from the seed on every host."""

    path: str
    num_workers: int
    grad_accum: int
    per_device_batch: int
    seed: int = 1337
    holdout_rows: int = 0            # trailing rows reserved for evaluation

    def __post_init__(self) -> None:
        self._ts = TokenShard(self.path)
        self.seq_len = self._ts.seq_len
        self._n_train = self._ts.n_seqs - self.holdout_rows
        if self._n_train <= 0:
            raise ValueError(
                f"holdout_rows={self.holdout_rows} leaves no training rows "
                f"(shard has {self._ts.n_seqs})"
            )
        n_shard = min(
            len(range(w, self._n_train, self.num_workers))
            for w in range(self.num_workers)
        )
        per_step = self.grad_accum * self.per_device_batch
        self.steps_per_epoch = n_shard // per_step
        self._n_shard = n_shard
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"shards of {n_shard} sequences cannot fill one inner step of "
                f"{per_step} ({self.grad_accum} x {self.per_device_batch})"
            )

    def epoch(self, epoch: int, start_step: int = 0) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        W, A, B, S = self.num_workers, self.grad_accum, self.per_device_batch, self.seq_len
        per_step = A * B
        orders = []
        for w in range(W):
            # permute the worker's strided shard positions, then map to
            # global row ids (w + W * local)
            if self._ts._handle is not None:
                local = np.empty(self._n_shard, dtype=np.uint64)
                self._ts._lib.ts_shuffled_indices(
                    self._n_shard, self.seed, epoch, w, local.ctypes.data
                )
            else:
                local = _py_shuffled_indices(self._n_shard, self.seed, epoch, w)
            orders.append(np.uint64(w) + np.uint64(W) * local)
        for step in range(start_step, self.steps_per_epoch):
            tokens = np.empty((W, A, B, S), dtype=np.int32)
            for w in range(W):
                idx = orders[w][step * per_step : (step + 1) * per_step]
                tokens[w] = self._ts.batch(idx).reshape(A, B, S)
            yield tokens, np.ones_like(tokens)

    def iter_from(self, global_step: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """O(1)-skip endless stream (see DilocoBatcher.iter_from)."""
        epoch, offset = divmod(global_step, self.steps_per_epoch)
        while True:
            yield from self.epoch(epoch, start_step=offset)
            epoch, offset = epoch + 1, 0

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        return self.iter_from(0)

    def holdout_data(self) -> np.ndarray:
        """The reserved trailing rows [holdout_rows, S] (never trained on)."""
        if not self.holdout_rows:
            return np.empty((0, self.seq_len), np.int32)
        idx = np.arange(self._n_train, self._ts.n_seqs, dtype=np.uint64)
        return self._ts.batch(idx)

    def close(self) -> None:
        self._ts.close()
