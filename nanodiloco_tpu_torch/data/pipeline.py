"""Data pipeline: a copy of the numpy-only parts of
``nanodiloco_tpu/data/pipeline.py`` the classic training path uses:
a synthetic corpus, packing into fixed-length rows, and the deterministic
per-worker batcher whose batches come out as [W, accum, B, S]."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from nanodiloco_tpu_torch.data.tokenizer import Tokenizer


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
