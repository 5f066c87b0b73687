"""ctypes bindings for the native tokenshard reader (csrc/tokenshard.cpp).

A copy of ``nanodiloco_tpu/data/tokenshard.py`` (jax-free; the JAX
package's ``__init__`` imports jax, so the port keeps its own) over the
same C++ source and the same file format, so a shard written by either
package reads identically through the other.

The shared library is built on first use with g++ into
``build/tokenshard/<source hash>/`` at the root of the checkout, never
into ``csrc/``, where the JAX package builds its own copy: two packages
must not rebuild one file under each other. Every call degrades to a
pure-numpy implementation when no compiler is available, so the port
never hard-depends on the native layer.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "csrc" / "tokenshard.cpp"
_BUILD_ROOT = _ROOT / "build" / "tokenshard"
_CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_failed = False

_MAGIC = b"TSHRD\x01\x00\x00"
_HEADER = 24


def lib_path() -> Path:
    """``build/tokenshard/<hash of the source and flags>/libtokenshard.so``."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / "libtokenshard.so"


def _build_and_load() -> ctypes.CDLL | None:
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            path = lib_path()
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                # atomic install: a concurrent reader never loads a partial file
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                    check=True, capture_output=True,
                )
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            lib.ts_write.restype = ctypes.c_int
            lib.ts_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                     ctypes.c_uint64, ctypes.c_uint64]
            lib.ts_open.restype = ctypes.c_void_p
            lib.ts_open.argtypes = [ctypes.c_char_p]
            lib.ts_n_seqs.restype = ctypes.c_uint64
            lib.ts_n_seqs.argtypes = [ctypes.c_void_p]
            lib.ts_seq_len.restype = ctypes.c_uint64
            lib.ts_seq_len.argtypes = [ctypes.c_void_p]
            lib.ts_close.argtypes = [ctypes.c_void_p]
            lib.ts_gather.restype = ctypes.c_int
            lib.ts_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_uint64, ctypes.c_void_p, ctypes.c_int]
            lib.ts_shuffled_indices.argtypes = [
                ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
                ctypes.c_uint64, ctypes.c_void_p,
            ]
            _lib = lib
        except Exception:
            _lib_failed = True
            _lib = None
        return _lib


def native_available() -> bool:
    return _build_and_load() is not None


def write_shard(path: str, data: np.ndarray) -> None:
    """Write [N, S] int32 tokens to a tokenshard file."""
    data = np.ascontiguousarray(data, dtype=np.int32)
    if data.ndim != 2:
        raise ValueError(f"data must be [N, S]; got {data.shape}")
    lib = _build_and_load()
    if lib is not None:
        rc = lib.ts_write(path.encode(), data.ctypes.data, data.shape[0], data.shape[1])
        if rc != 0:
            raise OSError(f"ts_write failed with code {rc} for {path}")
        return
    with open(path, "wb") as f:  # numpy fallback, same format
        f.write(_MAGIC)
        f.write(np.asarray(data.shape, dtype=np.uint64).tobytes())
        f.write(data.tobytes())


class ShardWriter:
    """Append-mode tokenshard writer with bounded memory: open, append
    [K, S] row blocks as a streaming tokenizer produces them, and
    ``close()`` patches the final row count into the header — so a
    corpus larger than host RAM can be materialized without ever holding
    it. The resulting file is byte-identical to
    ``write_shard`` of the concatenated rows (same header layout,
    csrc/tokenshard.cpp:15-19; appends are plain I/O, so no native-layer
    dependence).

    Writes go to ``path + ".tmp"`` and an atomic ``os.replace`` installs
    the file only on a successful close — a failed or aborted run can
    never truncate a previously good shard at ``path`` or leave a
    valid-looking partial one behind (a crashed process may leave the
    ``.tmp`` file; it is overwritten by the next attempt). As a context
    manager, an exception inside the block discards the temp file."""

    def __init__(self, path: str, seq_len: int):
        if seq_len < 1:
            raise ValueError(f"seq_len must be >= 1; got {seq_len}")
        self.path = path
        self.seq_len = int(seq_len)
        self.n_seqs = 0
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._f.write(_MAGIC)
        self._f.write(np.asarray([0, self.seq_len], dtype=np.uint64).tobytes())

    def append(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, dtype=np.int32)
        if rows.ndim != 2 or rows.shape[1] != self.seq_len:
            raise ValueError(
                f"rows must be [K, {self.seq_len}]; got {rows.shape}"
            )
        self._f.write(rows.tobytes())
        self.n_seqs += int(rows.shape[0])

    def close(self, commit: bool = True) -> None:
        if self._f.closed:
            return
        self._f.flush()
        self._f.seek(8)
        self._f.write(np.asarray([self.n_seqs], dtype=np.uint64).tobytes())
        self._f.close()
        if commit:
            os.replace(self._tmp, self.path)
        else:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        self.close(commit=exc_type is None)


class TokenShard:
    """Reader for one shard file: mmap'd rows + deterministic shuffling.

    ``batch(indices)`` gathers rows into a fresh [len(indices), S] array
    (threaded memcpy natively); ``shuffled_indices(seed, epoch, worker)``
    is the C++ Fisher-Yates (or a bit-identical numpy re-implementation
    in fallback mode — both derive from splitmix64, so mixing native and
    fallback hosts still yields identical batch order).
    """

    def __init__(self, path: str):
        self.path = path
        self._lib = _build_and_load()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.ts_open(path.encode())
            if not self._handle:
                raise OSError(f"cannot open tokenshard {path}")
            self.n_seqs = int(self._lib.ts_n_seqs(self._handle))
            self.seq_len = int(self._lib.ts_seq_len(self._handle))
        else:
            with open(path, "rb") as f:
                header = f.read(_HEADER)
            if header[:8] != _MAGIC:
                raise OSError(f"bad magic in {path}")
            n, s = np.frombuffer(header[8:], dtype=np.uint64)
            self.n_seqs, self.seq_len = int(n), int(s)
            self._mm = np.memmap(path, dtype=np.int32, mode="r", offset=_HEADER,
                                 shape=(self.n_seqs, self.seq_len))

    def batch(self, indices: np.ndarray, n_threads: int = 0) -> np.ndarray:
        indices = np.ascontiguousarray(indices, dtype=np.uint64)
        if self._handle is not None:
            out = np.empty((len(indices), self.seq_len), dtype=np.int32)
            rc = self._lib.ts_gather(
                self._handle, indices.ctypes.data, len(indices),
                out.ctypes.data, n_threads,
            )
            if rc != 0:
                raise IndexError(f"tokenshard index out of range (rc={rc})")
            return out
        if (indices >= self.n_seqs).any():
            raise IndexError("tokenshard index out of range")
        return np.asarray(self._mm[indices.astype(np.int64)])

    def shuffled_indices(self, seed: int, epoch: int, worker: int) -> np.ndarray:
        out = np.empty(self.n_seqs, dtype=np.uint64)
        if self._handle is not None:
            self._lib.ts_shuffled_indices(self.n_seqs, seed, epoch, worker,
                                          out.ctypes.data)
            return out
        return _py_shuffled_indices(self.n_seqs, seed, epoch, worker)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ts_close(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass


def _splitmix64(state: np.uint64) -> tuple[np.uint64, np.uint64]:
    with np.errstate(over="ignore"):
        state = np.uint64(state + np.uint64(0x9E3779B97F4A7C15))
        z = state
        z = np.uint64((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9))
        z = np.uint64((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB))
        return state, np.uint64(z ^ (z >> np.uint64(31)))


def _py_shuffled_indices(n: int, seed: int, epoch: int, worker: int) -> np.ndarray:
    """Bit-identical to ts_shuffled_indices in csrc/tokenshard.cpp."""
    out = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        s = np.uint64(
            np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
            + np.uint64(epoch) * np.uint64(0xBF58476D1CE4E5B9)
            + np.uint64(worker) * np.uint64(0x94D049BB133111EB)
            + np.uint64(1)
        )
    for i in range(n, 1, -1):
        s, r = _splitmix64(s)
        j = int(r % np.uint64(i))
        out[i - 1], out[j] = out[j], out[i - 1]
    return out
