"""The safetensors file format, read and written without the
``safetensors`` package (which the port does not depend on).

A file is 8 bytes of little-endian u64 header length N, then N bytes of
JSON ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` with an
optional ``"__metadata__"`` map of strings to strings, padded with
spaces to a multiple of 8, then the tensors' raw little-endian bytes.
Offsets count from the first byte after the header; the tensors lie
back to back with no gaps. The writer orders them as the ``safetensors``
package does (by dtype, widest first, then by name), so for the same
tensors and metadata it writes the same bytes.

Reads go through ``numpy.memmap`` and ``torch.frombuffer`` one tensor at
a time: a tensor's pages are read only when it is copied, and bf16 is
read as its 16-bit patterns (numpy has no bf16), never through float32
on the host. Writes stream one tensor at a time from a plan of
``(name, dtype, shape, produce)``, so a shard is never whole in memory.
"""

from __future__ import annotations

import json
import os
import struct
import warnings
from typing import Callable, Iterable

import numpy as np
import torch

#: safetensors dtype name -> torch dtype
DTYPES: dict[str, torch.dtype] = {
    "BOOL": torch.bool,
    "U8": torch.uint8,
    "I8": torch.int8,
    "I16": torch.int16,
    "U16": torch.uint16,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I32": torch.int32,
    "U32": torch.uint32,
    "F32": torch.float32,
    "F64": torch.float64,
    "I64": torch.int64,
    "U64": torch.uint64,
}
NAMES = {v: k for k, v in DTYPES.items()}
# the package's file order: dtypes widest first (this list reversed, as
# its dtype enum declares them), then names ascending
_ORDER = {name: i for i, name in enumerate(DTYPES)}
_MAX_HEADER = 100_000_000  # the package's own bound on a header


def dtype_name(dtype: torch.dtype) -> str:
    if dtype not in NAMES:
        raise ValueError(f"safetensors has no dtype for {dtype}")
    return NAMES[dtype]


def read_header(path: str) -> tuple[dict, int]:
    """``(header, data_start)``: the parsed JSON header (``__metadata__``
    included when present) and the byte offset of the data section.
    Raises ValueError on a malformed header or a data section that does
    not match its offsets."""
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", raw)
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header of {n} bytes is too large")
        header = json.loads(f.read(n))
    start = 8 + n
    spans = sorted(tuple(v["data_offsets"]) for k, v in header.items()
                   if k != "__metadata__")
    pos = 0
    for b, e in spans:
        if b != pos or e < b:
            raise ValueError(f"{path}: tensor data is not contiguous at byte {b}")
        pos = e
    if start + pos != os.path.getsize(path):
        raise ValueError(f"{path}: data section is {os.path.getsize(path) - start} "
                         f"bytes, its offsets say {pos}")
    return header, start


class SafetensorsFile:
    """Lazy reader over one file: ``keys()`` and ``metadata`` from the
    header alone, and ``get(name)``, a CPU tensor backed by a memory map
    of just that tensor's bytes (the map lives as long as the tensor;
    copy out of it, e.g. ``.to(device)``)."""

    def __init__(self, path: str):
        self.path = path
        self._header, self._start = read_header(path)
        self.metadata: dict[str, str] | None = self._header.pop("__metadata__", None)
        for name, info in self._header.items():
            if info["dtype"] not in DTYPES:
                raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, "
                                 f"which this reader does not know ({sorted(DTYPES)})")

    def keys(self) -> list[str]:
        return list(self._header)

    def get(self, name: str) -> torch.Tensor:
        if name not in self._header:
            raise KeyError(f"{self.path} has no tensor {name!r}")
        info = self._header[name]
        dtype, shape = DTYPES[info["dtype"]], tuple(info["shape"])
        b, e = info["data_offsets"]
        if e == b:
            return torch.empty(shape, dtype=dtype)
        mm = np.memmap(self.path, dtype=np.uint8, mode="r", offset=self._start + b,
                       shape=(e - b,))
        with warnings.catch_warnings():
            # the map is read-only; callers copy out of it, never write
            warnings.simplefilter("ignore", UserWarning)
            flat = torch.frombuffer(mm, dtype=dtype)
        return flat.reshape(shape)


Entry = tuple[str, torch.dtype, tuple[int, ...], Callable[[], torch.Tensor]]


def _tensor_bytes(t: torch.Tensor) -> memoryview:
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy())


def write_file(path: str, entries: Iterable[Entry],
               metadata: dict[str, str] | None = None) -> int:
    """Write a file from ``(name, dtype, shape, produce)`` entries; each
    ``produce()`` is called once, in file order, and must return a tensor
    of that dtype and shape (on any device). Returns the data bytes."""
    entries = sorted(entries, key=lambda en: (-_ORDER[dtype_name(en[1])], en[0]))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    pos = 0
    for name, dtype, shape, _ in entries:
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()
        header[name] = {"dtype": dtype_name(dtype), "shape": [int(s) for s in shape],
                        "data_offsets": [pos, pos + n]}
        pos += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name, dtype, shape, produce in entries:
            t = produce()
            if t.dtype != dtype or tuple(t.shape) != tuple(shape):
                raise ValueError(f"{name}: produced {t.dtype} {tuple(t.shape)}, planned "
                                 f"{dtype} {tuple(shape)}")
            f.write(_tensor_bytes(t))
    return pos


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: dict[str, str] | None = None) -> int:
    """Write a dict of tensors (each moved to the host as it is written)."""
    return write_file(
        path, [(k, t.dtype, tuple(t.shape), (lambda t=t: t)) for k, t in tensors.items()],
        metadata,
    )
