"""The port's safetensors reader and writer
(nanodiloco_tpu_torch/models/safetensors_io.py) against the
``safetensors`` package, both ways: the package reads what the port
writes and the port reads what the package writes, every dtype bit for
bit (exact equality: the files hold raw bytes, nothing is computed), a
file with ``__metadata__``, an empty-shape tensor and a zero-element one,
and a bf16 file from ``safetensors.torch.save_file``. For the same
tensors (and at most one metadata key, whose order the package does not
fix) the two write the same bytes. Inputs are numpy-seeded."""

import json
import struct

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as pkg_load
from safetensors.torch import save_file as pkg_save

from nanodiloco_tpu_torch.models import safetensors_io as st

RNG_SEED = 0


def tensors() -> dict[str, torch.Tensor]:
    """One tensor per dtype the reader knows, from a numpy generator,
    plus a 0-d and a zero-element one."""
    rng = np.random.default_rng(RNG_SEED)
    f = rng.standard_normal((3, 5)).astype(np.float32)
    out = {
        "f32": torch.from_numpy(f),
        "f64": torch.from_numpy(rng.standard_normal(4)),
        "f16": torch.from_numpy(f.astype(np.float16)),
        # bf16 from float32 bits, rounded by torch
        "bf16": torch.from_numpy(rng.standard_normal((2, 7)).astype(np.float32)).bfloat16(),
        "i64": torch.from_numpy(rng.integers(-2**40, 2**40, 6)),
        "i32": torch.from_numpy(rng.integers(-2**30, 2**30, 5).astype(np.int32)),
        "i16": torch.from_numpy(rng.integers(-2**14, 2**14, 5).astype(np.int16)),
        "i8": torch.from_numpy(rng.integers(-128, 128, 9).astype(np.int8)),
        "u8": torch.from_numpy(rng.integers(0, 256, 9).astype(np.uint8)),
        "bool": torch.from_numpy(rng.integers(0, 2, 5).astype(bool)),
        "scalar": torch.tensor(3.25),
        "empty": torch.zeros((0, 4)),
    }
    return out


def assert_same(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_package_reads_what_the_port_writes(tmp_path):
    ts = tensors()
    st.save_file(ts, str(tmp_path / "port.safetensors"), metadata={"format": "pt"})
    assert_same(pkg_load(str(tmp_path / "port.safetensors")), ts)
    with safe_open(str(tmp_path / "port.safetensors"), framework="pt") as f:
        assert f.metadata() == {"format": "pt"}


def test_port_reads_what_the_package_writes(tmp_path):
    ts = tensors()
    pkg_save(ts, str(tmp_path / "pkg.safetensors"), metadata={"format": "pt", "note": "x"})
    f = st.SafetensorsFile(str(tmp_path / "pkg.safetensors"))
    assert f.metadata == {"format": "pt", "note": "x"}
    assert_same({k: f.get(k) for k in f.keys()}, ts)


def test_same_bytes_as_the_package(tmp_path):
    ts = tensors()
    for meta in (None, {"format": "pt"}):
        pkg_save(ts, str(tmp_path / "pkg.safetensors"), metadata=meta)
        st.save_file(ts, str(tmp_path / "port.safetensors"), metadata=meta)
        assert ((tmp_path / "pkg.safetensors").read_bytes()
                == (tmp_path / "port.safetensors").read_bytes()), meta


def test_bf16_file_from_torch_save_file_reads_as_its_bits(tmp_path):
    """A bf16 file as Meta's shards hold them: read as 16-bit patterns and
    viewed as bf16, never through float32 on the host."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32)).bfloat16()
    pkg_save({"model.layers.0.mlp.up_proj.weight": w}, str(tmp_path / "m.safetensors"))
    got = st.SafetensorsFile(str(tmp_path / "m.safetensors")).get(
        "model.layers.0.mlp.up_proj.weight")
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), w.view(torch.int16))


def test_numpy_writer_file_reads(tmp_path):
    """The JAX package's writer (safetensors.numpy) is read the same way."""
    rng = np.random.default_rng(2)
    arrs = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.integers(0, 9, 7).astype(np.int64)}
    np_save_file(arrs, str(tmp_path / "np.safetensors"))
    f = st.SafetensorsFile(str(tmp_path / "np.safetensors"))
    for k, v in arrs.items():
        np.testing.assert_array_equal(f.get(k).numpy(), v)


def test_streaming_writer_checks_its_plan(tmp_path):
    plan = [("x", torch.float32, (2, 2), lambda: torch.zeros(2, 3))]
    with pytest.raises(ValueError, match="planned"):
        st.write_file(str(tmp_path / "bad.safetensors"), plan)


def test_header_is_padded_and_data_contiguous(tmp_path):
    ts = tensors()
    st.save_file(ts, str(tmp_path / "p.safetensors"))
    raw = (tmp_path / "p.safetensors").read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    assert n % 8 == 0
    header = json.loads(raw[8:8 + n])
    spans = sorted(tuple(v["data_offsets"]) for v in header.values())
    assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # a hole in the data section is refused, as the package's validator does
    bad = dict(header)
    bad["f32"] = {**bad["f32"], "data_offsets": [bad["f32"]["data_offsets"][0] + 4,
                                                 bad["f32"]["data_offsets"][1]]}
    hdr = json.dumps(bad).encode()
    hdr += b" " * (-len(hdr) % 8)
    (tmp_path / "hole.safetensors").write_bytes(
        struct.pack("<Q", len(hdr)) + hdr + raw[8 + n:])
    with pytest.raises(ValueError, match="contiguous|offsets"):
        st.SafetensorsFile(str(tmp_path / "hole.safetensors"))
