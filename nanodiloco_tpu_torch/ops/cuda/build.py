"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``*.cu`` file under ``nanodiloco_tpu_torch/csrc/`` is compiled on
its own into a shared library with a plain C interface (no PyTorch
headers, so a build takes seconds, not minutes). Libraries land in
``build/kernels/<hash>/`` at the root of the checkout, where ``<hash>``
covers every source and the compiler flags: a second run reuses them, an
edited source builds anew. The sources are built at first use, never at
import, so the CPU tests import every module without a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler=-fPIC",
    "-Xptxas=-v",
)


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def build_dir() -> Path:
    """``build/kernels/<hash of sources, headers and flags>``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "kernels are built from nanodiloco_tpu_torch/csrc at first use"
    )


def build_all() -> dict[str, dict]:
    """Compile every source that has no library yet, one ``nvcc`` per
    source, all started together. Returns ``{name: {"seconds": float,
    "log": str}}`` for the sources built by this call (the log holds
    ptxas' register and shared-memory report). Raises on any failure."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in _sources():
        lib = out / f"lib{src.stem}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src.stem] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            lib,
            time.perf_counter(),
        )
    report, failed = {}, []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees a partial library
        (out / f"{name}.build.log").write_text(log)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built if needed)."""
    build_all()
    return ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
