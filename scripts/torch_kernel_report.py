#!/usr/bin/env python3
"""Build the port's CUDA kernels of one checkout and report, per kernel
instance, what the compiler made of it: ptxas' registers and spill bytes,
whether ptxas serialized its wgmma instructions (warning C7512 or C7513:
the warning's code, else false), and in its SASS the local-memory loads and
stores (LDL, STL), the wgmma instructions (HGMMA), the waits on them
(WARPGROUP.DEPBAR: one after every HGMMA where ptxas serialized them) and
the highest register a thread touches (max_register: above ``registers``,
ptxas' count at launch, where a warpgroup raised its limit with
setmaxnreg).

    python3 scripts/torch_kernel_report.py [--tree <checkout>] [--source flash_attention_tc ...]

``--tree`` is the root of a checkout of this repo (default: this one); its
kernels build into its own ``build/kernels/<hash>/``. ``--source`` names
one or more sources of ``csrc/`` (without ``.cu``). Prints one JSON line:
``{"tree", "source", "build_s", "kernels": {name<HD>: {"registers",
"spill_stores", "spill_loads", "serialized_wgmma", "LDL", "STL", "HGMMA",
"DEPBAR", "max_register"}}}``. Needs ``nvcc`` and ``cuobjdump`` (the CUDA toolkit of the
card's machine); it launches nothing, so it needs no card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# a kernel template's name and instance in a demangled symbol
_INSTANCE = re.compile(r"(\w+_kernel<[^>]+>)")


def _demangle(symbols: list[str]) -> list[str]:
    out = subprocess.run(["c++filt"], input="\n".join(symbols), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return [m.group(1) if (m := _INSTANCE.search(name)) else name for name in out]


def ptxas_report(log: str) -> dict[str, dict]:
    """Registers, spills and serialized wgmma (C7512, C7513) per kernel from
    an ``-Xptxas=-v`` log."""
    entries, current = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            current = m.group(1)
            entries.setdefault(current, {"serialized_wgmma": False})
        elif m := re.search(r"Function properties for (\S+)", line):
            # a device function's own block (mbar_timeout) is not the kernel's
            current = m.group(1) if m.group(1) in entries else None
        elif current and (m := re.search(r"Used (\d+) registers", line)):
            entries[current]["registers"] = int(m.group(1))
        elif current and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                         line)):
            entries[current]["spill_stores"] = int(m.group(1))
            entries[current]["spill_loads"] = int(m.group(2))
        if (code := re.search(r"\((C751[23])\)", line)) and (
                m := re.search(r"function '(\S+)'", line)):
            entries.setdefault(m.group(1), {})["serialized_wgmma"] = code.group(1)
    return dict(zip(_demangle(list(entries)), entries.values()))


def sass_report(lib: Path) -> dict[str, dict]:
    """LDL, STL, HGMMA and WARPGROUP.DEPBAR counts and the highest register
    per kernel in a library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            current = m.group(1)
            counts[current] = {"LDL": 0, "STL": 0, "HGMMA": 0, "DEPBAR": 0, "max_register": -1}
        elif current:
            for op in ("LDL", "STL", "HGMMA", "DEPBAR"):
                if re.search(rf"\b{op}\b", line):
                    counts[current][op] += 1
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            counts[current]["max_register"] = max([counts[current]["max_register"], *regs])
    return dict(zip(_demangle(list(counts)), counts.values()))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--source", nargs="+", default=["flash_attention_tc"])
    args = ap.parse_args()
    tree = str(args.tree.resolve())
    sys.path.insert(0, tree)
    from nanodiloco_tpu_torch.ops.cuda import build

    if not build.__file__.startswith(tree):
        raise SystemExit(f"imported {build.__file__}, not the checkout at {tree}")
    report = build.build_all()
    out = build.build_dir()
    kernels = {}
    for source in args.source:
        kernels.update(ptxas_report((out / f"{source}.build.log").read_text()))
        for name, counts in sass_report(out / f"lib{source}.so").items():
            kernels.setdefault(name, {}).update(counts)
    print(json.dumps({"tree": tree, "source": args.source,
                      "build_s": {k: r["seconds"] for k, r in report.items()},
                      "kernels": dict(sorted(kernels.items()))}))


if __name__ == "__main__":
    main()
