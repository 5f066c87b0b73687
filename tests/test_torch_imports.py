"""The port stands alone: no module of nanodiloco_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package nanodiloco_tpu
(only the tests import both); nor do the port's scripts
(``scripts/torch_*.py``). Checked on the source, so a module that is
never imported here is covered too."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "nanodiloco_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nanodiloco_tpu")


def imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_scan_sees_the_whole_port():
    assert len(FILES) > 10
    assert forbidden("nanodiloco_tpu.models") and forbidden("jax.numpy")
    assert not forbidden("nanodiloco_tpu_torch.models") and not forbidden("jaxtyping_free")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [n for n in imported_modules(path) if forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
