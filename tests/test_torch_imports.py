"""The port stands alone: no module of nanodiloco_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package nanodiloco_tpu
(only the tests import both); nor do the port's scripts
(``scripts/torch_*.py``). Nor does any of them import the HF packages
(transformers, tokenizers, datasets, safetensors) at module level: the
card's machine has none of them, so each is imported only inside the
function that needs it. Checked on the source, so a module that is never
imported here is covered too."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = (sorted((ROOT / "nanodiloco_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "scripts").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "nanodiloco_tpu")
OPTIONAL = ("transformers", "tokenizers", "datasets", "safetensors")


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


def module_level_imports(path: Path) -> list[str]:
    """Imports executed when the module is imported: the top level and
    the bodies of top-level ``if``/``try``/``with``, not functions or
    classes."""
    names, todo = [], list(ast.parse(path.read_text(), filename=str(path)).body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif isinstance(node, (ast.If, ast.Try, ast.With)):
            for field in ("body", "orelse", "finalbody", "handlers"):
                todo += getattr(node, field, [])
        elif isinstance(node, ast.ExceptHandler):
            todo += node.body
    return names


def test_optional_scan_sees_module_level_only(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\ntry:\n    import datasets\nexcept ImportError:\n    pass\n"
                 "def g():\n    import transformers\n")
    assert sorted(module_level_imports(f)) == ["datasets", "os"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_level_hf_import(path):
    bad = [n for n in module_level_imports(path) if n.split(".")[0] in OPTIONAL]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at module level"


FLEET_MODULES = ["fleet/__init__.py", "fleet/router.py", "fleet/chaos.py", "fleet/autoscaler.py",
                 "fleet/disagg.py", "fleet/deploy.py", "obs/collector.py", "obs/slo.py",
                 "obs/forecast.py", "obs/dashboard.py", "obs/tracer.py", "obs/goodput.py"]


@pytest.mark.parametrize("rel", FLEET_MODULES)
def test_fleet_and_obs_plane_are_scanned_and_jax_free(rel):
    path = ROOT / "nanodiloco_tpu_torch" / rel
    assert path in FILES
    assert not [n for n in imported_modules(path) if forbidden(n)]


@pytest.mark.parametrize("argv", [["fleet"], ["obs-watch"], ["report", "merge-trace"],
                                  ["report", "trace"], ["report", "timeseries"],
                                  ["report", "dashboard"]], ids=" ".join)
def test_fleet_commands_are_ported(argv, capsys):
    """Each fleet command parses its flags (``--help`` exits 0) instead
    of refusing as not ported."""
    from nanodiloco_tpu_torch.__main__ import main

    with pytest.raises(SystemExit) as e:
        main([*argv, "--help"])
    assert e.value.code == 0
    assert "usage: nanodiloco_tpu_torch" in capsys.readouterr().out
    cli = (ROOT / "nanodiloco_tpu_torch" / "__main__.py").read_text()
    assert "NOT_PORTED" not in cli and "item 5b" not in cli
