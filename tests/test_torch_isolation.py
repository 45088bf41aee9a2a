"""The port stands alone: no module of makisu_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package. The scan is static (AST):
the interpreter may have JAX loaded already, so sys.modules proves
nothing."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "makisu_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "makisu_tpu")


def imported_modules(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def test_scan_covers_the_package():
    rel = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"makisu_tpu_torch/chunker/cdc.py",
            "makisu_tpu_torch/ops/gear_cuda.py",
            "chip_smoke.py"} <= rel


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


def test_prefix_is_not_mistaken_for_the_reference():
    assert not _forbidden("makisu_tpu_torch.ops.gear")
    assert _forbidden("makisu_tpu.ops.gear") and _forbidden("makisu_tpu")
    assert _forbidden("jax.numpy")
