"""The port stands alone: no module of makisu_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package. The scan is static (AST):
the interpreter may have JAX loaded already, so sys.modules proves
nothing. The port's native libraries build from its own ``csrc/``: their
sources include nothing outside it, and building, loading and running
them opens, compiles or loads nothing under the JAX package's
``native/`` directory (checked with an audit hook)."""

import ast
import pathlib
import re
import sys

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
            "makisu_tpu_torch/registry/client.py",
            "makisu_tpu_torch/registry/transfer.py",
            "makisu_tpu_torch/tools/miniregistry.py",
            "makisu_tpu_torch/utils/httputil.py",
            "makisu_tpu_torch/utils/zstdio.py",
            "makisu_tpu_torch/docker/oci.py",
            "makisu_tpu_torch/native.py",
            "makisu_tpu_torch/utils/statcache.py",
            "makisu_tpu_torch/worker/__init__.py",
            "makisu_tpu_torch/worker/session.py",
            "makisu_tpu_torch/worker/snapshots.py",
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


CSRC = ROOT / "makisu_tpu_torch" / "csrc"


@pytest.mark.parametrize("path", sorted(CSRC.iterdir()),
                         ids=lambda p: p.name)
def test_csrc_includes_only_its_own_files(path):
    local = re.findall(r'#include\s+"([^"]+)"', path.read_text())
    assert all((CSRC / name).is_file() and "/" not in name
               for name in local), local


_seen: list = []  # audit events touching native/, while recording


def _audit(event, args):
    if _seen and event in ("open", "subprocess.Popen", "ctypes.dlopen"):
        text = " ".join(map(str, args[:2] if event == "open" else args))
        if str(ROOT / "native") in text or "native/lib" in text:
            _seen.append((event, text))


def test_native_route_reads_nothing_under_native(tmp_path, monkeypatch):
    """A fresh build of the port's libraries, their loading, and a layer
    through the native sink and the pgzip codec touch nothing under
    ``native/``."""
    import io
    import tarfile

    from makisu_tpu_torch import native, tario
    from makisu_tpu_torch.chunker import hasher
    from makisu_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(native, "_libs", {})
    if not getattr(sys, "_torch_isolation_hook", False):
        sys.addaudithook(_audit)
        sys._torch_isolation_hook = True
    _seen.append(None)  # start recording
    try:
        assert tario.resolve_backend("auto") == "pgzip"
        src = tmp_path / "f.bin"
        src.write_bytes(b"abc" * 100_000)
        info = tarfile.TarInfo("f.bin")
        info.size = 300_000
        with open(tmp_path / "out.gz", "wb") as out:
            sink = hasher.CPUHasher().open_layer(out, "pgzip-6-131072")
            assert sink.route == "native"
            with sink.open_tar() as tw:
                tario.write_entry(tw, str(src), info)
            sink.finish()
        blob = io.BytesIO()
        with tario.gzip_writer(blob, "pgzip-6-131072") as gz:
            gz.write(b"abc" * 100_000)
        built = sorted(p.name for p in (tmp_path / "build").glob("*.so"))
    finally:
        seen = _seen[1:]
        _seen.clear()  # stop recording
    assert [n.split("-")[0] for n in built] == ["liblayersink", "libpgzip"]
    assert seen == []
