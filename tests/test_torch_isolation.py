"""The port stands alone: no module of makisu_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package; its telemetry readers,
the worker client and the ``alerts``/``sessions`` subcommands never
import torch. The import scan is static (AST): the interpreter may have
JAX loaded already, so sys.modules proves nothing. The port's native libraries build from its own ``csrc/``: their
sources include nothing outside it, and building, loading and running
them opens, compiles or loads nothing under the JAX package's
``native/`` directory (checked with an audit hook)."""

import ast
import pathlib
import re
import subprocess
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
            "makisu_tpu_torch/utils/events.py",
            "makisu_tpu_torch/utils/metrics.py",
            "makisu_tpu_torch/utils/ledger.py",
            "makisu_tpu_torch/utils/resources.py",
            "makisu_tpu_torch/utils/traceexport.py",
            "makisu_tpu_torch/utils/profiler.py",
            "makisu_tpu_torch/utils/flightrecorder.py",
            "makisu_tpu_torch/utils/history.py",
            "makisu_tpu_torch/utils/deviceprobe.py",
            "makisu_tpu_torch/utils/explain.py",
            "makisu_tpu_torch/utils/alerts.py",
            "makisu_tpu_torch/fleet/slo.py",
            "makisu_tpu_torch/chunker/service.py",
            "makisu_tpu_torch/worker/client.py",
            "makisu_tpu_torch/worker/server.py",
            "makisu_tpu_torch/cache/kv.py",
            "makisu_tpu_torch/cache/chunks.py",
            "makisu_tpu_torch/serve/__init__.py",
            "makisu_tpu_torch/serve/recipe.py",
            "makisu_tpu_torch/serve/server.py",
            "makisu_tpu_torch/serve/client.py",
            "makisu_tpu_torch/fleet/peers.py",
            "makisu_tpu_torch/fleet/kv.py",
            "makisu_tpu_torch/fleet/scheduler.py",
            "makisu_tpu_torch/fleet/server.py",
            "makisu_tpu_torch/fleet/doctor.py",
            "makisu_tpu_torch/tools/loadgen.py",
            "makisu_tpu_torch/tools/top.py",
            "makisu_tpu_torch/tools/mkrootfs.py",
            "makisu_tpu_torch/parallel/mesh.py",
            "makisu_tpu_torch/parallel/pipeline.py",
            "makisu_tpu_torch/parallel/distributed.py",
            "makisu_tpu_torch/parallel/dryrun.py",
            "makisu_tpu_torch/analysis/engine.py",
            "makisu_tpu_torch/analysis/rules.py",
            "chip_smoke.py"} <= rel


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = [m for m in imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{path.name} imports {bad}"


# A string that names a module of the JAX package ("makisu_tpu.ops...",
# the sys.modules lookups of the forensics layer): a lookup by name
# reaches the reference without an import statement.
_NAMES_REFERENCE = re.compile(r"(?<![\w/.-])makisu_tpu\.\w")


def reference_module_strings(path: pathlib.Path) -> list[str]:
    return [node.value
            for node in ast.walk(ast.parse(path.read_text(), str(path)))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and _NAMES_REFERENCE.search(node.value)]


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_string_names_a_reference_module(path):
    assert reference_module_strings(path) == []


def test_reference_module_strings_are_caught(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text('import sys\n'
                     'a = sys.modules.get("makisu_tpu.ops.backend")\n'
                     'b = sys.modules.get("makisu_tpu_torch.ops.backend")\n'
                     'c = "makisu_tpu/ops/backend.py"\n')
    assert reference_module_strings(probe) == ["makisu_tpu.ops.backend"]


_READERS_SCRIPT = """
import json, os, sys
from makisu_tpu_torch import cli
from makisu_tpu_torch.utils import (deviceprobe, events, flightrecorder,
                                    history, ledger, metrics, profiler)
d = sys.argv[1]
os.environ["MAKISU_TPU_DEVICE_SESSIONS_DIR"] = os.path.join(d, "sessions")
deviceprobe.append_record({"schema": deviceprobe.SCHEMA, "ts": 1.0,
                           "verdict": "wedged", "wedged_phase": "context_init",
                           "attachment": {"key": "k" * 32, "vars": []}})
reg = metrics.MetricsRegistry()
token = metrics.set_build_registry(reg)
writer = ledger.LedgerWriter(os.path.join(d, "L.jsonl"), trace_id=reg.trace_id,
                             command="build")
sink = events.add_sink(writer)
with metrics.span("build"):
    with metrics.span("commit_layer"):
        metrics.counter_add("makisu_layer_commits_total")
        ledger.record("kv", "abc", "miss", reason="absent")
    bundle = flightrecorder.FlightRecorder().bundle("failure", reg)
events.emit("build_end", exit_code=0)
events.reset_sink(sink)
writer.close()
metrics.reset_build_registry(token)
rep = reg.report()
rep["command"], rep["exit_code"] = "build", 0
metrics.write_json_atomic(os.path.join(d, "R.json"), rep)
metrics.write_json_atomic(os.path.join(d, "B.json"), bundle)
history.append_record(os.path.join(d, "H.jsonl"),
                      history.record_from_report(rep, command="build"))
prof = profiler.SamplingProfiler(hz=0.0)
profiler.write_artifact(os.path.join(d, "P.json"),
                        prof.snapshot(command="build"))
for argv in (["report", "R.json"], ["explain", "L.jsonl"],
             ["history", "H.jsonl"], ["profile", "P.json"],
             ["doctor", "B.json"], ["doctor", "--device", "sessions"]):
    argv = [argv[0]] + [a if a.startswith("-") else os.path.join(d, a)
                        for a in argv[1:]]
    assert cli.main(argv) == 0, argv
assert "torch" not in sys.modules, "torch imported"
print("clean")
"""


def test_readers_import_no_torch(tmp_path):
    """report, explain, history, profile, doctor and doctor --device, and
    the telemetry that writes their inputs (the deviceprobe ledger among
    them), never import torch: the counterpart of the reference's rule
    that they pay no JAX import."""
    import subprocess
    out = subprocess.run([sys.executable, "-c", _READERS_SCRIPT,
                          str(tmp_path)], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_alerts_and_sessions_import_no_torch(tmp_path):
    """The worker client and the ``alerts``/``sessions`` subcommands
    never import torch (here against a socket that is not there, so each
    exits with its error message)."""
    script = ("import sys\n"
              "from makisu_tpu_torch import cli\n"
              "from makisu_tpu_torch.worker import WorkerClient\n"
              "for verb in ('alerts', 'sessions'):\n"
              "    try:\n"
              "        cli.main([verb, sys.argv[1]])\n"
              "    except SystemExit as e:\n"
              "        assert 'cannot fetch' in str(e) or 'failed' in "
              "str(e), e\n"
              "assert 'torch' not in sys.modules, 'torch imported'\n"
              "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", script,
                          str(tmp_path / "none.sock")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


def test_storage_readers_import_no_torch(tmp_path):
    """``du`` and ``doctor --storage`` (the census, the audit, the scrub,
    the content store's dry run) never import torch: the chunk store
    loads the chunker only where a build binds its chunk observer."""
    script = ("import sys\n"
              "from makisu_tpu_torch import cli\n"
              "assert cli.main(['du', '--storage', sys.argv[1], "
              "'--json']) == 0\n"
              "assert cli.main(['doctor', '--storage', sys.argv[1], "
              "'--eviction-budget', '5']) == 0\n"
              "assert 'torch' not in sys.modules, 'torch imported'\n"
              "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("clean")


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


def test_package_data_ships_every_native_source():
    """An installed port builds its libraries from ``csrc/``: every file
    ``ops/_build.py`` compiles or includes matches a package-data pattern
    of ``pyproject.toml``, and so does the analysis baseline."""
    import fnmatch
    import tomllib

    from makisu_tpu_torch.ops import _build

    with open(ROOT / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    names = {f"csrc/{src}" for group in (_build.SOURCES, _build.HOST_SOURCES)
             for srcs in group.values() for src in srcs}
    names |= {f"csrc/{p.name}" for p in CSRC.iterdir()}
    shipped = data["makisu_tpu_torch"]
    assert [n for n in sorted(names)
            if not any(fnmatch.fnmatch(n, pat) for pat in shipped)] == []
    assert data["makisu_tpu_torch.analysis"] == ["baseline.json"]
