"""The port's Dockerfile frontend against the JAX package's, case for case.

Every Dockerfile text in the frontend's own test files (and the example
Dockerfiles) goes through ``makisu_tpu_torch.dockerfile.parse_file`` and
``makisu_tpu.dockerfile.parse_file``: both give the same stages and
directives field for field, or both raise the same error. The text
micro-grammars (variable substitution, argument splitting, key=value
lists) get the same treatment on every string of their test file.
"""

import ast
import dataclasses
import pathlib
import re

import pytest

from makisu_tpu import dockerfile as ref
from makisu_tpu_torch import dockerfile as port

ROOT = pathlib.Path(__file__).resolve().parent.parent
_FROM_LINE = re.compile(r"^\s*FROM\s", re.I | re.M)
BUILD_ARGS = [None, {"TAG": "3.12", "VERSION": "1.2", "NAME": "web",
                     "BASE": "scratch", "key": "VAL"}]


def _string_constants(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), str(path))
    seen: dict[str, None] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            seen.setdefault(node.value)
    return list(seen)


def _dockerfiles() -> list[tuple[str, str]]:
    cases = []
    for name in ("test_dockerfile_parse.py", "test_dockerfile_text.py",
                 "test_dockerfile_heredoc.py"):
        texts = [s for s in _string_constants(ROOT / "tests" / name)
                 if _FROM_LINE.search(s)]
        cases += [(f"{name[5:-3]}-{i}", t) for i, t in enumerate(texts)]
    for example in ("hello", "multistage"):
        cases.append((f"examples-{example}",
                      (ROOT / "examples" / example / "Dockerfile")
                      .read_text()))
    return cases


DOCKERFILES = _dockerfiles()
TEXTS = _string_constants(ROOT / "tests" / "test_dockerfile_text.py")


def plain(obj):
    """A comparable form of parser output: dataclasses and plain objects
    become (class name, fields), recursively."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                {f.name: plain(getattr(obj, f.name))
                 for f in dataclasses.fields(obj)})
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return (type(obj).__name__,
                {k: plain(v) for k, v in vars(obj).items()})
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    return obj


def outcome(fn, *args):
    try:
        return "ok", plain(fn(*args))
    except Exception as e:  # noqa: BLE001 - the error is the outcome
        return "raised", type(e).__name__, str(e)


def test_cases_were_found():
    names = [n for n, _ in DOCKERFILES]
    assert sum(n.startswith("dockerfile_parse") for n in names) >= 15
    assert sum(n.startswith("dockerfile_heredoc") for n in names) >= 15
    assert len(TEXTS) >= 40


@pytest.mark.parametrize("build_args", BUILD_ARGS,
                         ids=["no-args", "build-args"])
@pytest.mark.parametrize("name,text", DOCKERFILES,
                         ids=[n for n, _ in DOCKERFILES])
def test_parse_file_matches_reference(name, text, build_args):
    want = outcome(ref.parse_file, text,
                   None if build_args is None else dict(build_args))
    got = outcome(port.parse_file, text,
                  None if build_args is None else dict(build_args))
    assert got == want


def test_parse_file_parses_the_examples():
    for name, text in DOCKERFILES:
        if name.startswith("examples-"):
            assert outcome(port.parse_file, text, None)[0] == "ok"


M = {"key": "VAL", "VAL": "VAL2", "test_VAL": "VAL3",
     "VAL_test": "VAL4", "VAL2": "VAL5"}


@pytest.mark.parametrize("text", TEXTS, ids=range(len(TEXTS)))
def test_text_grammars_match_reference(text):
    for fn_name, extra in (("replace_variables", (M,)),
                           ("replace_variables", ({},)),
                           ("split_args", (False,)),
                           ("split_args", (True,)),
                           ("parse_key_vals", ())):
        want = outcome(getattr(ref, fn_name), text, *extra)
        got = outcome(getattr(port, fn_name), text, *extra)
        assert got == want, fn_name


def test_parse_duration_matches_reference():
    for text in ("336h", "0s", "1h30m", "45s", "1m", "2h0m5s", "bogus",
                 "10", "-1s"):
        assert outcome(port.parse_duration, text) == \
            outcome(ref.parse_duration, text)
