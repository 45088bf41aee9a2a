"""Per-build environment expansion.

Steps must never mutate ``os.environ``: a worker runs many builds in one
process, and ARG/ENV exports from concurrent builds would interleave
(the reference can afford process-env mutation only because it is
one-process-per-build, base_step.go:95-108). Each BuildContext carries
its own env dict; this helper expands ``$VAR``/``${VAR}`` against it
with the same leave-unknown-untouched semantics as os.path.expandvars.
"""

from __future__ import annotations

import re

# re.ASCII matches posixpath._varprog: non-ASCII "word" characters are
# not variable names to expandvars, so not to us either.
_VAR = re.compile(r"\$(\w+|\{[^}]*\})", re.ASCII)


def expand(text: str, env: dict[str, str]) -> str:
    """Expand $VAR and ${VAR} from ``env``; unknown vars stay verbatim."""
    def sub(m: re.Match) -> str:
        name = m.group(1)
        if name.startswith("{"):
            name = name[1:-1]
        return env.get(name, m.group(0))
    return _VAR.sub(sub, text)
