"""Text-scanning primitives for the Dockerfile frontend.

Implements the three micro-grammars every directive shares, with the same
observable behavior as the reference's rune-level state machines
(lib/parser/dockerfile/replace_variables.go, split_args.go,
parse_key_values.go) but written as index-based recursive descent:

- ``replace_variables``: ``$var`` / ``${var}`` / ``${var:-def}`` /
  ``${var:+alt}`` substitution, with nesting (``${pre_$var}``) and
  backslash escapes. Unset variables are left as literal text.
- ``split_args``: whitespace splitting with double-quote grouping and
  backslash escapes; ``for_shell`` keeps quotes and isolates ``& | ;``
  runs as their own tokens.
- ``parse_key_vals``: ``K=V K2="v 2"`` pairs for ENV/LABEL/ARG.
"""

from __future__ import annotations

import re


class TextParseError(ValueError):
    """Malformed directive text (unbalanced quotes, bad ${} syntax, ...)."""


def is_key_char(c: str) -> bool:
    """Characters permitted in a variable/key name."""
    return c.isalnum() or c in "-_."


# ---------------------------------------------------------------------------
# Variable substitution
# ---------------------------------------------------------------------------

def replace_variables(text: str, variables: dict[str, str]) -> str:
    """Expand ``$var``-style references in ``text`` against ``variables``.

    Unset simple references stay literal (``$name`` / ``${name}``), matching
    docker's lenient behavior. ``\\$`` escapes a dollar; other backslashes
    pass through unchanged (a trailing backslash is dropped).
    """
    out: list[str] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == "\\":
            if i + 1 < n:
                nxt = text[i + 1]
                if nxt != "$":
                    out.append("\\")
                out.append(nxt)
                i += 2
            else:
                i += 1  # trailing backslash is swallowed
        elif c == "$":
            val, i = _reference(text, i + 1, variables)
            out.append(val)
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _reference(text: str, i: int, variables: dict[str, str]) -> tuple[str, int]:
    """Parse one reference starting just past ``$``. Returns (value, next_i)."""
    n = len(text)
    if i >= n:
        return "$", i
    if text[i] == "{":
        return _braced(text, i + 1, variables)
    # Simple form: first char is taken unconditionally, then greedy key chars.
    j = i + 1
    while j < n and is_key_char(text[j]):
        j += 1
    name = text[i:j]
    if name in variables:
        return variables[name], j
    return "$" + name, j


def _braced(text: str, i: int, variables: dict[str, str]) -> tuple[str, int]:
    """Parse a ``${...}`` body starting just past ``{``."""
    n = len(text)
    name_parts: list[str] = []
    while i < n:
        c = text[i]
        if c == "}":
            name = "".join(name_parts)
            if name in variables:
                return variables[name], i + 1
            return "${" + name + "}", i + 1
        if c == "$":
            # Nested reference contributes (possibly literal) text to the name.
            val, i = _reference(text, i + 1, variables)
            name_parts.append(val)
            continue
        if c == ":":
            name = "".join(name_parts)
            if not name:
                raise TextParseError("missing variable name before ':'")
            return _default_clause(text, i + 1, variables, name)
        name_parts.append(c)
        i += 1
    if not name_parts:
        raise TextParseError("unexpected end of input: missing variable name")
    raise TextParseError("missing close bracket after variable")


def _default_clause(text: str, i: int, variables: dict[str, str],
                    name: str) -> tuple[str, int]:
    """Parse ``:-default`` / ``:+alternate`` starting just past ``:``."""
    n = len(text)
    if i >= n or text[i] not in "-+":
        got = text[i] if i < n else "<end>"
        raise TextParseError(f"invalid default command after ':': {got}")
    cmd = text[i]
    i += 1
    val_parts: list[str] = []
    while i < n:
        c = text[i]
        if c == "\\":
            if i + 1 < n:
                nxt = text[i + 1]
                if nxt != "}":
                    val_parts.append("\\")
                val_parts.append(nxt)
                i += 2
                continue
            i += 1
            continue
        if c == "}":
            default = "".join(val_parts)
            if not default:
                raise TextParseError(f"missing value after ':{cmd}'")
            if cmd == "-":
                return variables.get(name, default), i + 1
            return (default if name in variables else ""), i + 1
        val_parts.append(c)
        i += 1
    raise TextParseError("missing close bracket after variable")


# ---------------------------------------------------------------------------
# Argument splitting
# ---------------------------------------------------------------------------

_SHELL_OPS = "&|;"


def split_args(text: str, for_shell: bool = False) -> list[str]:
    """Split directive arguments on whitespace with quote/escape handling.

    With ``for_shell=True`` (RUN/CMD/ENTRYPOINT shell form) double quotes are
    preserved in the output tokens and runs of ``& | ;`` become standalone
    tokens, so the command can be re-joined for ``sh -c`` verbatim.
    """
    args: list[str] = []
    cur: list[str] = []
    have_cur = False
    i, n = 0, len(text)

    def flush() -> None:
        nonlocal cur, have_cur
        if have_cur or cur:
            args.append("".join(cur))
        cur = []
        have_cur = False

    while i < n:
        c = text[i]
        if c.isspace():
            if have_cur:
                flush()
            i += 1
        elif c == '"':
            # Quoted span: becomes (part of) one token; must be followed by
            # whitespace, a shell operator, or end of input.
            if for_shell:
                cur.append('"')
            i += 1
            closed = False
            while i < n:
                q = text[i]
                if q == "\\":
                    if i + 1 < n:
                        nxt = text[i + 1]
                        if nxt != '"' or for_shell:
                            cur.append("\\")
                        cur.append(nxt)
                        i += 2
                    else:
                        i += 1
                    continue
                if q == '"':
                    closed = True
                    i += 1
                    break
                cur.append(q)
                i += 1
            if not closed:
                raise TextParseError(
                    f"unbalanced '\"' in arguments: {''.join(cur)}")
            if for_shell:
                cur.append('"')
            have_cur = True
            flush()
            if i < n and not text[i].isspace():
                if for_shell and text[i] in _SHELL_OPS:
                    continue
                raise TextParseError("missing whitespace after quoted argument")
        elif for_shell and c in _SHELL_OPS:
            if have_cur:
                flush()
            j = i
            while j < n and text[j] in _SHELL_OPS:
                j += 1
            args.append(text[i:j])
            i = j
        elif c == "\\":
            if i + 1 < n:
                nxt = text[i + 1]
                if not nxt.isspace() and nxt != '"':
                    cur.append("\\")
                cur.append(nxt)
                i += 2
            else:
                i += 1
            have_cur = True
        else:
            cur.append(c)
            have_cur = True
            i += 1
    if have_cur:
        flush()
    return args


# ---------------------------------------------------------------------------
# Key/value pairs
# ---------------------------------------------------------------------------

def parse_key_vals(text: str) -> dict[str, str]:
    """Parse ``K=V`` pairs separated by whitespace (ENV/LABEL/ARG form).

    Values may be double-quoted (quoted values may be empty and may contain
    spaces); unquoted values may use backslash escapes for spaces/quotes.
    Raises TextParseError on malformed input, including bare keys.
    """
    out: dict[str, str] = {}
    i, n = 0, len(text)
    while i < n:
        if text[i].isspace():
            i += 1
            continue
        # key
        j = i
        while j < n and is_key_char(text[j]):
            j += 1
        if j == i:
            raise TextParseError(
                f"invalid character in variable key: {text[i]!r}")
        key = text[i:j]
        if j >= n or text[j] != "=":
            raise TextParseError(f"expected '=<value>' after key: {key}")
        i = j + 1
        # value
        val_parts: list[str] = []
        if i < n and text[i] == '"':
            i += 1
            closed = False
            while i < n:
                c = text[i]
                if c == "\\":
                    if i + 1 < n:
                        nxt = text[i + 1]
                        if nxt != '"':
                            val_parts.append("\\")
                        val_parts.append(nxt)
                        i += 2
                    else:
                        i += 1
                    continue
                if c == '"':
                    closed = True
                    i += 1
                    break
                val_parts.append(c)
                i += 1
            if not closed:
                raise TextParseError(
                    f"missing '\"' after value for key: {key}")
            if i < n and not text[i].isspace():
                raise TextParseError("missing whitespace after value")
            out[key] = "".join(val_parts)
        else:
            while i < n:
                c = text[i]
                if c == "\\":
                    if i + 1 < n:
                        nxt = text[i + 1]
                        if not nxt.isspace() and nxt != '"':
                            val_parts.append("\\")
                        val_parts.append(nxt)
                        i += 2
                    else:
                        i += 1
                    continue
                if c.isspace():
                    break
                val_parts.append(c)
                i += 1
            if not val_parts:
                raise TextParseError(f"missing value for key: {key}")
            out[key] = "".join(val_parts)
    return out


# ---------------------------------------------------------------------------
# Comments
# ---------------------------------------------------------------------------

def strip_inline_comment(line: str) -> str:
    """Drop an inline ``#`` comment, respecting open quote context.

    A ``#`` starts a comment when, for each quote type, the quotes to its
    left are balanced (with a forgiving fallback for the last ``#`` when the
    remainder balances an odd count), mirroring the reference's heuristic
    (lib/parser/dockerfile/base.go uncomment).
    """
    last = line.rfind("#")
    for idx, c in enumerate(line):
        if c != "#":
            continue
        balanced = 0
        for q in "'\"":
            left = line[:idx].count(q)
            if left % 2 == 0:
                balanced += 1
            elif idx == last and line[idx:].count(q) % 2 == 0:
                return line[:idx]
        if balanced == 2:
            return line[:idx]
    return line


# Heredoc token on a directive line (BuildKit Dockerfile syntax 1.4):
# ``<<EOF`` / ``<<-EOF`` / ``<<'EOF'`` / ``<<"EOF"``. Not heredocs:
# ``<<<`` (shell here-string), ``<<`` inside quotes, and ``<<`` that is
# not at the start of a shell word — BuildKit's rule, which keeps
# arithmetic shifts (``$((1<<8))``) and fd-redirects (``2<<X``) from
# being misread as heredoc openers.
# Delimiter charset per BuildKit: word chars plus '.' and '-' (heredoc
# file names like <<config.ini).
_HEREDOC_RE = re.compile(r"<<(-?)(['\"]?)([A-Za-z0-9_.-]+)\2")


def heredoc_tokens(
        head: str) -> list[tuple[str, bool, bool, tuple[int, int]]]:
    """(delimiter, strip_tabs, quoted, span) for each heredoc token
    outside quotes, in order of appearance. ``quoted`` (<<'EOF') means
    no build-time variable expansion in the body (BuildKit/sh rule)."""
    out = []
    quote = ""
    word_start = True  # are we at the start of a shell word?
    i = 0
    while i < len(head):
        c = head[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 2  # escaped char inside double quotes
                continue
            if c == quote:
                quote = ""
            i += 1
            continue
        if c == "\\":
            i += 2  # escaped char outside quotes (e.g. it\'s)
            word_start = False
            continue
        if c in "'\"":
            quote = c
            word_start = False
            i += 1
            continue
        if (word_start and head.startswith("<<", i)
                and not head.startswith("<<<", i)):
            m = _HEREDOC_RE.match(head, i)
            if m:
                out.append((m.group(3), m.group(1) == "-",
                            bool(m.group(2)), m.span()))
                i = m.end()
                word_start = False
                continue
        word_start = c in " \t;|&("
        i += 1
    return out
