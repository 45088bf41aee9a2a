"""File-level Dockerfile parsing: stages, scoping state, #!COMMIT.

Reference behavior being matched (lib/parser/dockerfile/parse_file.go,
state.go, base.go): comment lines and blank lines are removed, ``\\``-newline
continuations are joined, then each line becomes one directive. Variable
scoping has three layers — build args passed in by the caller, global ARGs
(declared before the first FROM, visible to FROM lines), and per-stage vars
(reset at each FROM, fed by ARG and ENV).
"""

from __future__ import annotations

import dataclasses
import re

from makisu_tpu_torch.dockerfile.directives import (
    DIRECTIVES,
    Directive,
    FromDirective,
    ParseError,
)
from makisu_tpu_torch.dockerfile.text import heredoc_tokens, strip_inline_comment

_COMMIT_RE = re.compile(r"\s*#!\s*commit\s*", re.I)


@dataclasses.dataclass
class Stage:
    """One build stage: a FROM directive plus its body."""

    from_directive: FromDirective
    directives: list[Directive] = dataclasses.field(default_factory=list)

    @property
    def alias(self) -> str:
        return self.from_directive.alias


class ParsingState:
    """Variable scopes threaded through directive parsing."""

    def __init__(self, passed_args: dict[str, str] | None) -> None:
        self.stages: list[Stage] = []
        self.passed_args: dict[str, str] = dict(passed_args or {})
        self.global_args: dict[str, str] = {}
        self.stage_vars: dict[str, str] | None = None  # None until first FROM
        # COPY/ADD heredoc bodies collected by parse_file for the
        # directive currently being parsed: (delimiter, content, quoted).
        self.pending_heredocs: list[tuple[str, str, bool]] = []

    def current_or_global_vars(self) -> dict[str, str]:
        return self.stage_vars if self.stage_vars is not None else self.global_args

    def require_stage_vars(self, directive: str) -> dict[str, str]:
        if self.stage_vars is None:
            raise ParseError(directive, "",
                             "invalid before the first build stage (FROM)")
        return self.stage_vars

    def new_stage(self, from_directive: FromDirective) -> None:
        self.stages.append(Stage(from_directive))
        self.stage_vars = {}

    def add_to_current_stage(self, d: Directive) -> None:
        if not self.stages:
            raise ParseError(type(d).__name__, d.args,
                             "invalid before the first build stage (FROM)")
        self.stages[-1].directives.append(d)


def parse_line(line: str, state: ParsingState) -> Directive | None:
    """Parse one logical line into a directive, or None for empty lines.

    A logical line may carry heredoc content below its first newline
    (see ``parse_file``); comment/#!COMMIT handling applies to the
    directive head only — bodies pass through verbatim.
    """
    head, _, body = line.partition("\n")
    commit = False
    hash_idx = head.find("#")
    if hash_idx != -1:
        commit = bool(_COMMIT_RE.search(head[hash_idx:].lower()))
        head = strip_inline_comment(head)
    stripped = head.strip()
    if not stripped and not body:
        return None
    parts = stripped.split(None, 1)
    if len(parts) != 2 and not body:
        raise ValueError(f"failed to parse directive line: {line!r}")
    name = parts[0].lower()
    args = parts[1].strip() if len(parts) == 2 else ""
    if body:
        args = f"{args}\n{body}" if args else body
    cls = DIRECTIVES.get(name)
    if cls is None:
        raise ValueError(f"unsupported directive type: {parts[0]!r}")
    return cls.parse(args, commit, state)




_HEREDOC_DIRECTIVES = {"run", "copy", "add"}


def _collect_heredoc(lines: list[str], i: int, delim: str,
                     strip_tabs: bool) -> tuple[list[str], list[str], int]:
    """Consume raw lines until the terminator.

    Returns (raw_lines, script_lines, next_i): raw_lines verbatim (for
    the command form, where the shell re-interprets the heredoc itself,
    including ``<<-`` tab stripping); script_lines tab-stripped when
    ``strip_tabs`` (for the bare-script form, where WE are the heredoc
    interpreter). Bodies are RAW either way: no comment stripping, no
    continuation splicing, no blank-line removal — '#', '\\', and empty
    lines are content.
    """
    raw_body: list[str] = []
    script: list[str] = []
    while i < len(lines):
        raw = lines[i]
        cand = raw.lstrip("\t") if strip_tabs else raw
        if cand == delim:
            return raw_body, script, i + 1
        raw_body.append(raw)
        script.append(cand)
        i += 1
    raise ValueError(f"unterminated heredoc: missing {delim!r} terminator")


def parse_file(contents: str, build_args: dict[str, str] | None = None,
               ) -> list[Stage]:
    """Parse Dockerfile text into stages.

    ``build_args`` are the caller's ``--build-arg`` values, consulted when
    ARG directives declare matching names.

    Heredocs (BuildKit Dockerfile syntax 1.4 — the reference predates
    them entirely): a RUN line containing ``<<DELIM`` consumes the
    following raw lines until ``DELIM`` as content. A bare
    ``RUN <<DELIM`` runs the body as a shell script; a command form
    (``RUN python3 <<DELIM`` / ``RUN cat <<EOF > f``) keeps the heredoc
    syntax intact — the shell interprets it natively, so semantics
    (including ``<<-`` tab stripping and quoted-delimiter expansion
    suppression) are exactly sh's. A COPY/ADD ``<<NAME`` source becomes
    an inline file named by its delimiter (variable-expanded unless the
    delimiter is quoted), staged and copied with normal docker
    semantics in left-to-right source order.
    """
    contents = contents.replace("\r\n", "\n")  # CRLF Dockerfiles
    lines = contents.split("\n")
    state = ParsingState(build_args)
    i = 0
    while i < len(lines):
        raw = lines[i]
        lineno = i + 1
        stripped = raw.strip(" \t")
        if not stripped or stripped[0] == "#":
            i += 1
            continue
        # Logical line: splice "\"-continuations, skipping interleaved
        # full-line comments and blanks (docker semantics, same as the
        # previous filter-then-splice implementation).
        head = raw
        i += 1
        while head.endswith("\\"):
            while i < len(lines) and (not lines[i].strip(" \t")
                                      or lines[i].strip(" \t")[0] == "#"):
                i += 1
            if i >= len(lines):
                break
            head = head[:-1] + lines[i]
            i += 1

        name = head.strip().split(None, 1)[0].lower() if head.strip() else ""
        logical = head
        if name in _HEREDOC_DIRECTIVES:
            try:
                tokens = heredoc_tokens(head)
                if tokens and name in ("copy", "add"):
                    # Inline file sources: each body becomes a staged
                    # file named by its delimiter; CopyDirective/
                    # AddDirective consume them from the parse state.
                    for delim, strip_tabs, quoted, _span in tokens:
                        _raw, script, i = _collect_heredoc(
                            lines, i, delim, strip_tabs)
                        content = "".join(s + "\n" for s in script)
                        state.pending_heredocs.append(
                            (delim, content, quoted))
                elif tokens:
                    # Bare form: the directive's entire argument (inline
                    # comments aside) is the one heredoc token.
                    cleaned = strip_inline_comment(head).strip()
                    cleaned_parts = cleaned.split(None, 1)
                    bare = (len(tokens) == 1 and len(cleaned_parts) == 2
                            and cleaned_parts[1].strip()
                            == head[tokens[0][3][0]:tokens[0][3][1]])
                    segments = []
                    for delim, strip_tabs, _quoted, _span in tokens:
                        raw_body, script, i = _collect_heredoc(
                            lines, i, delim, strip_tabs)
                        if bare:
                            segments.extend(script)
                        else:
                            # Keep the shell's own heredoc: body
                            # verbatim (pre-tab-strip) + terminator
                            # line — sh applies <<- tab stripping
                            # itself.
                            segments.extend(raw_body + [delim])
                    if bare:
                        # Head minus the token (any #!COMMIT marker
                        # stays); body is the script. The EMPTY second
                        # line is a marker: RunDirective reads it as
                        # "bare script — no variable substitution".
                        lo, hi = tokens[0][3]
                        logical = "\n".join(
                            [(head[:lo] + head[hi:]).rstrip(), "",
                             *segments])
                    else:
                        logical = "\n".join([head, *segments])
            except ValueError as e:
                raise ValueError(f"line {lineno}: {e}") from e
        try:
            directive = parse_line(logical, state)
        except ValueError as e:
            raise ValueError(f"line {lineno}: {e}") from e
        if directive is not None:
            directive.update(state)
    return state.stages
