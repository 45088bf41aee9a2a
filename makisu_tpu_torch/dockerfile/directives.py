"""The 16 Dockerfile directives.

Each directive is a dataclass with a ``parse`` constructor that consumes the
raw argument text (after variable replacement appropriate to that directive)
and an ``update`` hook that mutates parsing state (declaring stages, binding
ARG/ENV variables). Capability parity with the reference's per-directive
files (lib/parser/dockerfile/{from,arg,env,run,cmd,entrypoint,label,
maintainer,expose,volume,user,workdir,stopsignal,healthcheck,add,copy}.go);
the implementation is original.

Variable-replacement scoping (reference: lib/parser/dockerfile/base.go):
- FROM resolves against *global* ARGs (those declared before any stage).
- ARG resolves against the current stage's vars, falling back to globals.
- Most directives resolve against the current stage's vars and are invalid
  before the first FROM.
- MAINTAINER and STOPSIGNAL perform no replacement.
"""

from __future__ import annotations

import dataclasses
import json
import re

from makisu_tpu_torch.dockerfile.text import (
    TextParseError,
    parse_key_vals,
    replace_variables,
    split_args,
)


class ParseError(ValueError):
    """A directive line failed to parse."""

    def __init__(self, directive: str, args: str, msg: str) -> None:
        super().__init__(
            f"failed to parse {directive.upper()!r} directive "
            f"with args {args!r}: {msg}")


def _json_array(text: str) -> list[str] | None:
    """Decode text as a JSON array of strings, or None."""
    try:
        val = json.loads(text)
    except ValueError:
        return None
    if isinstance(val, list) and all(isinstance(x, str) for x in val):
        return val
    return None


def _string_flag(token: str, name: str) -> str | None:
    """Value of a leading ``--name=value`` flag token, or None."""
    prefix = f"--{name}="
    if not token.startswith(prefix):
        return None
    if len(token) == len(prefix):
        raise TextParseError(f"missing value for flag: {name}")
    return token[len(prefix):]


_DURATION_UNITS = {
    "ns": 1, "us": 10**3, "µs": 10**3, "ms": 10**6,
    "s": 10**9, "m": 60 * 10**9, "h": 3600 * 10**9,
}
_DURATION_RE = re.compile(r"(\d+(?:\.\d*)?)(ns|us|µs|ms|s|m|h)")


def parse_duration(text: str) -> int:
    """``5m30s``-style duration to integer nanoseconds (docker convention)."""
    if text in ("0", ""):
        return 0
    total, pos = 0.0, 0
    for m in _DURATION_RE.finditer(text):
        if m.start() != pos:
            raise TextParseError(f"invalid duration: {text!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(text):
        raise TextParseError(f"invalid duration: {text!r}")
    return int(total)


@dataclasses.dataclass
class Directive:
    """Common fields: the raw (replaced) argument text and whether the line
    carried a ``#!COMMIT`` annotation (explicit-commit mode)."""

    args: str
    commit: bool

    def update(self, state) -> None:
        """Default: append to the current stage."""
        state.add_to_current_stage(self)


@dataclasses.dataclass
class FromDirective(Directive):
    image: str = ""
    alias: str = ""

    @staticmethod
    def parse(args: str, commit: bool, state) -> "FromDirective":
        args = replace_variables(args, state.global_args)
        parts = args.split()
        if not parts:
            raise ParseError("from", args, "missing arguments")
        alias = ""
        if len(parts) > 1:
            if len(parts) != 3 or parts[1].lower() != "as":
                raise ParseError("from", args, "malformed image alias")
            alias = parts[2]
        return FromDirective(args, commit, parts[0], alias)

    def update(self, state) -> None:
        state.new_stage(self)


@dataclasses.dataclass
class ArgDirective(Directive):
    name: str = ""
    default_val: str = ""
    resolved_val: str | None = None

    @staticmethod
    def parse(args: str, commit: bool, state) -> "ArgDirective":
        args = replace_variables(args, state.current_or_global_vars())
        try:
            pairs = parse_key_vals(args)
        except TextParseError:
            pairs = None
        if pairs is not None:
            if len(pairs) != 1:
                raise ParseError("arg", args, "expected exactly one argument")
            ((name, default),) = pairs.items()
            return ArgDirective(args, commit, name, default)
        try:
            tokens = split_args(args)
        except TextParseError as e:
            raise ParseError("arg", args, str(e)) from e
        if len(tokens) != 1:
            raise ParseError("arg", args, "expected exactly one argument")
        return ArgDirective(args, commit, args, "")

    def update(self, state) -> None:
        scope = state.current_or_global_vars()
        if self.name in state.passed_args:
            self.resolved_val = state.passed_args[self.name]
            scope[self.name] = self.resolved_val
        elif self.default_val:
            self.resolved_val = self.default_val
            scope[self.name] = self.default_val
        if state.stage_vars is None:
            return  # global ARG: declared, not attached to a stage
        # Stage-level ARGs pick up values resolved in the global scope
        # (reference behavior; see testdata global-arg context).
        if self.name in state.global_args:
            self.resolved_val = state.global_args[self.name]
            scope[self.name] = self.resolved_val
        state.add_to_current_stage(self)


@dataclasses.dataclass
class EnvDirective(Directive):
    envs: dict[str, str] = dataclasses.field(default_factory=dict)

    @staticmethod
    def parse(args: str, commit: bool, state) -> "EnvDirective":
        args = replace_variables(args, state.require_stage_vars("env"))
        try:
            return EnvDirective(args, commit, parse_key_vals(args))
        except TextParseError:
            pass
        # Legacy single-variable form: ENV <key> <value...>
        idx = args.find(" ")
        if idx in (-1, len(args) - 1):
            raise ParseError("env", args, "missing space in single-variable ENV")
        return EnvDirective(args, commit, {args[:idx]: args[idx + 1:]})

    def update(self, state) -> None:
        state.require_stage_vars("env").update(self.envs)
        state.add_to_current_stage(self)


@dataclasses.dataclass
class RunDirective(Directive):
    cmd: str = ""

    @staticmethod
    def parse(args: str, commit: bool, state) -> "RunDirective":
        variables = state.require_stage_vars("run")
        head, newline, body = args.partition("\n")
        if not newline:
            args = replace_variables(args, variables)
            arr = _json_array(args)
            if arr is not None:
                return RunDirective(args, commit, " ".join(arr))
            return RunDirective(args, commit, args)
        # Heredoc forms (parse_file collected the body): build-time
        # variables substitute only into the command head — bodies reach
        # the shell verbatim (BuildKit semantics; $VAR there is the
        # shell's business at run time). An EMPTY head line is
        # parse_file's bare-script marker: the whole body is a verbatim
        # shell script, no substitution anywhere.
        from makisu_tpu_torch.dockerfile.text import heredoc_tokens
        if not head:
            cmd = body
        elif heredoc_tokens(head):
            cmd = replace_variables(head, variables) + "\n" + body
        else:
            cmd = args
        # Store cmd as args too: cache IDs hash step args (steps/base.py
        # set_cache_id), so the SUBSTITUTED form must be the identity —
        # otherwise two builds differing only in a build-arg value used
        # in the command head would share a cache key and serve each
        # other's layers.
        return RunDirective(cmd, commit, cmd)


def _shell_or_exec(directive: str, args: str, state) -> list[str]:
    """JSON exec form, or shell form wrapped as ``/bin/sh -c <joined>``."""
    arr = _json_array(args)
    if arr is not None:
        return arr
    try:
        tokens = split_args(args, for_shell=True)
    except TextParseError as e:
        raise ParseError(directive, args, str(e)) from e
    return ["/bin/sh", "-c", " ".join(tokens)]


@dataclasses.dataclass
class CmdDirective(Directive):
    cmd: list[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(args: str, commit: bool, state) -> "CmdDirective":
        args = replace_variables(args, state.require_stage_vars("cmd"))
        return CmdDirective(args, commit, _shell_or_exec("cmd", args, state))


@dataclasses.dataclass
class EntrypointDirective(Directive):
    entrypoint: list[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(args: str, commit: bool, state) -> "EntrypointDirective":
        args = replace_variables(args, state.require_stage_vars("entrypoint"))
        return EntrypointDirective(
            args, commit, _shell_or_exec("entrypoint", args, state))


@dataclasses.dataclass
class LabelDirective(Directive):
    labels: dict[str, str] = dataclasses.field(default_factory=dict)

    @staticmethod
    def parse(args: str, commit: bool, state) -> "LabelDirective":
        args = replace_variables(args, state.require_stage_vars("label"))
        try:
            return LabelDirective(args, commit, parse_key_vals(args))
        except TextParseError as e:
            raise ParseError("label", args, str(e)) from e


@dataclasses.dataclass
class MaintainerDirective(Directive):
    author: str = ""

    @staticmethod
    def parse(args: str, commit: bool, state) -> "MaintainerDirective":
        return MaintainerDirective(args, commit, args)


@dataclasses.dataclass
class ExposeDirective(Directive):
    ports: list[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(args: str, commit: bool, state) -> "ExposeDirective":
        args = replace_variables(args, state.require_stage_vars("expose"))
        ports = args.split()
        if not ports:
            raise ParseError("expose", args, "missing arguments")
        return ExposeDirective(args, commit, ports)


@dataclasses.dataclass
class VolumeDirective(Directive):
    volumes: list[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(args: str, commit: bool, state) -> "VolumeDirective":
        args = replace_variables(args, state.require_stage_vars("volume"))
        arr = _json_array(args)
        if arr is None:
            arr = args.split()
        if not arr:
            raise ParseError("volume", args, "missing arguments")
        return VolumeDirective(args, commit, arr)


def _exactly_one(directive: str, args: str) -> str:
    parts = args.split()
    if len(parts) != 1:
        raise ParseError(directive, args, "expected exactly one argument")
    return parts[0]


@dataclasses.dataclass
class UserDirective(Directive):
    user: str = ""

    @staticmethod
    def parse(args: str, commit: bool, state) -> "UserDirective":
        args = replace_variables(args, state.require_stage_vars("user"))
        return UserDirective(args, commit, _exactly_one("user", args))


@dataclasses.dataclass
class WorkdirDirective(Directive):
    working_dir: str = ""

    @staticmethod
    def parse(args: str, commit: bool, state) -> "WorkdirDirective":
        args = replace_variables(args, state.require_stage_vars("workdir"))
        return WorkdirDirective(args, commit, _exactly_one("workdir", args))


@dataclasses.dataclass
class StopsignalDirective(Directive):
    signal: int = 0

    @staticmethod
    def parse(args: str, commit: bool, state) -> "StopsignalDirective":
        try:
            signal = int(args)
        except ValueError as e:
            raise ParseError("stopsignal", args, "signal must be an integer") from e
        if signal < 0:
            raise ParseError("stopsignal", args, "signal must be >= 0")
        return StopsignalDirective(args, commit, signal)


_HC_NONE_RE = re.compile(r"^[\s|\\]*none[\s|\\]*$", re.I)
_HC_CMD_RE = re.compile(r"[\s|\\]*cmd[\s|\\]*", re.I)


@dataclasses.dataclass
class HealthcheckDirective(Directive):
    interval: int = 0      # nanoseconds
    timeout: int = 0
    start_period: int = 0
    retries: int = 0
    test: list[str] = dataclasses.field(default_factory=list)

    @staticmethod
    def parse(args: str, commit: bool, state) -> "HealthcheckDirective":
        if _HC_NONE_RE.match(args):
            return HealthcheckDirective(args, commit, test=["NONE"])
        m = _HC_CMD_RE.search(args)
        if m is None:
            raise ParseError("healthcheck", args, "CMD not defined")
        try:
            flags = split_args(args[:m.start()])
        except TextParseError as e:
            raise ParseError("healthcheck", args, str(e)) from e
        fields = {"interval": 0, "timeout": 0, "start-period": 0, "retries": 0}
        for flag in flags:
            for name in fields:
                val = _string_flag(flag, name)
                if val is not None:
                    fields[name] = (int(val) if name == "retries"
                                    else parse_duration(val))
                    break
            else:
                raise ParseError("healthcheck", args, f"unsupported flag {flag}")
        remaining = replace_variables(
            args[m.end():], state.require_stage_vars("healthcheck"))
        arr = _json_array(remaining)
        if arr is not None:
            if not arr:
                raise ParseError("healthcheck", args, "missing CMD arguments")
            test = ["CMD", *arr]
        else:
            try:
                tokens = split_args(remaining)
            except TextParseError as e:
                raise ParseError("healthcheck", args, str(e)) from e
            if not tokens:
                raise ParseError("healthcheck", args, "missing CMD arguments")
            test = ["CMD-SHELL", remaining]
        return HealthcheckDirective(
            args, commit, fields["interval"], fields["timeout"],
            fields["start-period"], fields["retries"], test)


def _parse_add_copy(directive: str, args_text: str, tokens: list[str]):
    """Shared ADD/COPY tail: optional --chown=/--archive flag, then srcs+dst
    (JSON-array form supported). Returns (chown, preserve_owner, srcs, dst).
    """
    if not tokens:
        raise ParseError(directive, args_text, "missing arguments")
    chown, preserve_owner, nflags = "", False, 0
    while tokens and tokens[0].startswith("--") and nflags == 0:
        tok = tokens[0]
        if tok.startswith("--chown"):
            try:
                val = _string_flag(tok, "chown")
            except TextParseError as e:
                raise ParseError(directive, args_text, str(e)) from e
            if val is None:
                raise ParseError(directive, args_text,
                                 "wrong flag format for --chown")
            chown, nflags = val, nflags + 1
            tokens = tokens[1:]
        elif tok == "--archive":
            preserve_owner, nflags = True, nflags + 1
            tokens = tokens[1:]
        else:
            break
    if tokens and tokens[0].startswith(("--chown", "--archive")):
        raise ParseError(directive, args_text,
                         "at most one of --chown/--archive allowed")
    arr = _json_array(" ".join(tokens))
    parsed = arr if arr is not None else tokens
    if len(parsed) < 2:
        raise ParseError(directive, args_text, "missing arguments")
    return chown, preserve_owner, parsed[:-1], parsed[-1]


def _take_inline_files(
    directive: str, srcs: list[str], dst: str, state,
    variables: dict[str, str],
) -> tuple[list[str], list[tuple[str, str]], list[tuple[str, str]]]:
    """Split heredoc sources (``<<NAME`` tokens, BuildKit syntax 1.4)
    from real sources, pairing them with the bodies parse_file stashed
    in ``state.pending_heredocs``. Each becomes an inline file named by
    its delimiter; bodies get build-time variable expansion unless the
    delimiter was quoted (``<<'NAME'``).

    Returns (real_srcs, inline_files, ordered) where ``ordered`` is
    [("src", path) | ("inline", name)] in the line's left-to-right
    source order — docker applies sources in order, so later sources
    overwrite earlier ones on name collisions and the steps must
    preserve that.
    """
    pending = {name: (content, quoted)
               for name, content, quoted in state.pending_heredocs}
    state.pending_heredocs = []
    if dst.startswith("<<"):
        raise ParseError(directive, dst,
                         "a heredoc cannot be the destination")
    real: list[str] = []
    inline: list[tuple[str, str]] = []
    ordered: list[tuple[str, str]] = []
    seen: set[str] = set()
    from makisu_tpu_torch.dockerfile.text import heredoc_tokens
    for src in srcs:
        if not src.startswith("<<"):
            real.append(src)
            # Quote-stripped like AddCopyStep.srcs: execute() resolves
            # ordered entries directly, so they must match.
            ordered.append(("src", src.strip("\"'")))
            continue
        toks = heredoc_tokens(src)
        if len(toks) != 1 or toks[0][3] != (0, len(src)):
            raise ParseError(directive, src,
                             f"malformed heredoc source {src!r}")
        name = toks[0][0]
        if name in (".", ".."):
            raise ParseError(directive, src,
                             f"invalid heredoc file name {name!r}")
        if name not in pending:
            raise ParseError(directive, src,
                             f"heredoc source {src!r} has no body")
        if name in seen:
            raise ParseError(
                directive, src,
                f"duplicate heredoc file name {name!r} on one line")
        seen.add(name)
        content, quoted = pending.pop(name)
        if not quoted:
            content = replace_variables(content, variables)
        inline.append((name, content))
        ordered.append(("inline", name))
    if pending:
        raise ParseError(
            directive, " ".join(sorted(pending)),
            "heredoc body not referenced by any source on the line")
    return real, inline, ordered


@dataclasses.dataclass
class AddDirective(Directive):
    chown: str = ""
    preserve_owner: bool = False
    srcs: list[str] = dataclasses.field(default_factory=list)
    dst: str = ""
    inline_files: list[tuple[str, str]] = dataclasses.field(
        default_factory=list)
    ordered_sources: list[tuple[str, str]] = dataclasses.field(
        default_factory=list)

    @staticmethod
    def parse(args: str, commit: bool, state) -> "AddDirective":
        variables = state.require_stage_vars("add")
        args = replace_variables(args, variables)
        chown, preserve, srcs, dst = _parse_add_copy("add", args, args.split())
        srcs, inline, ordered = _take_inline_files(
            "add", srcs, dst, state, variables)
        return AddDirective(args, commit, chown, preserve, srcs, dst,
                            inline, ordered)


@dataclasses.dataclass
class CopyDirective(Directive):
    chown: str = ""
    preserve_owner: bool = False
    srcs: list[str] = dataclasses.field(default_factory=list)
    dst: str = ""
    from_stage: str = ""
    inline_files: list[tuple[str, str]] = dataclasses.field(
        default_factory=list)
    ordered_sources: list[tuple[str, str]] = dataclasses.field(
        default_factory=list)

    @staticmethod
    def parse(args: str, commit: bool, state) -> "CopyDirective":
        variables = state.require_stage_vars("copy")
        args = replace_variables(args, variables)
        tokens = args.split()
        from_stage = ""
        for i, tok in enumerate(tokens[:2]):
            if tok.startswith("--from="):
                try:
                    from_stage = _string_flag(tok, "from") or ""
                except TextParseError as e:
                    raise ParseError("copy", args, str(e)) from e
                tokens = tokens[:i] + tokens[i + 1:]
                break
        chown, preserve, srcs, dst = _parse_add_copy("copy", args, tokens)
        srcs, inline, ordered = _take_inline_files(
            "copy", srcs, dst, state, variables)
        if inline and from_stage:
            raise ParseError("copy", args,
                             "heredoc sources cannot combine with --from")
        return CopyDirective(args, commit, chown, preserve, srcs, dst,
                             from_stage, inline, ordered)


DIRECTIVES: dict[str, type] = {
    "add": AddDirective,
    "arg": ArgDirective,
    "cmd": CmdDirective,
    "copy": CopyDirective,
    "entrypoint": EntrypointDirective,
    "env": EnvDirective,
    "expose": ExposeDirective,
    "from": FromDirective,
    "healthcheck": HealthcheckDirective,
    "label": LabelDirective,
    "maintainer": MaintainerDirective,
    "run": RunDirective,
    "stopsignal": StopsignalDirective,
    "user": UserDirective,
    "volume": VolumeDirective,
    "workdir": WorkdirDirective,
}
