"""Dockerfile frontend: parse Dockerfile text into stages of directives.

Copy of ``makisu_tpu/dockerfile/`` (heredocs, build args, durations),
held case for case against it by ``tests/test_torch_dockerfile.py``.
Pure (no I/O, no deps on the rest of the framework); reference surface:
lib/parser/dockerfile/ (ParseFile at parse_file.go:24).
"""

from makisu_tpu_torch.dockerfile.directives import (
    AddDirective,
    ArgDirective,
    CmdDirective,
    CopyDirective,
    Directive,
    EntrypointDirective,
    EnvDirective,
    ExposeDirective,
    FromDirective,
    HealthcheckDirective,
    LabelDirective,
    MaintainerDirective,
    ParseError,
    RunDirective,
    StopsignalDirective,
    UserDirective,
    VolumeDirective,
    WorkdirDirective,
    parse_duration,
)
from makisu_tpu_torch.dockerfile.parse import ParsingState, Stage, parse_file
from makisu_tpu_torch.dockerfile.text import (
    TextParseError,
    parse_key_vals,
    replace_variables,
    split_args,
)

__all__ = [
    "AddDirective", "ArgDirective", "CmdDirective", "CopyDirective",
    "Directive", "EntrypointDirective", "EnvDirective", "ExposeDirective",
    "FromDirective", "HealthcheckDirective", "LabelDirective",
    "MaintainerDirective", "ParseError", "RunDirective",
    "StopsignalDirective", "UserDirective", "VolumeDirective",
    "WorkdirDirective", "ParsingState", "Stage", "TextParseError",
    "parse_duration", "parse_file", "parse_key_vals", "replace_variables",
    "split_args",
]
