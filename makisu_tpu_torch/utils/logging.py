"""Build logging on the standard library: JSON (default) or console lines.

The message texts match ``makisu_tpu``'s ("committed layer ...", "cache
hit ...", "successfully built image ..."), so one grep reads the logs of
either builder. Keyword arguments become structured fields. As in the
reference, every record stamps the build's progress clock, reaches the
context's log taps (the flight recorder's ring) and its build sink.
"""

from __future__ import annotations

import contextvars
import json
import logging
import sys
import threading
import time
from typing import Any, Callable

from makisu_tpu_torch.utils import events

_LOGGER_NAME = "makisu.torch"

# Per-build log sink: a context binds a (level, message, fields)
# callback for records at or above a level; threads the build spawns
# carry the context along, so concurrent builds' streams never cross.
_build_sink: "contextvars.ContextVar[tuple[Callable, int] | None]" = \
    contextvars.ContextVar("makisu_torch_build_sink", default=None)


def set_build_sink(sink: "Callable[[str, str, dict], None] | None",
                   level: str = "info"):
    """Bind a per-context sink receiving (level, message, fields) for
    records at or above ``level``. Returns a token for
    reset_build_sink."""
    threshold = getattr(logging, level.upper(), logging.INFO)
    return _build_sink.set(None if sink is None else (sink, threshold))


def reset_build_sink(token) -> None:
    _build_sink.reset(token)


# Context-scoped log taps: observers of every record whatever its level,
# stacking like the event-bus sinks (the flight recorder binds one per
# build so its bundles carry the last log records).
_taps: "contextvars.ContextVar[tuple[Callable, ...]]" = \
    contextvars.ContextVar("makisu_torch_log_taps", default=())


def add_tap(tap: "Callable[[str, str, dict], None]"):
    """Bind a (level, message, fields) observer in the current context,
    stacking on any already bound. Returns a token for
    :func:`reset_tap`."""
    return _taps.set(_taps.get() + (tap,))


def reset_tap(token) -> None:
    _taps.reset(token)


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out: dict[str, Any] = {"level": record.levelname.lower(),
                               "ts": round(record.created, 6),
                               "msg": record.getMessage()}
        out.update(getattr(record, "fields", None) or {})
        if record.exc_info and record.exc_info[0]:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class _ConsoleFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        msg = f"{ts} {record.levelname:<5} {record.getMessage()}"
        fields = getattr(record, "fields", None)
        if fields:
            msg += "  " + " ".join(f"{k}={v}" for k, v in fields.items())
        if record.exc_info and record.exc_info[0]:
            msg += "\n" + self.formatException(record.exc_info)
        return msg


_configure_lock = threading.Lock()


def configure(level: str = "info", fmt: str = "json",
              output: str = "stdout") -> None:
    """(Re)configure the logger: ``output`` is stdout, stderr or a file
    path. The handler list is swapped in one assignment."""
    with _configure_lock:
        logger = logging.getLogger(_LOGGER_NAME)
        if output in ("stdout", "stderr"):
            handler = logging.StreamHandler(
                sys.stderr if output == "stderr" else sys.stdout)
        else:
            handler = logging.FileHandler(output)
        handler.setFormatter(_JsonFormatter() if fmt == "json"
                             else _ConsoleFormatter())
        old, logger.handlers = logger.handlers, [handler]
        for h in old:
            h.close()
        logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        logger.propagate = False


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        configure(fmt="console")
    return logger


def _log(level: int, msg: str, *args: Any, **fields: Any) -> None:
    if args:
        msg = msg % args
    # A log line proves the process is alive: a build that logs (a long
    # RUN step draining output) without bus events is not stalled.
    events.note_progress()
    get_logger().log(level, msg, extra={"fields": fields} if fields else {})
    name = logging.getLevelName(level).lower()
    for tap in _taps.get():
        try:
            tap(name, msg, fields)
        except Exception:  # noqa: BLE001 - a dead tap must not kill logging
            pass
    bound = _build_sink.get()
    if bound is not None and level >= bound[1]:
        try:
            bound[0](name, msg, fields)
        except Exception:  # noqa: BLE001 - a dead sink must not kill logging
            pass


def debug(msg: str, *args: Any, **fields: Any) -> None:
    _log(logging.DEBUG, msg, *args, **fields)


def info(msg: str, *args: Any, **fields: Any) -> None:
    _log(logging.INFO, msg, *args, **fields)


def warning(msg: str, *args: Any, **fields: Any) -> None:
    _log(logging.WARNING, msg, *args, **fields)


def error(msg: str, *args: Any, **fields: Any) -> None:
    _log(logging.ERROR, msg, *args, **fields)
