"""Build logging on the standard library: JSON (default) or console lines.

The message texts match ``makisu_tpu``'s ("committed layer ...", "cache
hit ...", "successfully built image ..."), so one grep reads the logs of
either builder. Keyword arguments become structured fields.
"""

from __future__ import annotations

import json
import logging
import sys
import threading
import time
from typing import Any

_LOGGER_NAME = "makisu.torch"


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
    get_logger().log(level, msg, extra={"fields": fields} if fields else {})


def debug(msg: str, *args: Any, **fields: Any) -> None:
    _log(logging.DEBUG, msg, *args, **fields)


def info(msg: str, *args: Any, **fields: Any) -> None:
    _log(logging.INFO, msg, *args, **fields)


def warning(msg: str, *args: Any, **fields: Any) -> None:
    _log(logging.WARNING, msg, *args, **fields)


def error(msg: str, *args: Any, **fields: Any) -> None:
    _log(logging.ERROR, msg, *args, **fields)
