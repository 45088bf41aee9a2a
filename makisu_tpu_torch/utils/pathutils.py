"""Path constants and helpers: copy of ``makisu_tpu/utils/pathutils.py``
(reference: lib/pathutils/).

The blacklist is the set of host paths never scanned, copied, or committed
into layers — kernel pseudo-filesystems plus files the container runtime
bind-mounts read-only.
"""

from __future__ import annotations

import functools
import os

DEFAULT_STORAGE_DIR = "/makisu-storage"
DEFAULT_INTERNAL_DIR = "/makisu-internal"
CACHE_KV_FILE_NAME = "cache_key_value.json"

DEFAULT_BLACKLIST = [
    DEFAULT_INTERNAL_DIR,
    "/.dockerinit",
    "/dev",
    "/.dockerenv",
    "/dev/console",
    "/dev/pts",
    "/dev/shm",
    "/etc/hosts",
    "/etc/hostname",
    "/etc/mtab",
    "/etc/resolv.conf",
    "/proc",
    "/sys",
]


@functools.lru_cache(maxsize=65536)
def abs_path(p: str) -> str:
    """Normalize to an absolute path with a leading '/'. Does not resolve
    symlinks (layer paths are logical, not host-resolved).

    Memoized: scans normalize the same paths many times over (each
    blacklist entry per visited file, ancestors per descendant); the
    cache turns the string work into a dict hit on the hot loop."""
    p = os.path.normpath("/" + p)
    if p.startswith("//"):  # POSIX normpath preserves a double leading slash
        p = "/" + p.lstrip("/")
    return p


def rel_path(p: str) -> str:
    """Path relative to '/', with no leading slash."""
    return abs_path(p).lstrip("/")


def trim_root(p: str, root: str) -> str:
    """Strip a root prefix, returning an absolute logical path."""
    root = os.path.normpath(root)
    p = os.path.normpath(p)
    if root in ("/", ""):
        return abs_path(p)
    if p == root:
        return "/"
    if p.startswith(root + os.sep):
        return abs_path(p[len(root):])
    raise ValueError(f"{p!r} is not under root {root!r}")


def join_root(root: str, p: str) -> str:
    """Map a logical absolute path into a physical root directory."""
    return os.path.normpath(os.path.join(root, rel_path(p)))


def split_path(p: str) -> list[str]:
    """Path components, no empties: '/a/b/c' -> ['a','b','c']."""
    return [c for c in abs_path(p).split("/") if c]


def is_descendant_of_any(p: str, ancestors: list[str]) -> bool:
    """True if p equals or sits beneath any listed path."""
    p = abs_path(p)
    for a in ancestors:
        a = abs_path(a)
        if p == a or p.startswith(a.rstrip("/") + "/"):
            return True
    return False

