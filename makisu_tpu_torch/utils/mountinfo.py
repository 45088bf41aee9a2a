"""Mount table: which paths are mountpoints / under mounts.

Used to skip mounted paths during untar and layer scans so bind-mounted
files (k8s configmaps, /etc/resolv.conf, build volumes) never leak into
image layers. Reference capability: lib/mountutils/ (initialize at
mountutils.go:55, IsMountpoint:128, IsMounted:135).
"""

from __future__ import annotations

import os
import threading

_MOUNTINFO = "/proc/self/mountinfo"

_lock = threading.Lock()
_mountpoints: set[str] | None = None


def _load() -> set[str]:
    global _mountpoints
    with _lock:
        if _mountpoints is None:
            points: set[str] = set()
            try:
                with open(_MOUNTINFO) as f:
                    for line in f:
                        # field 5 (0-indexed 4) is the mount point; octal
                        # escapes like \040 encode spaces.
                        fields = line.split()
                        if len(fields) > 4:
                            mp = fields[4].encode().decode("unicode_escape")
                            points.add(os.path.normpath(mp))
            except OSError:
                pass
            _mountpoints = points
        return _mountpoints


def set_mountpoints_for_testing(points: set[str] | None) -> None:
    global _mountpoints
    with _lock:
        _mountpoints = points


def is_mountpoint(path: str) -> bool:
    """True if path is exactly a mount point (root "/" excluded)."""
    p = os.path.normpath(path)
    return p != "/" and p in _load()


def is_mounted(path: str) -> bool:
    """True if path is a mount point or inside one (other than "/")."""
    p = os.path.normpath(path)
    for mp in _load():
        if mp == "/":
            continue
        if p == mp or p.startswith(mp.rstrip("/") + "/"):
            return True
    return False
