"""OS-level helpers: special files, stat fields, user/group resolution.

Reference capability: lib/utils/utils.go (IsSpecialFile:161, FileInfoStat:167,
ResolveChown:190).
"""

from __future__ import annotations

import os
import stat


def is_special_file(st: os.stat_result) -> bool:
    """Sockets, fifos, and device nodes never belong in image layers."""
    mode = st.st_mode
    return (stat.S_ISSOCK(mode) or stat.S_ISFIFO(mode)
            or stat.S_ISBLK(mode) or stat.S_ISCHR(mode))


def resolve_chown(chown: str) -> tuple[int, int]:
    """``user[:group]`` (names or numeric ids) → (uid, gid).

    A bare user with no group maps the group to the same value, matching
    docker's --chown semantics. Empty string → (0, 0).
    """
    if not chown:
        return 0, 0
    parts = chown.split(":")
    if len(parts) > 2:
        raise ValueError(f"malformed chown argument: {chown!r}")
    user = parts[0]
    group = parts[1] if len(parts) == 2 else user

    def _uid(name: str) -> int:
        if name.isdigit():
            return int(name)
        import pwd
        return pwd.getpwnam(name).pw_uid

    def _gid(name: str) -> int:
        if name.isdigit():
            return int(name)
        import grp
        return grp.getgrnam(name).gr_gid

    return _uid(user), _gid(group)
