"""Resident build sessions and their snapshot plane.

Copy of the session half of ``makisu_tpu/worker/``: ``session.py`` (the
process-wide ``SessionManager``, build sessions, the inotify watcher)
and ``snapshots.py`` (chunk-addressed session snapshots). The worker
server and client are not ported yet; ``build --watch`` and in-process
repeat builds are the sessions' users.
"""
