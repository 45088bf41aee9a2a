"""Process execution for RUN steps.

Copy of ``makisu_tpu/shell.py`` (reference: lib/shell/cmd.go
ExecCommand:34 — process group, optional setuid/setgid from
"user[:group]", HOME override, line-streamed output).
"""

from __future__ import annotations

import os
import pwd
import subprocess
import sys
import threading

from makisu_tpu_torch.utils import logging as log
from makisu_tpu_torch.utils import sysutils


def _drain(stream, sink, tail: list[str] | None = None) -> None:
    for line in stream:
        if tail is not None:
            tail.append(line)
            del tail[:-50]
        sink(line.rstrip("\n"))


def exec_command(workdir: str, user: str, *argv: str,
                 env: dict[str, str] | None = None) -> None:
    """Run argv in ``workdir`` as ``user`` (empty = current), streaming
    output lines to the logger. Raises CalledProcessError on nonzero exit.

    stdout/stderr drain on separate threads so neither pipe can fill and
    deadlock the child; identity switching uses Popen's user/group/
    process_group parameters (fork-safe, unlike preexec_fn, which matters
    because cache pushes run on background threads during builds).
    """
    run_env = dict(os.environ if env is None else env)
    if sys.version_info >= (3, 11):
        popen_kwargs: dict = {"process_group": 0}
    else:
        # Popen(process_group=...) is 3.11+; older versions get
        # start_new_session (setsid in the C child path — a new session
        # IS a new process group, and it's async-signal-safe, unlike a
        # preexec_fn, which matters because cache pushes run on
        # background threads during builds).
        popen_kwargs = {"start_new_session": True}
    if user:
        uid, gid = sysutils.resolve_chown(user)
        popen_kwargs.update(user=uid, group=gid, extra_groups=[])
        try:
            run_env["HOME"] = pwd.getpwuid(uid).pw_dir
        except KeyError:
            run_env["HOME"] = "/"

    proc = subprocess.Popen(
        argv, cwd=workdir, env=run_env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        bufsize=1, **popen_kwargs)
    assert proc.stdout is not None and proc.stderr is not None
    err_tail: list[str] = []
    # Drain threads carry the caller's context so worker-mode log sinks
    # attribute this command's output to the right build.
    import contextvars
    readers = [
        threading.Thread(target=contextvars.copy_context().run,
                         args=(_drain, proc.stdout, log.info)),
        threading.Thread(target=contextvars.copy_context().run,
                         args=(_drain, proc.stderr, log.error, err_tail)),
    ]
    for t in readers:
        t.start()
    for t in readers:
        t.join()
    code = proc.wait()
    if code != 0:
        raise subprocess.CalledProcessError(
            code, argv, stderr="".join(err_tail))
