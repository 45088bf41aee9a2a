"""setup_s: from the interpreter's first line of the harness to the start
of the window: torch's import, the device plane's probe, the inputs made
from the seed, what the cell's traffic needs before it (a cold build
that fills the cache) and the untimed warm-up iteration."""


def read(run):
    return run.setup_s
