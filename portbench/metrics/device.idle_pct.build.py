"""device.idle_pct.build: the share of the traced window of a build cell
in which no kernel, copy or memset ran on the card, in %."""

from portbench.metrics._common import idle_pct


def read(run):
    return idle_pct(run)
