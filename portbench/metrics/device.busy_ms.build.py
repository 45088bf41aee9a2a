"""device.busy_ms.build: per build, the card's G1 and S1 kernel time in
ms, as the program counts it (``device_busy_seconds``: CUDA timing events
around each launch, summed once its digests are back)."""

from portbench.metrics._program import per_build


def read(run):
    def value(line):
        seconds = line.get("device_busy_seconds")
        return None if seconds is None else 1000.0 * seconds

    return per_build(run, value)
