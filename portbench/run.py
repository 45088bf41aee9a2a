"""Run one benchmark cell once, from the root of a checkout:

    python3 portbench/run.py --workload node-app.commit --seed 7 \
        --seconds 30 --trace 0

Prints one JSON line as the last line of standard output (see
``portbench/harness.py``). Needs an NVIDIA card.
"""

import time

T0 = time.perf_counter()  # set-up is counted from here

import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
