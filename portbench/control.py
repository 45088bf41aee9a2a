"""The control of ``correct``: a run of a cell in which the judge finds the
reference's chunk lists in the place of the program's, cut as a parallel
chunker would be tempted to cut them: every ``--block`` bytes of the
layer stream (default 4 MiB, G1's block) chunked as a stream of its own,
with no history and no uncut tail carried across a block end. It breaks
the guarantee that cuts are a function of the whole stream, and must
come out not correct. The benchmark's own runs never run it.

    python3 portbench/control.py --workload node-app.commit --seconds 1 \
        --seed 11 --seed 12 --seed 13

Each seed is one harness run at the cell's own size, in one process,
printing the harness's result line (its ``compared`` key holds the
control's readings).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CONTROL_BLOCK = 4 << 20


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--block", type=int, default=CONTROL_BLOCK)
    args = p.parse_args(argv)
    rc = 0
    for k, seed in enumerate(args.seed):
        rc |= harness.main(["--workload", args.workload, "--seed", str(seed),
                            "--seconds", str(args.seconds)],
                           t0=T0 if k == 0 else None,
                           control_block=args.block)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
