"""mkrootfs: pull an image and untar its rootfs into a directory.

Reference: tools/bin/mkrootfs/main.go (same path as ``pull --extract``).
Copy of ``makisu_tpu/tools/mkrootfs.py`` over this package's ``pull``.

Usage: python -m makisu_tpu_torch.tools.mkrootfs <image> <dest-dir> [storage]
"""

from __future__ import annotations

import sys


def main(argv: list[str] | None = None) -> int:
    from makisu_tpu_torch import cli
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    image, dest = argv[0], argv[1]
    extra = ["--storage", argv[2]] if len(argv) > 2 else []
    return cli.main(["pull", image, "--extract", dest, *extra])


if __name__ == "__main__":
    sys.exit(main())
