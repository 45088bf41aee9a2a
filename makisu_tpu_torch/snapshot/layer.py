"""Layer model: the set of changes one build step commits.

A layer maps logical paths to entries — file content (with its on-disk
source for tar streaming) or whiteouts (deletions). Committing writes
entries to a tar stream in sorted path order, which both makes layer bytes
deterministic and groups whiteouts with their siblings.

Copy of ``makisu_tpu/snapshot/layer.py`` with the serial writer only:
the reference's pooled read-ahead produces the same tar bytes and is not
part of the port (reference capability: lib/snapshot/mem_layer.go).
"""

from __future__ import annotations

import dataclasses
import os
import tarfile

from makisu_tpu_torch import tario
from makisu_tpu_torch.snapshot.walk import WHITEOUT_PREFIX
from makisu_tpu_torch.utils import pathutils


@dataclasses.dataclass
class ContentEntry:
    """A file/dir/symlink present in the layer; content streams from
    ``src`` on disk at commit time."""

    src: str
    dst: str  # logical absolute path; layer key
    hdr: tarfile.TarInfo

    def commit(self, tw: tarfile.TarFile) -> None:
        tario.write_entry(tw, self.src, self.hdr)


@dataclasses.dataclass
class WhiteoutEntry:
    """A deletion: commits as an empty ``.wh.<name>`` marker."""

    deleted: str  # logical absolute path being deleted; layer key

    def commit(self, tw: tarfile.TarFile) -> None:
        d, b = os.path.split(self.deleted)
        hdr = tarfile.TarInfo(
            pathutils.rel_path(os.path.join(d, WHITEOUT_PREFIX + b)))
        tw.addfile(hdr)


class Layer:
    """Ordered path → entry map for one committed layer."""

    def __init__(self) -> None:
        self.entries: dict[str, ContentEntry | WhiteoutEntry] = {}

    def __len__(self) -> int:
        return len(self.entries)

    def add_header(self, src: str, dst: str,
                   hdr: tarfile.TarInfo) -> ContentEntry | WhiteoutEntry:
        """Record a content entry (or a whiteout, if dst basename carries
        the whiteout prefix — as found in pulled layer tars)."""
        dst = pathutils.abs_path(dst)
        d, b = os.path.split(dst)
        if b.startswith(WHITEOUT_PREFIX):
            entry = WhiteoutEntry(os.path.join(d, b[len(WHITEOUT_PREFIX):]))
            self.entries[entry.deleted] = entry
        else:
            entry = ContentEntry(src, dst, hdr)
            self.entries[dst] = entry
        return entry

    def add_whiteout(self, deleted: str) -> WhiteoutEntry:
        deleted = pathutils.abs_path(deleted)
        if os.path.basename(deleted).startswith(WHITEOUT_PREFIX):
            raise ValueError(f"path already carries whiteout prefix: {deleted}")
        entry = WhiteoutEntry(deleted)
        self.entries[deleted] = entry
        return entry

    def commit(self, tw: tarfile.TarFile) -> None:
        """Write entries in sorted path order (cache-identity-bearing)."""
        for key in sorted(self.entries):
            self.entries[key].commit(tw)
