"""RootPreserver: snapshot the build root before a modifyfs build and
restore it afterwards (reference: root_preserver.go:26-75 in lib/storage,
used by --preserve-root).
"""

from __future__ import annotations

import os

from makisu_tpu_torch.utils import fileio
from makisu_tpu_torch.utils import logging as log


class RootPreserver:
    def __init__(self, root: str, backup_dir: str,
                 blacklist: list[str]) -> None:
        self.root = root
        self.backup_dir = os.path.join(backup_dir, "root_backup")
        # Never back up the backup location itself.
        self.blacklist = list(blacklist) + [self.backup_dir]
        log.info("preserving root %s to %s", root, self.backup_dir)
        copier = fileio.Copier(self.blacklist)
        copier.copy_dir(root, self.backup_dir)

    def restore(self) -> None:
        from makisu_tpu_torch.snapshot.walk import remove_all_children
        log.info("restoring root %s", self.root)
        remove_all_children(self.root, self.blacklist)
        copier = fileio.Copier([])
        copier.copy_dir(self.backup_dir, self.root)
