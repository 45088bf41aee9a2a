"""Manifest store: repo:tag → distribution manifest JSON on disk.

Copy of ``makisu_tpu/storage/manifests.py`` (reference capability:
lib/storage/manifest_store.go:39-99, LRU 16). Keys are
``<repo>/<tag>`` with path separators in the repo preserved as directories.
"""

from __future__ import annotations

import json
import os
import threading

from makisu_tpu_torch.docker.image import DistributionManifest, ImageName
from makisu_tpu_torch.utils import fileio


class ManifestStore:
    def __init__(self, root: str, max_entries: int = 16) -> None:
        self.root = root
        self.max_entries = max_entries
        self._lock = threading.Lock()
        os.makedirs(root, exist_ok=True)

    def _path(self, name: ImageName) -> str:
        tag = name.tag.replace(":", "_")
        return os.path.join(self.root, name.repository, tag + ".json")

    def save(self, name: ImageName, manifest: DistributionManifest) -> str:
        p = self._path(name)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with self._lock:
            # Atomic + fsynced: a SIGTERM between the old tmp-write and
            # rename left a torn manifest for the tag — the image looks
            # pushed/saved but cannot be loaded.
            fileio.write_json_atomic(p, manifest.to_json())
            self._evict_locked()
        return p

    def load(self, name: ImageName) -> DistributionManifest:
        with open(self._path(name)) as f:
            return DistributionManifest.from_json(json.load(f))

    def exists(self, name: ImageName) -> bool:
        return os.path.isfile(self._path(name))

    def _evict_locked(self) -> None:
        entries: list[tuple[float, str]] = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".json"):
                    p = os.path.join(dirpath, fn)
                    entries.append((os.path.getmtime(p), p))
        entries.sort()
        while len(entries) > self.max_entries:
            _, victim = entries.pop(0)
            os.unlink(victim)
