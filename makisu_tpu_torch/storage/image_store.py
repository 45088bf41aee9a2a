"""ImageStore: the per-build local store = sandbox + manifests + layer CAS.

Reference: lib/storage/image_store.go:28-61 (NewImageStore at :36, sandbox
cleanup at :64). Layout under the storage root:

    <root>/manifests/...          repo/tag manifest JSON
    <root>/layers/<aa>/<hex>      gzipped layer tars, content-addressed
    <root>/sandbox/<build-id>/    scratch space, deleted after the build
"""

from __future__ import annotations

import os
import shutil
import tempfile

from makisu_tpu_torch.storage.cas import CASStore
from makisu_tpu_torch.storage.manifests import ManifestStore


class ImageStore:
    def __init__(self, root: str, layer_cap: int = 256,
                 manifest_cap: int = 16) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.manifests = ManifestStore(
            os.path.join(root, "manifests"), manifest_cap)
        self.layers = CASStore(os.path.join(root, "layers"), layer_cap)
        sandbox_root = os.path.join(root, "sandbox")
        os.makedirs(sandbox_root, exist_ok=True)
        self.sandbox_dir = tempfile.mkdtemp(prefix="build-", dir=sandbox_root)

    def cleanup_sandbox(self) -> None:
        shutil.rmtree(self.sandbox_dir, ignore_errors=True)

    def __enter__(self) -> "ImageStore":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup_sandbox()
