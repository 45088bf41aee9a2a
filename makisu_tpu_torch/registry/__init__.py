"""Registry v2 client: copy of ``makisu_tpu/registry/`` (reference:
lib/registry/)."""

from makisu_tpu_torch.registry import transfer
from makisu_tpu_torch.registry.client import (
    PullHandle,
    RegistryClient,
    new_client,
)
from makisu_tpu_torch.registry.config import (
    RegistryConfig,
    SecurityConfig,
    config_for,
    load_config_map,
)
from makisu_tpu_torch.registry.fixtures import (
    RegistryFixture,
    make_test_image,
)

__all__ = [
    "PullHandle", "RegistryClient", "RegistryConfig", "RegistryFixture",
    "SecurityConfig", "config_for", "load_config_map", "make_test_image",
    "new_client", "transfer",
]
