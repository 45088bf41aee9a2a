"""Chunk-native distribution plane: serve images, not just build them.

Copy of ``makisu_tpu/serve/``. Built layers publish signed recipes
(ordered chunk -> pack tables, ``recipe.py``), a serve endpoint answers
ranged pack fetches synthesized from the chunk CAS under the transfer
engine's memory budget (``server.py``), and chunk-aware clients
delta-pull, fetching only the chunks they lack and checking the
registry's digests byte for byte before install (``client.py``). The
fleet's peer exchange rides the same endpoint (``fleet/peers.py``).
"""

from makisu_tpu_torch.serve.client import (  # noqa: F401
    ServeClient,
    delta_pull_layer,
    pull_image_delta,
)
from makisu_tpu_torch.serve.recipe import (  # noqa: F401
    RECIPE_SCHEMA,
    RecipeStore,
)
from makisu_tpu_torch.serve.server import (  # noqa: F401
    ServeServer,
    enable_publishing,
    publish_enabled,
    register_store,
    serve_stats,
    store_for,
    stores,
)
