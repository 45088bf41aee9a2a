"""makisu-tpu's image builder in PyTorch and CUDA.

The port of ``makisu_tpu`` to an NVIDIA H100: the build path (Dockerfile
parsing, stages and cache IDs, snapshots, layer commits, the local cache
and image store, the ``build`` command) with every committed layer's
Gear content-defined chunking and SHA-256 chunk fingerprints on two
kernels written by hand for Hopper (``csrc/``). It imports nothing of
``makisu_tpu`` or JAX. Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"

# Part of every stage's cache-ID seed: the same value as makisu_tpu's, so
# one cache serves both builders.
BUILD_HASH = "dev"
