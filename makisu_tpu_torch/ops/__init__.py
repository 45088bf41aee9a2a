"""Kernels of the layer-commit hot path and their plain versions.

- ``gear`` / ``gear_cuda``: Gear candidate-boundary bitmap.
- ``sha256`` / ``sha256_cuda``: SHA-256 over many ragged lanes at once.
- ``_build``: compiles ``csrc/*.cu`` with nvcc on first use.
- ``backend``: device selection, CUDA-event timing, dispatch tallies.
"""
