"""makisu-tpu's layer-commit chunk fingerprinting in PyTorch and CUDA.

The port of ``makisu_tpu``'s device path to an NVIDIA H100: Gear
content-defined chunking and lane-parallel SHA-256 of each layer's tar
stream, on two kernels written by hand for Hopper (``csrc/``). It
imports nothing of ``makisu_tpu`` or JAX. Entry points run on the card
unless the caller passes ``device="cpu"``.
"""
