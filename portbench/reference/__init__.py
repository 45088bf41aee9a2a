"""The plain reference that decides ``correct``: NumPy, plain PyTorch and
the standard library (``tarfile``, ``gzip``, ``zlib``, ``hashlib``).

It imports neither JAX nor any package of this repository's programs,
and takes nothing that the program made: it works every answer out
again from the benchmark's own inputs and reads the program's outputs
only to judge them. Where it needs one of the program's plain versions
(the Gear table and recurrence, the chunk-size policy, the pgzip block
format), it holds a frozen copy that names its source.
"""
