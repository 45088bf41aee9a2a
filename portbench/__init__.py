"""portbench: the benchmark of ``makisu_tpu_torch``, the PyTorch and CUDA
port, on NVIDIA cards. ``python3 portbench/run.py --help``; PERF.md says
what each cell and metric measures."""
