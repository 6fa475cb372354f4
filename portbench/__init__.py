"""The benchmark of the PyTorch/CUDA port (``yolov4_tpu_torch``) on one
NVIDIA H100: cells named in ``BENCHMARK.json`` at the repository root, run
one at a time by ``python3 portbench/run.py``."""
