"""PyTorch/CUDA port of yolov4_tpu: the detection, evaluation and
training paths on one NVIDIA H100.

The JAX package ``yolov4_tpu`` is the reference this package is held
against; nothing here imports it or JAX.
"""
