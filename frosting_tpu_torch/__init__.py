"""PyTorch/CUDA port of frosting_tpu for NVIDIA Hopper GPUs.

Mirrors the module layout of ``frosting_tpu`` (the JAX reference) so each
module has a counterpart at the same relative path. This package imports
``torch`` and numpy only, never JAX or ``frosting_tpu``. Kernels written for
the TPU in Pallas are hand-written CUDA C++ here (``csrc/``), built with
``nvcc`` at first use (see ``_build.py``).
"""

__version__ = "0.1.0"
