"""lili_om_tpu_torch — the PyTorch/CUDA port of ``lili_om_tpu``.

The per-scan SLAM loop (spinning-LiDAR feature extraction → scan-to-map
odometry → sliding-window LiDAR-inertial fusion) as plain functions on
tensors, with the exact 5-NN map search as a hand-written CUDA kernel for
Hopper (``csrc/knn.cu``). The layout mirrors ``lili_om_tpu`` module for
module, so each function sits at the same path as its JAX counterpart.

This package imports ``torch`` and ``numpy`` only. Its entry points run on
the CUDA device unless the caller passes ``device="cpu"``; with no CUDA
device and ``device=None`` they raise instead of running on the CPU.
"""

__version__ = "0.1.0"
