"""lili_om_tpu_torch — the PyTorch/CUDA port of ``lili_om_tpu``.

The SLAM system (spinning-LiDAR or Livox Horizon feature extraction →
scan-to-map odometry → sliding-window LiDAR-inertial fusion, with the
keyframe archive, the local pose graph and loop closure) as plain functions
on tensors, with every Pallas kernel of the JAX package as a hand-written
CUDA kernel for Hopper (``csrc/``: the exact 5-NN map search, dense and
pruned, and the sorted segment sum). The layout mirrors ``lili_om_tpu``
module for module, so each function sits at the same path as its JAX
counterpart.

This package imports ``torch`` and ``numpy`` only. Its entry points run on
the CUDA device unless the caller passes ``device="cpu"``; with no CUDA
device and ``device=None`` they raise instead of running on the CPU.
"""

__version__ = "0.1.0"
