"""Hand-written CUDA kernels for Hopper, each beside its wrapper and plain PyTorch version.

| Kernel | Replaces (Pallas) | Source |
| --- | --- | --- |
| ``nerf_mlp_fwd`` | ``yanerf_tpu/ops/pallas/nerf_mlp_kernel.py::_nerf_mlp_kernel`` | ``csrc/nerf_mlp_fwd.cu`` |

Each kernel is compiled with ``nvcc`` at first use into ``_build/`` and
loaded with ``ctypes``; importing this package compiles nothing.
"""
