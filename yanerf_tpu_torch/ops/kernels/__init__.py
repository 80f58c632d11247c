"""Hand-written CUDA kernels for Hopper, each beside its wrapper and plain PyTorch version.

| Kernel | Replaces (Pallas) | Source |
| --- | --- | --- |
| ``nerf_mlp_fwd`` (K1) | ``yanerf_tpu/ops/pallas/nerf_mlp_kernel.py::_nerf_mlp_kernel`` | ``csrc/nerf_mlp_fwd.cu`` |
| ``nerf_mlp_fwd(..., pipelined=True)`` (K2) | ``nerf_mlp_kernel.py::_nerf_mlp_kernel_pipelined`` | ``csrc/nerf_mlp_fwd_pipelined.cu`` |
| ``nerf_mlp_bwd`` (K3) | ``yanerf_tpu/ops/pallas/nerf_mlp_bwd.py::_nerf_mlp_bwd_kernel`` | ``csrc/nerf_mlp_bwd.cu`` |

K1, K2 and K3's recomputed forward run one tile engine,
``csrc/nerf_mlp_tile.cuh`` (on ``hopper.cuh``); K1 and K2 give the same
bits. ``fused_mlp.py`` joins K1 and K3 in a
``torch.autograd.Function`` (the JAX package's ``make_fused_mlp``).

Each kernel is compiled with ``nvcc`` at first use into ``_build/`` and
loaded with ``ctypes``; importing this package compiles nothing.
"""
