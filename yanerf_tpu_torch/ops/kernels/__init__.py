"""Hand-written CUDA kernels for Hopper, each beside its wrapper and plain PyTorch version.

| Kernel | Replaces (Pallas) | Source |
| --- | --- | --- |
| ``nerf_mlp_fwd`` (K1) | ``yanerf_tpu/ops/pallas/nerf_mlp_kernel.py::_nerf_mlp_kernel`` | ``csrc/nerf_mlp_fwd.cu`` |
| ``nerf_mlp_fwd(..., pipelined=True)`` (K2) | ``nerf_mlp_kernel.py::_nerf_mlp_kernel_pipelined`` | ``csrc/nerf_mlp_fwd_pipelined.cu`` |
| ``nerf_mlp_bwd`` (K3) | ``yanerf_tpu/ops/pallas/nerf_mlp_bwd.py::_nerf_mlp_bwd_kernel`` | ``csrc/nerf_mlp_bwd.cu`` |
| ``hash_encode_fwd`` (K4) | none: XLA gathers of ``yanerf_tpu/models/hash_grid.py`` | ``csrc/hash_encode.cu`` |
| ``hash_encode_bwd`` (K5) | none: its scatter-adds (the tables' gradient) | ``csrc/hash_encode.cu`` |
| ``sample_pdf`` (K6) | none: XLA's mask of ``yanerf_tpu/ops/sample_pdf.py`` | ``csrc/sample_pdf.cu`` |
| ``proposal_mlp_fwd`` (K7) | none: XLA's layers of ``yanerf_tpu/models/proposal_mlp.py`` | ``csrc/proposal_mlp_fwd.cu`` |

K1, K2 and K3's recomputed forward run one tile engine,
``csrc/nerf_mlp_tile.cuh`` (on ``hopper.cuh``); K1 and K2 give the same
bits. ``fused_mlp.py`` joins K1 and K3 in a
``torch.autograd.Function`` (the JAX package's ``make_fused_mlp``).

Each kernel is compiled with ``nvcc`` at first use into ``_build/`` and
loaded with ``ctypes``; importing this package compiles nothing. K1 and K2
are launched through the ``torch.library`` operator
``yanerf_tpu_torch::nerf_mlp_fwd`` (``nerf_mlp_fwd.nerf_mlp_fwd_op``), so
a traced program (``export.py``) records them by name; K3 is called by
``FusedNerfMlp.backward`` directly. K4 and K5 are the operators
``yanerf_tpu_torch::hash_encode_fwd`` / ``hash_encode_bwd``, joined by
``hash_encode.HashEncode``, which ``HashGridNeRF`` runs on every CUDA
point; they raise for widths they do not take (``hash_encode.takes_widths``). K6 is
the operator ``yanerf_tpu_torch::sample_pdf``, which ``ops/sample_pdf.py``
calls on every device. K7 is the operator
``yanerf_tpu_torch::proposal_mlp_fwd``, which a bfloat16 ``ProposalMLP``
runs on CUDA points with no gradient to carry; it raises for widths it does
not take (``proposal_mlp_fwd.takes_widths``).

The device picks every kernel, and no option does: on CUDA tensors the
kernel, on CPU tensors its plain version (K1, K3, K6) or the model's plain
path (K4, K5, K7; K7 also under autograd and for a float32 model).
"""
