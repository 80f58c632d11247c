"""yanerf_tpu_torch: the PyTorch / CUDA port of yanerf_tpu for NVIDIA Hopper.

A package beside ``yanerf_tpu`` that imports ``torch`` and nothing of JAX
or of ``yanerf_tpu``. It reads the same config files. This slice ports the
serving path of the two-level proposal flagship
(``configs/nerf/lego_proposal.yml``), with the NeRF-MLP forward as a
hand-written CUDA kernel; see ROADMAP.md for what is still to come.
"""

__version__ = "0.1.0"
