"""Tensor ops of the port: plain PyTorch functions, and the hand-written kernels under ``kernels/``."""
