"""Attention ops of the port: hand-written Hopper kernels beside their
plain PyTorch versions."""
