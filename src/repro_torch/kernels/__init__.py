"""Kernels: hand-written CUDA for the card, plain PyTorch versions beside them."""
