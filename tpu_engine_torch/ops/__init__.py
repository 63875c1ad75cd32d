"""Attention and the hand-written CUDA kernels behind it."""
