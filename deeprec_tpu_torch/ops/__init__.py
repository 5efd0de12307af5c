"""Dedup and the hand-written CUDA kernels K1 (gather), K2 (gather+pool,
forward and backward) and K3a/K3b (metadata scatters)."""
