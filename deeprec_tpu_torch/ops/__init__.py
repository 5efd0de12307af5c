"""Dedup and the hand-written CUDA kernels K1 (gather), K2 (gather+pool,
forward and backward), K3a/K3b (metadata scatters) and K4/K5 (the hash
index's probe loops), and DLRM's dot interaction (forward and
backward)."""
