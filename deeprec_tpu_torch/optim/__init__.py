"""Sparse (row) and dense optimizers."""
