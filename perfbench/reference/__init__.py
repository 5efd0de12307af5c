"""The plain reference: the configurations' towers, the sparse and dense
Adagrad updates and the table's initial rows, in plain PyTorch. It imports
nothing of the port and nothing of JAX."""
