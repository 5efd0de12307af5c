"""The plain reference: the configurations' models (one module a model,
the contract in ``ctr.py``), the first training steps under the sparse and
dense Adagrad or Adam with the model's auxiliary loss (``train.py``), and
the table's key space and initial rows (``keys.py``), in plain PyTorch. It
imports nothing of the port and nothing of JAX."""
