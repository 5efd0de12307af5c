"""deeprec_tpu_torch: the PyTorch + CUDA (Hopper) port of ``deeprec_tpu``.

Imports ``torch`` and never ``jax``: the serving path (checkpoint ->
:class:`~deeprec_tpu_torch.serving.Predictor` -> DLRM -> HTTP) and the
host-index training path (:class:`~deeprec_tpu_torch.train.trainer.Trainer`
over :class:`~deeprec_tpu_torch.host_index.HostIndexEmbeddingCollection`)
run on a machine without JAX. Every Pallas kernel of the JAX package is a
hand-written CUDA kernel in ``csrc/``, built with nvcc at first use: the
row gather (``ops/gather.py``, K1), the fused gather+pool and its backward
(``ops/fused_lookup.py``, K2) and the metadata scatters
(``ops/meta_scatter.py``, K3a/K3b). On CPU tensors they run their plain
PyTorch versions. Layout and names mirror ``deeprec_tpu``.
"""
