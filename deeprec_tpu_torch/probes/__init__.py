"""Design probes run on the card (``python -m deeprec_tpu_torch.probes.kernel_probe``):
variants of the port's kernels that measure what bounds them. Nothing in
the port imports them."""
