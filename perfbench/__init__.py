"""The benchmark of ``deeprec_tpu_torch`` (see ``perfbench/README.md``)."""
