"""The modelzoo entry points of the port: one ``<Model>/train.py`` per
model of ``modelzoo/``, each a ``build(args) -> train.cli.ModelSpec`` and a
``__main__`` that trains it (``python -m
deeprec_tpu_torch.modelzoo.DLRM.train --host_index ...``)."""
