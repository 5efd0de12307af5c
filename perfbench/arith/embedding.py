"""HBM bytes of the embedding functions of one training step, from its
shapes (as ``chip_smoke.py``'s ``bound``: each input byte read once, each
output byte written once, whatever kernel does the work).

``lanes`` ids a step (id lanes an example x batch, padding included:
K2 reads and writes every lane), ``width`` the dedup's static width
(``max_unique + 1``), ``n_unique`` the valid distinct keys of the step
(the rows that hold data; the rest of the width points at the null row),
``dim`` the embedding width, ``row`` the stored row's width (the value
and the optimizer's fused slot columns, :func:`row_floats`). float32
rows, int64 ids and slots, int32 counts and metadata, bool masks.

* the row fetch (K1, ``gather_rows``): slots, the rows read, the
  ``[width, dim]`` leaf written;
* the pooling forward (K2): inverse and validity of every lane, the rows,
  the ``[lanes, dim]`` pooled output;
* the pooling backward (K2-bwd): the pooled gradient, inverse and
  validity, the ``[width, dim]`` row gradient;
* the optimizer's row read (K1 over whole rows): slots, the stored rows,
  ``[width, row]`` written;
* the metadata (K3a, ``lookup_meta``): slots, counts and destinations of
  the width, the three int32 planes read and written at the live slots,
  the admission mask.
"""
F32, I64, I32, BOOL = 4, 8, 4, 1


def step_bytes(lanes: int, width: int, n_unique: int, dim: int,
               row: int) -> int:
    fetch = width * I64 + n_unique * dim * F32 + width * dim * F32
    pool = lanes * (I64 + BOOL) + n_unique * dim * F32 + lanes * dim * F32
    pool_bwd = lanes * dim * F32 + lanes * (I64 + BOOL) + width * dim * F32
    opt_read = width * I64 + n_unique * row * F32 + width * row * F32
    meta = width * (I64 + I32 + I64) + n_unique * 3 * I32 * 2 + width * BOOL
    return fetch + pool + pool_bwd + opt_read + meta


SLOT_ROWS = {"adagrad": 1, "adam": 2}  # the fused slots: a, or m and v


def row_floats(cfg: dict) -> int:
    """The stored row's width under the configuration's optimizer."""
    return cfg["emb_dim"] * (1 + SLOT_ROWS[cfg["optimizer"]])
