"""Operations of a DIEN training step (``configs/dien_books.json``), from
the shapes of ``reference/dien.params``.

The matrix products an example takes, as multiply-adds of the forward:
each dense layer ``in * out`` (its weight's shape) times the positions it
runs over. The GRU's and the AUGRU's ``gates`` and ``cand`` and the
attention's layers run at every one of the ``L`` history positions, as
the program computes them (a padded step is computed, then held by a
``where``); ``aux_proj`` at the ``L - 1`` next behaviours and again at
their roll over the batch; ``cand_proj`` and the tower once. ``L`` is the
history length the configuration gives the entry (``--max_len`` in its
``flags``). Every input takes a gradient (the rows are trained), so the
backward takes two products of each. Two FLOPs a multiply-add.
"""
from perfbench.reference import dien

# how many times a layer runs an example, by its name's first part
_PER_POSITION = ("interest_extractor", "att", "interest_evolution")


def history_length(cfg: dict) -> int:
    flags = cfg["flags"]
    return int(flags[flags.index("--max_len") + 1])


def forward_macs(cfg: dict) -> int:
    L = history_length(cfg)
    runs = {"aux_proj": 2 * (L - 1), **{p: L for p in _PER_POSITION}}
    total = 0
    for name, shape, _ in dien.params(cfg):
        if name.endswith(".weight"):
            total += runs.get(name.split(".")[0], 1) * shape[0] * shape[1]
    return total


def train_flops_per_example(cfg: dict) -> int:
    return 2 * 3 * forward_macs(cfg)
