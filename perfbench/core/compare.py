"""The comparison that decides ``correct``.

Both sides give readings of the cell's first three training steps (see
``reference/train.py``): each step's loss, each leaf's first-gradient norm,
each leaf's change norm after the three steps, the keys the program's
index lacks, and each key's frequency. The numbers compared:

* ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps.
* ``grad_gap``: over the leaves (every dense parameter, and ``emb``, the
  rows of the checked keys), the largest ``| |g| - |g_ref| |`` divided by
  the larger of ``|g_ref|`` and the median leaf's ``|g_ref|``.
* ``change_gap``: the same of the change, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (a leaf below
  that moves under Adagrad by round-off alone).
* ``index_misses``: checked keys the program's index does not hold.
* ``freq_misses``: checked keys whose frequency differs from the
  reference's count.

Each number passes when it is at most its limit (the cell file's
``limits``).
"""
from __future__ import annotations

import statistics
from typing import Dict

import numpy as np

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "index_misses",
           "freq_misses")


def _largest(values) -> float:
    """The largest of ``values``; infinity where one is not a number."""
    values = [float(v) for v in values]
    return float("inf") if any(v != v for v in values) else max(values)


def _worst(side: Dict[str, float], ref: Dict[str, float], keep):
    """``(gap, leaf)`` of the leaf in ``keep`` with the widest gap."""
    med = statistics.median(ref[k] for k in keep)
    gaps = {k: abs(side.get(k, 0.0) - ref[k]) / max(ref[k], med)
            for k in keep}
    leaf = max(keep, key=lambda k: (gaps[k] != gaps[k], gaps[k]))
    return _largest(gaps.values()), leaf


def _moving(ref: dict):
    med = statistics.median(ref["grad"].values())
    return [k for k in sorted(ref["grad"]) if ref["grad"][k] >= 1e-3 * med]


def worst_leaves(side: dict, ref: dict) -> Dict[str, str]:
    """The leaf that sets ``grad_gap`` and the one that sets
    ``change_gap``."""
    return {"grad": _worst(side["grad"], ref["grad"], sorted(ref["grad"]))[1],
            "change": _worst(side["change"], ref["change"], _moving(ref))[1]}


def numbers(side: dict, ref: dict) -> Dict[str, float]:
    loss = _largest(abs(a - b) / abs(b)
                    for a, b in zip(side["loss"], ref["loss"]))
    return {
        "loss_gap": loss,
        "grad_gap": _worst(side["grad"], ref["grad"],
                           sorted(ref["grad"]))[0],
        "change_gap": _worst(side["change"], ref["change"], _moving(ref))[0],
        "index_misses": int(side["index_misses"]),
        "freq_misses": int(np.sum(np.asarray(side["freqs"])
                                  != np.asarray(ref["freqs"]))),
    }


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(nums[k] <= limits[k] for k in NUMBERS)
