"""What the DLRM cell reads has not moved: at a size the CPU runs, the
pool, the weights, the admitted table (its counts, its index, rows and
frequencies after the checked steps), the program's readings of those
steps and the reference's are bit-equal to those of the harness before
it took histories, shared spaces and other optimizers (digests taken
there, on one CPU thread, and pinned here)."""
import hashlib
import json

import numpy as np
import pytest
import torch

from perfbench.core import program, session
from perfbench_tiny import tiny

PINNED = {
    "pool": "3f26fbee68a98aad",
    "weights": "b98901610bfa50d4",
    "table": '{"failed_inserts": 0, "keys": 44360, "slots": 131072}',
    "index": "b7fac14777f8a3cf",
    "side": "e0d072dfda88c5e2",
    "ref": "36be728298ae587f",
}


def _h(items) -> str:
    d = hashlib.sha256()
    for x in items:
        d.update(x if isinstance(x, bytes)
                 else np.ascontiguousarray(x).tobytes())
    return d.hexdigest()[:16]


def _readings(r) -> list:
    return [np.asarray(r["loss"], np.float64),
            np.asarray(list(r["grad"].values()), np.float64),
            np.asarray(list(r["change"].values()), np.float64)]


def digests(seed: int) -> dict:
    cell, cfg, mix = tiny()
    p = session.prepare(cell, cfg, mix, seed, "cpu")
    ev = p.state.tables["emb"].ev
    s = p.side
    out = {
        "pool": _h([np.stack([sp.ids for sp in p.pool.spaces]),
                    np.asarray(p.pool.unique_counts, np.int64)]
                   + [x for b in p.pool.batches for k in sorted(b)
                      for x in (k.encode(), b[k])]),
        "weights": _h([w.cpu().numpy() for w in p.weights.values()]),
        "table": json.dumps(program.table_keys(p.state), sort_keys=True),
        "index": _h([ev.index.keys.cpu().numpy(), ev.values.cpu().numpy(),
                     ev.freqs.cpu().numpy()]),
        "side": _h(_readings(s) + [np.asarray([s["index_misses"]]),
                                   s["freqs"]]),
    }
    r = session.reference_readings(cfg, p._replace(tr=None, state=None),
                                   "cpu")
    out["ref"] = _h(_readings(r) + [np.asarray(r["freqs"], np.int64)])
    return out


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_dlrm_cell_reads_what_it_read_before(one_thread):
    assert digests(2 ** 31 + 77) == PINNED
