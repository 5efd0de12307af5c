"""A cell cut to a size the CPU runs in seconds: the tests' stand-in for
the card (the program's kernels run their plain versions on CPU
tensors)."""
from perfbench.core import session


def tiny(cell_name="dlrm_kaggle.train_b64k", batch=128, examples=1024):
    cell = session.load_json("cells", cell_name)
    cell.update(batch=batch, pool_examples=examples, trace_steps=3, lead_steps=2,
                warm_steps=1)
    cfg = session.load_json("configs", cell["config"])
    cfg["capacity"] = 1 << 17
    mix = session.load_json("traffic", cell["traffic"])
    mix["column_counts"] = [min(c, 3000) for c in mix["column_counts"]]
    return cell, cfg, mix
