"""The control: the reference computed with TF32 products (the precision
below the configurations' float32) in the program's place has to come
out not correct, and so has half of each batch left out, while the
program itself passes. On the card, at the cell's own size (one seed a
cell here; ``perfbench/calibrate.py`` reads a dozen)."""
import pytest

from perfbench import calibrate
from perfbench.core import compare, session

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in session.benchmark()["workloads"]]


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_and_half_a_batch_fail(card, cell_name):
    cell = session.load_json("cells", cell_name)
    cfg = session.load_json("configs", cell["config"])
    mix = session.load_json("traffic", cell["traffic"])
    r = calibrate.seed_readings(cell, cfg, mix, 3000000101, card, True)
    assert compare.verdict(r["program"], cell["limits"]), r["program"]
    assert not compare.verdict(r["control"], cell["limits"]), r["control"]
    assert not compare.verdict(r["half"], cell["limits"]), r["half"]
