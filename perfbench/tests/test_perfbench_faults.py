"""A whole run but for the look for a card, at a size the CPU holds, with
the timed path sound and then broken underneath: ``correct`` has to come
out true, then false for each fault a one-card training cell can have (a
step that returns its state unchanged; half of the batch left out, the
mean taken over the rest)."""
import time

import pytest

from perfbench.core import session
from deeprec_tpu_torch.train.trainer import Trainer
from perfbench_tiny import tiny

BENCH = session.benchmark()


def _run(cell_name, trace=False):
    cell, cfg, mix = tiny(cell_name)
    return session.run(cell, cfg, mix, 2 ** 31 + 77, 0.3, trace, "cpu",
                       time.perf_counter(), BENCH, lambda m: None)


@pytest.mark.parametrize("cell_name", ["dlrm_kaggle.train_b64k",
                                       "dcn_kaggle.train_b64k"])
def test_a_sound_run_is_correct(cell_name):
    out = _run(cell_name)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {m["name"] for m in BENCH["end_to_end"]}
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"


def test_a_traced_run_bounds_its_window_and_breaks_it_down():
    """The CPU has no device operations: the device's readers find
    nothing; the packing span is read, and the line carries the window and
    the breakdown."""
    out = _run("dlrm_kaggle.train_b64k", trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 3 and set(out["metrics"]) == {"host_pack_ms"}
    assert "breakdown" in out and out["device"]["window_s"] > 0


def test_the_table_holds_every_id_of_the_range():
    cell, cfg, mix = tiny()
    out = _run("dlrm_kaggle.train_b64k")
    assert out["table"] == {"keys": sum(mix["column_counts"]),
                            "slots": cfg["capacity"], "failed_inserts": 0}


def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(Trainer, "_train_step",
                        lambda self, state, *item: state)
    out = _run("dlrm_kaggle.train_b64k")
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] == pytest.approx(1.0)


def test_half_a_batch_left_out_is_caught(monkeypatch):
    step = Trainer._train_step

    def half(self, state, dense, cats, labels):
        n = labels.shape[0] // 2
        return step(self, state, dense[:n],
                    {k: v[..., :n] for k, v in cats.items()}, labels[:n])
    monkeypatch.setattr(Trainer, "_train_step", half)
    out = _run("dcn_kaggle.train_b64k")
    assert not out["correct"]
    c = out["checks"]
    assert c["loss_gap"]["value"] > c["loss_gap"]["limit"]
