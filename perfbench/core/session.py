"""One run of a cell: set-up, the measured (or traced) window, the check.

Set-up, all counted in ``setup_s``: the pool from ``--seed`` (on the
device, by the mix's generator), the trainer built as the entry points
build it, the benchmark's weights copied in (the reference's parameter
list, ``core/weights.py``), the table filled (``program.admit``, space by
space: the pool's keys, then every id of the dataset's range), the cell's
first three steps (the steps the reference follows), then ``warm_steps``
more: every shape the window uses has run. Every step, those of set-up
too, goes through the CLI's device-index loop (``program.drive``):
prefetch workers pack and copy each batch while the main thread runs the
step. The window drives that
loop over the pool with no fences until ``--seconds`` have passed on the
host clock (the workers draw no batch after that), and ends on a
synchronize after the last step: the rate is every step the window ran
over all of its time. With ``--trace 1`` the loop runs ``lead_steps``
steps, so that its workers are ahead, then ``trace_steps`` steps under the
profiler instead (``core/trace``: the window opens and closes on a
synchronize between steps); the per-layer readers take their metrics from
that trace and from a host-clock span around the packing of each traced
step's batch (``Trainer.prepare_host``, in the prefetch workers). Once the
window has closed and the peak memory is read, the program's state is
freed and the reference follows the first three steps (``core/compare``).
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from perfbench import arith
from perfbench import metrics as readers
from perfbench.core import compare, program, traffic, weights
from perfbench.core import trace as tracing
from perfbench.reference import ctr
from perfbench.reference import train as reference

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deeprec_tpu")


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def benchmark() -> dict:
    with open(HERE.parent / "BENCHMARK.json") as f:
        return json.load(f)


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one that no run may load,
    compared whole (``deeprec_tpu_torch`` is not ``deeprec_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class TracedRun(NamedTuple):
    """What a per-layer reader reads (``metrics/``)."""
    trace: Optional[tracing.Trace]
    steps: int
    batch: int
    examples: int
    pack_s: List[float]   # host time of each batch's packing in the window
    cfg: dict
    arith: object
    width: int
    unique_counts: List[int]
    lanes: List[int]      # id lanes of each traced step, padding included


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Prepared(NamedTuple):
    """A cell's program after its checked steps, and what the reference
    needs to follow them."""
    tr: object
    args: object          # the CLI flags the trainer was built from
    state: object
    pool: traffic.Pool
    weights: Dict[str, torch.Tensor]
    checked: list
    keyset: reference.KeySet
    side: dict            # the program's readings of the checked steps
    most_distinct: int    # the most dedup groups of a pool batch


def dedup_groups(pool: traffic.Pool) -> List[int]:
    """Each pool batch's dedup groups: its distinct keys, and one more
    where it holds padding (the padding's key is a group of its own)."""
    full = pool.width * pool.batch
    return [u + (v < full) for u, v in zip(pool.unique_counts, pool.lanes)]


def prepare(cell: dict, cfg: dict, mix: dict, seed: int,
            device: str) -> Prepared:
    """Set-up up to and with the checked steps."""
    batch = int(cell["batch"])
    pool = traffic.make_pool(mix, int(cell["pool_examples"]), batch, seed,
                             device)
    most = max(dedup_groups(pool))
    tr, args = program.build(cfg, batch,
                             (most + 0.5) / (pool.width * batch), seed,
                             device)
    params = ctr.model(cfg).params(cfg)
    w = weights.make(params, seed, device)
    program.load_weights(tr, params, w)
    state = tr.init(pool.batches[0])
    state = program.admit(tr, state, pool, int(cfg["admission_passes"]))
    checked = pool.batches[:3]
    keyset = reference.KeySet(pool.spaces, checked)
    state, side = program.checked_steps(tr, args, state, cfg, w, checked,
                                        keyset)
    return Prepared(tr, args, state, pool, w, checked, keyset, side, most)


def reference_readings(cfg: dict, p: Prepared, device: str,
                       **variant) -> dict:
    """The reference's readings of ``p``'s checked steps (``variant``:
    ``tf32`` or ``half``, see ``reference.train.readings``)."""
    freq0 = int(cfg["admission_passes"]) * (1 + reference.pool_counts(
        p.keyset, p.pool, device))
    return reference.readings(cfg, p.weights, p.checked, p.keyset, freq0,
                              device, **variant)


def run(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
        trace: bool, device: str, t_start: float, bench: dict,
        log: Callable[[str], None] = print) -> dict:
    """One run; returns the result line (a dict)."""
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    batch = int(cell["batch"])
    p = prepare(cell, cfg, mix, seed, device)
    tr, args, state, pool = p.tr, p.args, p.state, p.pool
    nb = len(pool.batches)
    at = [3]  # the next pool batch; the checked steps took 0..2

    def batches(stop):
        while not stop():
            b = pool.batches[at[0] % nb]
            at[0] += 1
            yield b

    def steps(n):
        left = [n]

        def stop():
            left[0] -= 1
            return left[0] < 0
        return batches(stop)
    state, _ = program.drive(tr, args, state, steps(int(cell["warm_steps"])))
    health = state.tables[program.COLLECTION].health
    saturated0 = int(health[1]) if health is not None else 0
    table = program.table_keys(state)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s: pool of {nb} batches of {batch}, dedup "
        f"width {tr.collections['emb'].config.max_unique} (most dedup "
        f"groups a batch {p.most_distinct}); table {table}")

    traced = None
    if trace:
        n_traced, lead = int(cell["trace_steps"]), int(cell["lead_steps"])
        cap = tracing.Capture(cuda)
        packs: List[tuple] = []
        prepare_host = tr.prepare_host

        def packed(*a, **kw):
            t = time.perf_counter()
            out = prepare_host(*a, **kw)
            packs.append((t, time.perf_counter() - t))
            return out
        tr.prepare_host = packed

        def window(state, done):
            if done == lead:
                cap.start()
            elif done == lead + n_traced:
                cap.stop()
            return state
        first = at[0] + lead
        state, _ = program.drive(tr, args, state, steps(lead + n_traced),
                                 window)
        del tr.prepare_host
        # the traced steps' batches are the last the workers began
        pack_s = [d for _, d in sorted(packs)[-n_traced:]]
        tr_ = cap.trace
        uniq = [pool.unique_counts[(first + k) % nb] for k in range(n_traced)]
        traced = TracedRun(tr_, n_traced, batch, n_traced * batch, pack_s,
                           cfg, arith.load(cfg["name"]),
                           tr.collections["emb"].config.max_unique + 1, uniq,
                           [pool.width * batch] * n_traced)
        attempted = n_traced
        log(f"traced {n_traced} steps after {lead} in {tr_.window_s:.4f} s: "
            f"{n_traced * batch / tr_.window_s:.1f} examples/s, device busy "
            f"{tr_.busy_s:.4f} s")
    else:
        t0 = time.perf_counter()
        state, n = program.drive(tr, args, state, batches(
            lambda: time.perf_counter() - t0 >= seconds))
        _sync(device)
        elapsed = time.perf_counter() - t0
        attempted = n
        log(f"window: {n} steps in {elapsed:.4f} s")
    health = state.tables[program.COLLECTION].health
    failed = (int(health[1]) if health is not None else 0) - saturated0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    p = p._replace(tr=None, state=None)
    del state, tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference_readings(cfg, p, device)
    nums = compare.numbers(p.side, ref)
    limits = cell["limits"]
    correct = compare.verdict(nums, limits)

    metrics: Dict[str, dict] = {}
    if trace:
        for m in bench["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            v = readers.load(m["name"]).read(traced)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"train_examples_per_s": n * batch / elapsed,
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if cell["name"] in m.get("workloads", [cell["name"]])}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = traced.trace.busy_s
        dev["window_s"] = traced.trace.window_s
        out["breakdown"] = tracing.breakdown(traced.trace)
        out["traced_examples_per_s"] = traced.examples / \
            traced.trace.window_s
    out["table"] = table
    out["checks"] = {k: {"value": nums[k], "limit": limits[k]}
                     for k in compare.NUMBERS}
    return out
