"""Ranks of the port's mesh engine for the parity tests, without JAX.

A test writes a job (a pickle: the coordinator address, the world size,
a task name and its arguments) and :func:`run_ranks` starts one process
per rank running this file; each joins a gloo group over the CPU, runs the
task and pickles its result. The spawned processes import this module and
the port only, never a test module that imports JAX (the precedent of
``torch_carry.py``). A rank that fails or hangs fails the test: the group
has its own timeout and :func:`run_ranks` kills ranks that outlive
theirs.

Run by hand: ``python tests/torch_mesh_worker.py JOB.pkl RANK``.
"""
import os
import pickle
import shutil
import socket
import subprocess
import sys
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 90


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(task: str, args: dict, world: int, workdir: str,
              timeout: float = 120.0):
    """Run ``task(axis, args)`` on ``world`` gloo ranks, one process each;
    returns their results in rank order. Raises with a rank's stderr when
    one fails or the ranks outlive ``timeout`` seconds."""
    os.makedirs(workdir, exist_ok=True)
    job = os.path.join(workdir, f"job_{task}.pkl")
    store = os.path.join(workdir, f"store_{task}")  # a fresh file store:
    if os.path.exists(store):                        # no port to race for
        os.remove(store)
    with open(job, "wb") as f:
        pickle.dump({"addr": f"file://{store}", "world": world,
                     "task": task, "args": args}, f)
    penv = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        err = open(os.path.join(workdir, f"rank{r}.err"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), job, str(r)],
            cwd=REPO, env=penv, stdout=err, stderr=subprocess.STDOUT), err))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for r, (p, err) in enumerate(procs):
        err.seek(0)
        log = err.read()
        err.close()
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {task} exited {p.returncode}:"
                               f"\n{log[-4000:]}")
        with open(f"{job}.out{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the port's side ---------------------------------------------------------

def build(spec, axis=None, device="cpu"):
    """The port's trainer of ``spec`` (the tests build the JAX twin from
    the same spec): a ``ShardedTrainer`` on ``axis``, or a one-device
    ``Trainer`` when ``axis`` is None."""
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch.optim import dense as dopt
    from deeprec_tpu_torch.optim import sparse as sopt
    from deeprec_tpu_torch.parallel import ShardedTrainer
    from deeprec_tpu_torch.train.trainer import Trainer
    coll, model = parts(spec)
    opt = (sopt.sparse_adagrad_fused(0.05) if spec.get("fused")
           else sopt.sparse_adagrad(0.05))
    numeric = [fc.NumericColumn(n, log_normalize=True)
               for n in spec["numeric"]]
    kw = dict(microbatches=spec.get("microbatches", 1))
    if axis is None:
        return Trainer(model, numeric, {"emb": coll}, {"emb": opt},
                       dopt.Adagrad(0.05), device=device, **kw)
    return ShardedTrainer(model, numeric, {"emb": coll}, {"emb": opt},
                          dopt.Adagrad(0.05), mesh=axis,
                          bucket_slack=spec.get("bucket_slack", 2.0), **kw)


def parts(spec, package=None):
    """``(collection, model)`` of ``spec`` in ``package`` (the port's
    ``(config, feature_column, models.ctr, models.sequence)`` by default;
    the tests pass the JAX package's). ``spec["model"]``: ``dlrm``
    (default), ``dcn``, or ``din`` over item, cate and uid with two
    ``hist`` long histories sharing their rows."""
    if package is None:
        from deeprec_tpu_torch import config as cfg
        from deeprec_tpu_torch import feature_column as fc
        from deeprec_tpu_torch.models import ctr, sequence as seq
        jax_side = False
    else:
        cfg, fc, ctr, seq = package
        jax_side = True
    dim, kind = spec["dim"], spec.get("model", "dlrm")
    cat = fc.CategoricalColumn
    if kind == "din":
        h = spec["hist"]
        cols = [fc.EmbeddingColumn(cat("item", shared_embedding="items"), dim),
                fc.EmbeddingColumn(cat("cate", shared_embedding="cates"), dim),
                fc.EmbeddingColumn(cat("uid"), dim),
                fc.SequenceEmbeddingColumn(cat(
                    "hist_item", max_length=h, shared_embedding="items"), dim),
                fc.SequenceEmbeddingColumn(cat(
                    "hist_cate", max_length=h, shared_embedding="cates"), dim)]
    else:
        cols = [fc.EmbeddingColumn(cat(n, max_length=w), dim, combiner=c)
                for n, w, c in spec["cols"]]
    ev = {}
    if spec.get("fused"):
        ev.update(fused_slot_columns=dim, fused_slot_init=0.1)
    if spec.get("filter_freq"):
        ev["counter_filter"] = cfg.CounterFilter(
            filter_freq=spec["filter_freq"])
    if spec.get("cbf"):
        ev["cbf_filter"] = cfg.CBFFilter(filter_freq=2)
    if spec.get("evict_steps"):
        ev["evict"] = cfg.GlobalStepEvict(steps_to_live=spec["evict_steps"])
    for k in ("exchange_dtype", "max_unique", "track_version", "lazy_init"):
        if spec.get(k) is not None:
            ev[k] = spec[k]
    coll = fc.EmbeddingCollection(
        cols, name="emb", capacity=spec["capacity"],
        initializer=cfg.Initializer("normal", scale=0.05), **ev)
    if kind == "din":
        kw = dict(candidate_name="item", seq_name="hist_item",
                  candidate_context_names=["cate"],
                  seq_context_names=["hist_cate"], context_names=["uid"],
                  hidden_units=(16, 8), att_units=(8, 4))
        return coll, (seq.DIN(**kw) if jax_side
                      else seq.DIN(emb_dim=dim, **kw))
    names = [n for n, _, _ in spec["cols"]]
    n_dense = len(spec["numeric"])
    if kind == "dlrm":
        units = dict(bottom_units=(16,), top_units=(32, 16))
        model = (ctr.DLRM(emb_names=names, emb_dim=dim, **units) if jax_side
                 else ctr.DLRM(names, dim, dense_dim=n_dense, **units))
    else:
        model = (ctr.DCN(emb_names=names, cross_layers=1, deep_units=(16,))
                 if jax_side else
                 ctr.DCN(names, dim, dense_dim=n_dense, cross_layers=1,
                         deep_units=(16,)))
    return coll, model


def carry(tr, state, dense):
    """Load the JAX init's parameters and dense optimizer leaves."""
    if dense is None:
        return state
    from deeprec_tpu_torch.models import ctr
    params, opt = dense
    ctr.load_flax_params(tr.model, params)
    return state._replace(opt_state=tr.dense_optimizer.load_flax_state(
        tr.model, opt))


def shard_np(state, name="emb"):
    """This rank's table state as numpy."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths
    b = state.tables[name]
    e = b.ev
    out = {"keys": e.index.keys.numpy(), "values": e.values.numpy(),
           "freqs": e.freqs.numpy(), "versions": e.versions.numpy(),
           "create_steps": e.create_steps.numpy(),
           "size": int(e.index.size.sum()),
           "overflow": int(e.index.overflow.sum()),
           "slot": [leaf.numpy() for _, leaf in leaves_with_paths(b.slot)]}
    if b.health is not None:
        out["health"] = b.health.numpy()
    if e.cbf is not None:
        out["cbf"] = e.cbf.numpy()
    return out


def step_loss(st, b, fn):
    """``fn(st)``'s state and the per-example loss it added."""
    n = len(b["label"])
    l0 = float(st.metrics.loss_sum)
    st = fn(st)
    return st, (float(st.metrics.loss_sum) - l0) / n


def task_train(axis, a):
    """Train ``a['batches']`` from the carried weights; ``a['grow']`` runs
    ``maybe_grow`` after each step, ``a['saves']`` maps a step index to a
    save kind written to ``a['ckpt']`` after that step. Returns the
    per-step losses, this rank's shard, the health and the dense
    leaves."""
    from deeprec_tpu_torch.checkpoint.saver import (CheckpointManager,
                                                    _dense_leaves)
    from deeprec_tpu_torch.train import metrics
    tr = build(a["spec"], axis)
    st = carry(tr, tr.init(a["batches"][0]), a.get("dense"))
    mgr = CheckpointManager(a["ckpt"]) if a.get("ckpt") else None
    losses, caps = [], []
    for i, b in enumerate(a["batches"]):
        st, loss = step_loss(st, b, lambda s: tr.train_step(s, b))
        losses.append(loss)
        if a.get("grow"):
            st = tr.maybe_grow(st)
            caps.append(tr.collections["emb"].config.capacity)
        kind = a.get("saves", {}).get(i)
        if kind == "full":
            mgr.save(tr, st)
        elif kind == "incr":
            mgr.save_incremental(tr, st)
    out = {"losses": losses, "caps": caps, "shard": shard_np(st),
           "health": tr.table_health(st),
           "dense": [np.asarray(x) for x in _dense_leaves(tr, st)]}
    if a.get("eval"):
        m = tr.eval_step(st, metrics.create(device="cpu"), a["eval"])
        out["eval"] = metrics.summarize(m)
    return out


def task_restore(axis, a):
    """Restore ``a['ckpt']`` into a fresh ``ShardedTrainer`` on ``axis``;
    returns the shard and the dense leaves."""
    from deeprec_tpu_torch.checkpoint.saver import (CheckpointManager,
                                                    _dense_leaves)
    tr = build(a["spec"], axis)
    st, ok = CheckpointManager(a["ckpt"]).restore(
        tr, tr.init(a["batches"][0]))
    assert ok
    return {"shard": shard_np(st), "step": st.step,
            "dense": [np.asarray(x) for x in _dense_leaves(tr, st)]}


def task_predict(axis, a):
    """A ``ShardedPredictor`` over ``a['ckpt']`` serves ``a['batches']``;
    then ``a['then']`` (a save directory) is copied in by rank 0, every
    rank calls ``refresh()`` and serves them again. With ``a['lag']`` the
    other ranks serve from a copy of the directory that never receives
    ``a['then']``: ranks that list the directory at different moments."""
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch.checkpoint import format as F
    from deeprec_tpu_torch.serving import ShardedPredictor
    coll, model = parts(a["spec"])
    numeric = [fc.NumericColumn(n, log_normalize=True)
               for n in a["spec"]["numeric"]]
    ckpt = a["ckpt"]
    if a.get("lag") and axis.rank > 0:
        ckpt = shutil.copytree(ckpt, f"{ckpt}.rank{axis.rank}")
    pred = ShardedPredictor(model, numeric, {"emb": coll}, ckpt,
                            mesh=axis, device="cpu",
                            bucket_slack=a.get("bucket_slack", 2.0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = {"before": [pred.predict(b) for b in a["batches"]]}
    if a.get("then"):
        if axis.rank == 0:
            shutil.copytree(a["then"], os.path.join(
                a["ckpt"], os.path.basename(a["then"])))
        axis.barrier()
        out["refreshed"] = pred.refresh()
        out["after"] = [pred.predict(b) for b in a["batches"]]
        out["listed"] = [m["step"] for m in F.list_saves(ckpt)]
    out["slack"] = pred.bucket_slack
    out["warnings"] = [str(w.message) for w in caught]
    return out


def task_collectives(axis, a):
    """``multihost``'s host collectives and the axis's ``all_to_all``
    (int64, float32 and the bf16 bytes) on this rank's values."""
    import torch
    from deeprec_tpu_torch.parallel import multihost
    r, S = axis.rank, axis.size
    x = torch.arange(S * 3, dtype=torch.int64).view(S, 3) + 100 * r
    rows = torch.randn((S, 2, 4), generator=torch.Generator().manual_seed(r))
    return {
        "rank": r, "range": multihost.local_shard_range(axis),
        "max": multihost.all_max(7 * r + 1, axis),
        "varlen": multihost.allgather_varlen(
            np.full((r + 1, 2), r, np.int64), axis),
        "a2a": axis.all_to_all(x).numpy(), "rows": rows.numpy(),
        "rows_back": axis.all_to_all(rows).numpy(),
        "bf16_back": axis.all_to_all(rows.bfloat16()).float().numpy(),
        "psum": [t.numpy() for t in multihost.psum_all(
            [torch.full((2,), float(r)), torch.tensor([r])], axis)],
        "gather": axis.all_gather(torch.tensor([r, -r])).numpy()}


TASKS = {"train": task_train, "restore": task_restore,
         "predict": task_predict, "collectives": task_collectives}


def main(job_path: str, rank: int) -> None:
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from deeprec_tpu_torch.parallel import make_mesh, multihost
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    multihost.initialize(job["addr"], job["world"], rank, backend="gloo",
                         timeout_s=GROUP_TIMEOUT_S)
    try:
        out = TASKS[job["task"]](make_mesh(job["world"], device="cpu"),
                                 job["args"])
        with open(f"{job_path}.out{rank}", "wb") as f:
            pickle.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
