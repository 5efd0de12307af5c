"""Ranks of the port's mesh engine for the parity tests, without JAX.

A test writes a job (a pickle: the coordinator address, the world size,
a task name and its arguments) and :func:`run_ranks` starts one process
per rank running this file; each joins a gloo group over the CPU, runs the
task and pickles its result. At most ``MAX_JOBS`` such jobs run at once
on the machine, whatever the number of pytest workers: :func:`run_ranks`
holds one of ``MAX_JOBS`` lock files under the system temp directory
(``fcntl``) while its ranks run, and every rank runs one thread. The spawned processes import this module and
the port only, never a test module that imports JAX (the precedent of
``torch_carry.py``). A rank that fails or hangs fails the test: the group
has its own timeout and :func:`run_ranks` kills ranks that outlive
theirs.

Run by hand: ``python tests/torch_mesh_worker.py JOB.pkl RANK``.
"""
import contextlib
import fcntl
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 90
MAX_JOBS = 2          # multi-rank jobs at once across the test workers
SLOT_WAIT_S = 900     # the longest a job waits for a slot


@contextlib.contextmanager
def job_slot():
    """One of ``MAX_JOBS`` machine-wide slots, held for the block: an
    exclusive ``flock`` on a lock file under the temp directory (released
    by the kernel if the holder dies)."""
    deadline = time.monotonic() + SLOT_WAIT_S
    while True:
        for i in range(MAX_JOBS):
            f = open(os.path.join(tempfile.gettempdir(),
                                  f"deeprec_torch_mesh_slot{i}.lock"), "a+")
            try:
                fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                f.close()
                continue
            try:
                yield i
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)
                f.close()
            return
        if time.monotonic() > deadline:
            raise TimeoutError("no multi-rank job slot came free")
        time.sleep(0.2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(task: str, args: dict, world: int, workdir: str,
              timeout: float = 120.0, addr=None, env=None):
    """Run ``task(axis, args)`` on ``world`` gloo ranks, one process each;
    returns their results in rank order. Raises with a rank's stderr when
    one fails or the ranks outlive ``timeout`` seconds. The ranks meet at
    a fresh file store unless ``addr`` names a rendezvous; ``env`` replaces
    the environment they inherit."""
    with job_slot():
        return _run_ranks(task, args, world, workdir, timeout, addr, env)


def _run_ranks(task, args, world, workdir, timeout, addr, env):
    os.makedirs(workdir, exist_ok=True)
    job = os.path.join(workdir, f"job_{task}.pkl")
    store = os.path.join(workdir, f"store_{task}")  # a fresh file store:
    if os.path.exists(store):                        # no port to race for
        os.remove(store)
    with open(job, "wb") as f:
        pickle.dump({"addr": addr or f"file://{store}", "world": world,
                     "task": task, "args": args}, f)
    penv = dict(os.environ if env is None else env, PYTHONPATH=REPO,
                OMP_NUM_THREADS="1")
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
    from deeprec_tpu_torch.parallel import ShardedTrainer, TieredShardedTrainer
    from deeprec_tpu_torch.train.tiered_trainer import TieredTrainer
    from deeprec_tpu_torch.train.trainer import Trainer
    coll, model = parts(spec)
    opt = (sopt.sparse_adagrad_fused(0.05) if spec.get("fused")
           else sopt.sparse_adagrad(0.05))
    numeric = [fc.NumericColumn(n, log_normalize=True)
               for n in spec["numeric"]]
    kw = dict(microbatches=spec.get("microbatches", 1))
    tiered = spec.get("tiered")
    if axis is None:
        return (TieredTrainer if tiered else Trainer)(
            model, numeric, {"emb": coll}, {"emb": opt}, dopt.Adagrad(0.05),
            device=device, **kw)
    return (TieredShardedTrainer if tiered else ShardedTrainer)(
        model, numeric, {"emb": coll}, {"emb": opt}, dopt.Adagrad(0.05),
        mesh=axis, bucket_slack=spec.get("bucket_slack", 2.0), **kw)


def parts(spec, package=None):
    """``(collection, model)`` of ``spec`` in ``package`` (the port's
    ``(config, feature_column, models.ctr, models.sequence)`` by default;
    the tests pass the JAX package's). ``spec["model"]``: ``dlrm``
    (default), ``dcn``, or ``din`` over item, cate and uid with two
    ``hist`` long histories sharing their rows."""
    if package is None:
        from deeprec_tpu_torch import config as cfg
        from deeprec_tpu_torch import feature_column as fc
        from deeprec_tpu_torch.host_index import HostIndexEmbeddingCollection
        from deeprec_tpu_torch.models import ctr, sequence as seq
        from deeprec_tpu_torch.parallel.host_sharded import \
            HostShardedCollection
        from deeprec_tpu_torch import feature_column_variants as fv
        from deeprec_tpu_torch.sparse.dynamicdim import DynamicDimConfig
        engines = {"host": HostIndexEmbeddingCollection,
                   "hs": HostShardedCollection,
                   "multihash": fv.MultiHashCollection,
                   "adaptive": fv.AdaptiveCollection,
                   "hashtable": fv.HashTableCollection,
                   "dyndim": fv.DynamicDimCollection,
                   "dyndim_config": DynamicDimConfig}
        jax_side = False
    else:
        cfg, fc, ctr, seq, engines = (tuple(package) + ({},))[:5]
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
    if spec.get("tiered"):
        ev["storage"] = cfg.StorageOption(
            storage_type=cfg.StorageType.HBM_DRAM,
            hbm_capacity=spec.get("hbm_capacity", 0))
    for k in ("exchange_dtype", "max_unique", "track_version", "lazy_init"):
        if spec.get(k) is not None:
            ev[k] = spec[k]
    engine = spec.get("engine", "device")
    init = cfg.Initializer("normal", scale=0.05)
    if engine in ("host", "hs"):  # one resolver group: the C++ and the
        ev["n_groups"] = 1        # Python resolvers order alike
    if engine == "multihash":
        coll = engines[engine](cols, name="emb", table_sizes=(256, 64),
                               combiner_op="add")
    elif engine == "adaptive":
        coll = engines[engine](cols, name="emb", buckets=128,
                               capacity=spec["capacity"], initializer=init,
                               counter_filter=cfg.CounterFilter(2))
    elif engine == "hashtable":
        coll = engines[engine](cols, name="emb", capacity=spec["capacity"],
                               initializer=init, admit=cfg.CBFFilter(
                                   filter_freq=2, max_element_size=1 << 12))
    elif engine == "dyndim":
        dd = engines["dyndim_config"](block_num=2, block_dim=4,
                                      freq_thresholds=(0, 20))
        coll = engines[engine](cols, name="emb", dynamic_dim=dd,
                               capacity=spec["capacity"], initializer=init)
    else:
        coll = engines.get(engine, fc.EmbeddingCollection)(
            cols, name="emb", capacity=spec["capacity"], initializer=init,
            **ev)
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


def carry_tables(state, a):
    """The JAX init's random table draws (``a['mh_tables']``: multi-hash
    sub-tables ``[size, d]``; ``a['static']``: the adaptive static table)
    in this rank's state."""
    import torch
    b = state.tables["emb"]
    if a.get("mh_tables") is not None:
        tabs = tuple(torch.cat([torch.from_numpy(x),
                                torch.zeros((1, x.shape[1]))])
                     for x in a["mh_tables"])
        b = b._replace(ev=b.ev._replace(tables=tabs))
    if a.get("static") is not None:
        b = b._replace(ev=b.ev._replace(
            static=torch.from_numpy(a["static"])))
    return state._replace(tables={"emb": b})


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
    if type(e).__name__ == "HostEVState":  # the resolver holds the keys
        return host_shard_np(_COLLS[name], b)
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


_COLLS = {}  # table name -> the running trainer's collection


def host_shard_np(coll, b):
    """A host-index shard as numpy: the resolver's keys in slot order and
    the first ``size`` rows of every store and slot leaf."""
    from deeprec_tpu_torch.utils.tree import leaves_with_paths
    n = coll._resolver.size
    e, cap1 = b.ev, b.ev.values.shape[0]
    out = {"keys": coll._resolver.export_keys(), "size": n,
           "values": e.values[:n].numpy(), "freqs": e.freqs[:n].numpy(),
           "versions": e.versions[:n].numpy(),
           "create_steps": e.create_steps[:n].numpy(),
           "slot": [(leaf[:n] if leaf.dim() and leaf.shape[0] == cap1
                     else leaf).numpy()
                    for _, leaf in leaves_with_paths(b.slot)]}
    if b.health is not None:
        out["health"] = b.health.numpy()
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
    _COLLS.update(tr.collections)
    st = carry_tables(carry(tr, tr.init(a["batches"][0]), a.get("dense")), a)
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
    coll = tr.collections["emb"]
    if a.get("arrays"):  # the save format of this rank's shard
        out = {"arrays": coll.ckpt_arrays(
            st.tables["emb"], tr.S, None, False, int(st.step),
            shard=tr.rank)}
    else:
        out = {"shard": shard_np(st)}
    out.update({"losses": losses, "caps": caps,
                "health": tr.table_health(st),
                "dense": [np.asarray(x) for x in _dense_leaves(tr, st)]})
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
    _COLLS.update(tr.collections)
    st, ok = CheckpointManager(a["ckpt"]).restore(
        tr, tr.init(a["batches"][0]))
    assert ok
    return {"shard": shard_np(st), "step": st.step,
            "dense": [np.asarray(x) for x in _dense_leaves(tr, st)]}


def tier_view(tr, st, name="emb"):
    """``(device rows, tier rows)`` of this rank as ``{key: row}``: the
    table's saved rows and its host tier's payload rows."""
    arr = tr.collections[name].ckpt_arrays(
        st.tables[name], getattr(tr, "S", 1), None, False, int(st.step),
        shard=getattr(tr, "rank", 0))
    dev = dict(zip(arr["keys"].tolist(), np.asarray(arr["values"])))
    kv = tr.tiers[name]
    tier = {}
    if kv is not None and len(kv):
        k, rows = kv.export()
        tier = dict(zip(k.tolist(), rows))
    return dev, tier


def task_tiered(axis, a):
    """``a['ops']`` on a ``TieredShardedTrainer``: ``("train", i)`` a step
    on batch i, ``("demote",)``, ``("promote", i)`` batch i's promotion
    alone, ``("save",)`` a full save to ``a['ckpt']``. Returns this rank's
    :func:`tier_view` after every op."""
    from deeprec_tpu_torch.checkpoint.saver import CheckpointManager
    tr = build(a["spec"], axis)
    bs = a["batches"]
    st = carry(tr, tr.init(bs[0]), a.get("dense"))
    views = []
    for op in a["ops"]:
        if op[0] == "train":
            st = tr.train_step(st, bs[op[1]])
        elif op[0] == "demote":
            st = tr.maybe_demote(st)
        elif op[0] == "promote":
            st = tr.promote_packed(st, tr.prepare_probe(bs[op[1]]))
        else:
            CheckpointManager(a["ckpt"]).save(tr, st, evict=False)
        views.append(tier_view(tr, st))
    return views


def task_dht(axis, a):
    """``a['ops']`` on a ``DistributedHashTable`` built from ``a['kw']``;
    each op's keys (and cotangents) are ``[S, ...]`` planes, this rank
    takes row ``rank``. Returns each op's result on this rank."""
    import torch
    from deeprec_tpu_torch.config import CBFFilter
    from deeprec_tpu_torch.optim import sparse as sopt
    from deeprec_tpu_torch.parallel import DistributedHashTable
    kw = dict(a["kw"])
    if kw.get("admit"):
        kw["admit"] = CBFFilter(**kw["admit"])
    dht = DistributedHashTable(axis, **kw)
    st = dht.init()
    opt = sopt.sparse_sgd(0.5)
    slot = dht.init_slot(opt, st)
    r = axis.rank
    out = []
    for op in a["ops"]:
        name = op[0]
        if name == "gen":
            st, ids = dht.gen_ids(st, torch.from_numpy(op[1][r]))
            out.append(ids.numpy())
        elif name == "grads":
            st, rows, valid, d = dht.lookup_and_grads(
                st, torch.from_numpy(op[1][r]), torch.from_numpy(op[2][r]))
            out.append((rows.numpy(), valid.numpy(), d.numpy()))
        elif name == "apply":
            st, slot, rows, valid = dht.apply_cotangent(
                st, opt, slot, torch.from_numpy(op[1][r]),
                torch.from_numpy(op[2][r]), op[3])
            out.append((rows.numpy(), valid.numpy(),
                        st.table.rows.numpy().copy()))
        elif name == "health":
            out.append(dht.health(st))
        elif name == "grow":
            st = dht.maybe_grow(st)
            out.append(dht.cap)
        elif name == "snapshot":
            out.append(dht.snapshot(st))
        elif name == "size":
            out.append(dht.size(st))
        elif name == "ckpt":
            out.append(dht.checkpoint_arrays(st))
        elif name == "restore":
            st = dht.restore_arrays(op[1])
            out.append((dht.size(st), dht.checkpoint_arrays(st)))
    return out


def task_import(axis, a):
    """``checkpoint.migrate.import_tables`` of the bundle ``a['prefix']``
    into this rank's shard; returns the shard's save arrays, the report
    and the capacity."""
    from deeprec_tpu_torch.checkpoint.migrate import import_tables
    tr = build(a["spec"], axis)
    st, rep = import_tables(tr, tr.init(a["batch"]), a["prefix"],
                            name_map=a["name_map"], validate=True)
    coll = tr.collections["emb"]
    return {"arrays": coll.ckpt_arrays(st.tables["emb"], tr.S, None, False,
                                       0, shard=tr.rank),
            "report": rep, "capacity": coll.config.capacity}


def task_estimator(axis, a):
    """``Estimator(mesh=axis)`` over ``a['dir']``: train ``a['train']``
    (restoring the directory's newest save first), evaluate and predict
    ``a['held']``."""
    from deeprec_tpu_torch import feature_column as fc
    from deeprec_tpu_torch.optim import dense as dopt
    from deeprec_tpu_torch.optim import sparse as sopt
    from deeprec_tpu_torch.train.estimator import Estimator
    coll, model = parts(a["spec"])
    est = Estimator(model, [fc.NumericColumn(n, log_normalize=True)
                            for n in a["spec"]["numeric"]],
                    {"emb": coll}, {"emb": sopt.sparse_adagrad_fused(0.05)},
                    dopt.Adagrad(0.05), a["dir"], mesh=axis, log_steps=2)
    out = {"train": est.train(lambda: iter(a["train"])),
           "step": est.global_step,
           "eval": est.evaluate(lambda: iter(a["held"])),
           "predict": list(est.predict(lambda: iter(a["held"])))}
    out["export"] = est.export_saved_model()
    return out


def task_serve(axis, a):
    """The server's ``--mesh``: every rank builds it from ``a['argv']``;
    rank 0 serves ``a['requests']`` (JSON bodies) over HTTP, asks for a
    refresh, then closes the server, which stops the other ranks. Returns
    rank 0's ``(status, reply)`` per request and the followers' call
    count."""
    import json
    import threading
    import urllib.error
    import urllib.request
    from deeprec_tpu_torch.serving.server import RankLoop, build_server
    srv, _ = build_server(a["argv"])
    if isinstance(srv, RankLoop):
        srv.serve_forever()
        return {"calls": srv.calls}
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    port = srv.server_address[1]
    answers = []
    try:
        for path, body in a["requests"]:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}{path}", data=body.encode(),
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    answers.append((r.status, json.loads(r.read())))
            except urllib.error.HTTPError as e:
                answers.append((e.code, json.loads(e.read())))
    finally:
        srv.shutdown()
        srv.server_close()
    return {"answers": answers}


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


def task_ranges(axis, a):
    """A host-sharded trainer forms on ``axis``; with ``a['swap']`` every
    rank reports the other's shard range. Returns the ranges the engine
    checked, or the error it raised."""
    from deeprec_tpu_torch.parallel import multihost
    if a["swap"]:
        multihost.local_shard_range = lambda ax: (1 - ax.rank, 2 - ax.rank)
    spec = dict(cols=[("C1", 1, "sum")], dim=4, capacity=64,
                numeric=["I1"], engine="hs")
    try:
        tr = build(spec, axis)
    except ValueError as e:
        return {"error": str(e)}
    return {"ranges": tr.collections["emb"]._ranges}


def task_exchange(axis, a):
    """Three steps of the host exchange alone (soft deadline 1.5 s; rank
    ``a['delay_rank']`` starts its second step 4 s late). Returns the
    frames each peer sent, the late steps and the advertised address."""
    from deeprec_tpu_torch.parallel.host_exchange import HostBucketExchange
    r, S = axis.rank, axis.size
    assert "MASTER_ADDR" not in os.environ
    hx = HostBucketExchange(axis, "test", deadline_ms=1500.0)
    got = {q: [] for q in range(S) if q != r}
    for i in range(3):
        if i == 1 and r == a["delay_rank"]:
            time.sleep(4.0)
        out = hx.all_to_all([f"{r}->{q} step {i}".encode()
                             for q in range(S)])
        for q in got:
            got[q].append(out[q])
    hx.close()
    return {"advertised": hx.address, "got": got, "late": hx.late_steps}


TASKS = {"train": task_train, "restore": task_restore,
         "predict": task_predict, "collectives": task_collectives,
         "ranges": task_ranges, "exchange": task_exchange,
         "tiered": task_tiered, "dht": task_dht, "import": task_import,
         "estimator": task_estimator, "serve": task_serve}


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
