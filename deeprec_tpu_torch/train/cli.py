"""Shared modelzoo trainer CLI.

Port of ``deeprec_tpu/train/cli.py``: :class:`ModelSpec`,
:func:`base_parser` (every JAX flag under its JAX name, plus ``--device``),
:func:`ev_kwargs`, :func:`collection_cls`, :func:`make_sparse_opt`,
:func:`make_dense_opt`, :func:`_check_health`, :func:`run` and the four
stream functions. Each ``deeprec_tpu_torch/modelzoo/<model>/train.py``
supplies a ``ModelSpec``; ``python -m deeprec_tpu_torch.modelzoo.DLRM.train
--host_index ...`` trains it on the card (``--device cpu``: on the CPU).

:func:`run` is the JAX CLI, both engines on one device and the
mesh engines (``--mesh N``): the
``max_unique_ratio`` dedup cap, a ``CheckpointManager``
(``--save_secs``/``--incr_save_secs``, the WorkQueue position as an aux
part, a restore at start), prefetch workers that pack numpy, and at each
fence metrics, saves, growth, health, periodic eval and, for
``hbm_dram[_ssd]`` tables, demotion; then the final save, the held-out
eval and one JSON summary line.

* **The device-index engine** (the default; ``collection_cls`` gives the
  ``EmbeddingCollection``): the JAX CLI's fused slot columns (a table
  whose optimizer is ``--optimizer adagrad`` or ``adam`` keeps the
  accumulator, or Adam's moments, in its value rows and trains with
  ``sparse_adagrad_fused`` / ``sparse_adam_fused``), ``--micro_batch``,
  and ``TieredTrainer`` when ``--ev_storage`` is not ``hbm``. The prefetch
  workers pack each batch into page-locked tensors and copy them to the
  card in the prefetcher's ``device_put`` stage, one ``non_blocking`` copy
  per array (the ``[W, B]`` id block of each collection among them), and
  for a tiered run compute the tier probes; the main loop promotes the
  probed rows, runs the step, and demotes every ``--demote_steps`` at
  fences.
* **The host-index engine** (``--host_index``): the plain ``Trainer``
  and ``HostStepPipeline`` (the resolve thread, then the copies on a side
  stream); its tables tier themselves.
* **The mesh** (``--mesh N``): one process per rank, started by
  ``torchrun --nproc_per_node N`` (its environment names the group) or by
  hand with ``--coordinator HOST:PORT --process_id R`` on each rank;
  ``parallel.ShardedTrainer`` over a process group (NCCL with ``--device
  cuda``, gloo with ``--device cpu``), each rank on ``cuda:<local rank>``
  (or the CPU) with its row shard of every table. Every rank reads the
  same stream and keeps its slice of each batch; rank 0 alone prints,
  writes summaries and the save's manifest (every rank writes its shard's
  part). ``--exchange_dtype bfloat16`` puts the exchanged rows and
  gradients on a bf16 wire. With ``--host_index`` the tables are
  ``parallel.host_sharded.HostShardedCollection``s (the host-sharded
  engine: the pipeline's resolve thread runs each step's host bucket
  exchange); with a tiered ``--ev_storage`` the trainer is
  ``parallel.tiered.TieredShardedTrainer``. As in the JAX CLI,
  ``--host_index`` on a mesh with a tiered ``--ev_storage`` or with
  ``--micro_batch > 1`` prints a note and takes the device-index
  engine.

Where it differs from the JAX CLI:

* **Fences follow the step counter.** The JAX loop tests ``done %
  log_steps == 0`` after each step, and a drain adds several steps at once,
  so fences skip (``deeprec_tpu/train/cli.py:534,550``). Here the pipeline
  is fed no further than the next multiple of ``--log_steps``, so it is
  empty there and the fence runs at exactly that step.
* **What it refuses**: ``--micro_batch > 1`` with ``--host_index`` on
  one device (the JAX package crashes there, ROADMAP C6).
* ``--device`` (default ``cuda``; the counterpart of ``JAX_PLATFORMS``)
  raises when the card is missing. ``--max_len`` sets the behaviour
  models' history length (the JAX entries fix it at 32), ``--dropout``
  BST's dropout rate. ``--seed`` seeds a ``torch.Generator``
  that draws the model's initial weights (:func:`init_params`).
* ``--profile DIR`` writes a ``torch.profiler`` trace, with the loop's
  spans and counters (``utils/spans.py``) in it. ``--jit_cache``
  parses, for command-line parity, and does nothing: it names an XLA
  compile cache.

``python -m deeprec_tpu_torch.train.cli --model M [flags]`` runs the zoo
model ``M`` (default DLRM) as ``deeprec_tpu_torch/modelzoo/M/train.py``
does.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import itertools
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence

import torch

from ..utils import spans


@dataclasses.dataclass
class ModelSpec:
    name: str
    model: object
    numeric_columns: Sequence
    collections: Dict
    sparse_optimizers: Dict          # name -> SparseOptimizer
    train_data: Callable[[argparse.Namespace], "iter"]
    eval_data: Callable[[argparse.Namespace], "iter"]
    forward: Optional[Callable] = None
    aux_loss_weight: float = 0.0


def base_parser(desc: str) -> argparse.ArgumentParser:
    """The JAX CLI's flags, names and defaults, and three of the port's
    own: ``--device``, ``--max_len`` (the behaviour models' history
    length: DIN's, DIEN's, DSSM's and BST's history columns and the
    behaviour streams; without it each entry's ``MAX_LEN``) and
    ``--dropout`` (BST's block; without it the entry's ``DROPOUT``)."""
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--eval_steps", type=int, default=20)
    p.add_argument("--eval_every", type=int, default=0,
                   help="also eval the held-out stream every N train steps "
                        "(0 = only at the end)")
    p.add_argument("--learning_rate", type=float, default=0.05)
    p.add_argument("--optimizer", default="adagrad",
                   choices=["sgd", "adagrad", "adagrad_decay",
                            "adagrad_decay_v2", "adam", "adam_async",
                            "ftrl", "momentum", "proximal_gd",
                            "proximal_adagrad"])
    p.add_argument("--emb_dim", type=int, default=16)
    p.add_argument("--capacity", type=int, default=1 << 19,
                   help="dynamic-table capacity (pow2)")
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute in the dense towers")
    p.add_argument("--micro_batch", type=int, default=1,
                   help="AutoMicroBatch count (device-index engine only: "
                        "with --host_index only 1, ROADMAP C6)")
    p.add_argument("--jit_cache", default="/tmp/deeprec_jit_cache",
                   help="accepted for command-line parity; unused (it "
                        "names an XLA compile cache)")
    p.add_argument("--prefetch_depth", type=int, default=2)
    p.add_argument("--prefetch_workers", type=int, default=2)
    p.add_argument("--mesh", type=int, default=0,
                   help="ranks of the sharded trainer (device-index "
                        "engine; one process each, under torchrun or with "
                        "--coordinator)")
    p.add_argument("--coordinator", default="",
                   help="host:port of the --mesh group's rendezvous "
                        "(default: torchrun's environment)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank with --coordinator")
    p.add_argument("--checkpoint", default="",
                   help="checkpoint directory (restores latest if present)")
    p.add_argument("--save_secs", type=float, default=None)
    p.add_argument("--incr_save_secs", type=float, default=None)
    p.add_argument("--ev_filter_freq", type=int, default=0)
    p.add_argument("--ev_evict_steps", type=int, default=0)
    p.add_argument("--exchange_dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="wire dtype of the --mesh row exchange")
    p.add_argument("--ev_storage", default="hbm",
                   choices=["hbm", "hbm_dram", "hbm_dram_ssd"],
                   help="multi-tier embedding storage")
    p.add_argument("--ev_hbm_capacity", type=int, default=0,
                   help="device-resident row budget per table (0 = "
                        "unbounded); excess LRU rows demote to the host "
                        "tier at --demote_steps cadence")
    p.add_argument("--ev_dram_budget", type=int, default=0,
                   help="hbm_dram_ssd: host-DRAM row cap before the "
                        "coldest rows spill to disk")
    p.add_argument("--ev_ssd_path", default="",
                   help="backing file for the SSD tier")
    p.add_argument("--demote_steps", type=int, default=0,
                   help="steps between host-tier demotion sweeps "
                        "(0 = every ev_evict_steps/2, else every "
                        "10*log_steps)")
    p.add_argument("--host_index", action="store_true",
                   help="host-index engine: the key->slot index lives in "
                        "the C++ HostIndexResolver, pipelined with the "
                        "device step (default: the device-index engine)")
    p.add_argument("--max_unique_ratio", type=float, default=0.25,
                   help="static dedup-width cap as a fraction of the flat "
                        "id width (0 = exact dedup)")
    p.add_argument("--data_location", default="",
                   help="Criteo-format file(s), comma-separated (the last "
                        "is the eval holdout); empty = synthetic stream")
    p.add_argument("--workqueue", default="",
                   help="WorkQueue dir for elastic file sharding")
    p.add_argument("--profile", default="",
                   help="torch.profiler trace dir (timeline analog)")
    p.add_argument("--summary_dir", default="",
                   help="JSONL summary/event dir (tf.summary analog)")
    p.add_argument("--log_steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--synthetic", action="store_true",
                   help="force the synthetic stream (default when no "
                        "--data_location)")
    p.add_argument("--synthetic_items", type=int, default=50_000,
                   help="item-vocab size of the synthetic behaviour stream")
    p.add_argument("--synthetic_users", type=int, default=10_000)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu); never "
                        "falls back")
    p.add_argument("--max_len", type=int, default=None,
                   help="history length of the behaviour models' sequence "
                        "columns and streams (default: the entry's "
                        "MAX_LEN)")
    p.add_argument("--dropout", type=float, default=None,
                   help="dropout rate of BST's transformer block, read by "
                        "BST alone (default: the entry's DROPOUT)")
    return p


def ev_kwargs(args) -> dict:
    from ..config import (CounterFilter, GlobalStepEvict, StorageOption,
                          StorageType)
    kw = {}
    if args.ev_filter_freq:
        kw["counter_filter"] = CounterFilter(args.ev_filter_freq)
    if args.ev_evict_steps:
        kw["evict"] = GlobalStepEvict(args.ev_evict_steps)
    if getattr(args, "exchange_dtype", None) not in (None, "float32"):
        kw["exchange_dtype"] = args.exchange_dtype
    if getattr(args, "incr_save_secs", None):
        # version-delta incrementals need version stamps even on tables
        # with no eviction policy (else the light layout skips them)
        kw["track_version"] = True
    if getattr(args, "ev_storage", "hbm") != "hbm":
        kw["storage"] = StorageOption(
            storage_type=StorageType(args.ev_storage),
            hbm_capacity=args.ev_hbm_capacity,
            dram_row_budget=args.ev_dram_budget,
            ssd_path=args.ev_ssd_path)
    return kw


def collection_cls(args):
    """The collection class for this run: with ``--host_index`` the
    host-index engine (``HostShardedCollection`` on a mesh), else the
    device-index ``EmbeddingCollection``. On a mesh with a tiered
    ``--ev_storage`` or ``--micro_batch > 1`` the host-sharded engine does
    not run: a note, and the device-index engine, as in the JAX CLI."""
    from ..feature_column import EmbeddingCollection
    from ..host_index import HostIndexEmbeddingCollection
    if not getattr(args, "host_index", False):
        return EmbeddingCollection
    if not getattr(args, "mesh", 0):
        return HostIndexEmbeddingCollection
    reasons = []
    if getattr(args, "ev_storage", "hbm") != "hbm":
        reasons.append(f"--mesh with --ev_storage {args.ev_storage}")
    if getattr(args, "micro_batch", 1) > 1:
        reasons.append("--mesh with --micro_batch")
    if reasons:
        print(f"NOTE: --host_index unsupported with {', '.join(reasons)}; "
              "using the device-index engine", flush=True)
        return EmbeddingCollection
    from ..parallel.host_sharded import HostShardedCollection
    return HostShardedCollection


def check_supported(args) -> None:
    """Refuse what the port does not run."""
    if getattr(args, "micro_batch", 1) > 1 and \
            getattr(args, "host_index", False) and \
            not getattr(args, "mesh", 0):
        raise NotImplementedError(
            f"--micro_batch {args.micro_batch} with --host_index: a "
            "resolved wire cannot be split into microbatches (the JAX "
            "package crashes here, ROADMAP C6); drop --host_index")


def make_sparse_opt(args):
    from ..optim import sparse as sopt
    return sopt.make(args.optimizer, learning_rate=args.learning_rate)


def make_dense_opt(args):
    from ..optim.dense import SGD, Adagrad, Adam
    lr = args.learning_rate
    table = {
        "sgd": lambda: SGD(lr),
        "momentum": lambda: SGD(lr, momentum=0.9),
        "adagrad": lambda: Adagrad(lr),
        "adagrad_decay": lambda: Adagrad(lr),
        "adam": lambda: Adam(lr),
        "adam_async": lambda: Adam(lr),
        "ftrl": lambda: Adagrad(lr),
        "adagrad_decay_v2": lambda: Adagrad(lr),
        "proximal_gd": lambda: SGD(lr),
        "proximal_adagrad": lambda: Adagrad(lr),
    }
    return table[args.optimizer]()


def init_params(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Draw ``model``'s initial weights as flax's defaults do, from a
    ``torch.Generator`` seeded with ``seed``: every ``nn.Linear`` kernel
    from ``lecun_normal`` (a normal of std ``1/sqrt(fan_in)`` truncated at
    two deviations, rescaled as flax's ``variance_scaling``), its bias
    zero; every ``nn.Embedding`` table (BST's position table) from a
    normal of std ``1/sqrt(width)``. Other parameters (Dice's ``alpha``,
    the scalar biases, LayerNorm's scale and bias) keep their init. The
    same seed gives the same weights on any device."""
    g = torch.Generator().manual_seed(int(seed))
    std_scale = 0.87962566103423978  # std of a unit normal cut at +-2
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                std = (1.0 / m.in_features) ** 0.5 / std_scale
                w = torch.empty(m.weight.shape[::-1])  # flax's [in, out]
                torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                            generator=g)
                m.weight.copy_((w * std).T)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.Embedding):
                w = torch.empty(m.weight.shape)
                torch.nn.init.normal_(w, 0.0, m.embedding_dim ** -0.5,
                                      generator=g)
                m.weight.copy_(w)
    return model


def _check_health(tr, state, writer, last: dict, say=print) -> dict:
    """Alarm on (and self-heal) the silent degradation modes: a mesh's
    exchange-bucket drops -> widen the buckets; dedup-cap saturation ->
    double max_unique; index overflow is handled by maybe_grow. On a mesh
    the health is global, so every rank takes the same remedy."""
    health = tr.table_health(state)
    for name, h in health.items():
        prev = last.get(name, {})
        if h["dropped"] > prev.get("dropped", 0):
            msg = (f"WARNING table {name}: {h['dropped']} unique ids "
                   f"dropped by exchange buckets (cumulative)")
            if hasattr(tr, "raise_bucket_slack"):
                msg += (" -> bucket_slack raised to "
                        f"{tr.raise_bucket_slack():.2f}")
            say(msg)
        if (h["max_unique"]
                and h["unique_saturated_steps"] > prev.get(
                    "unique_saturated_steps", 0)):
            coll = tr.collections[name]
            new_mu = coll.config.max_unique * 2
            coll.config = dataclasses.replace(coll.config, max_unique=new_mu)
            say(f"WARNING table {name}: dedup cap saturated "
                  f"{h['unique_saturated_steps']} step(s) "
                  f"(max n_unique {h['max_n_unique']}) "
                  f"-> max_unique raised to {new_mu}")
        if writer:
            writer.write(int(state.step), h, table=name, phase="health")
    return health


def _fuse_slot_columns(spec: ModelSpec, args) -> None:
    """The JAX CLI's fused slot storage: a device-index table trained by
    the plain ``--optimizer adagrad`` (or ``adam``) keeps the accumulator
    (Adam's m and v) in trailing columns of its value rows and trains with
    ``sparse_adagrad_fused`` (``sparse_adam_fused``): one row write per
    update. Host-index tables keep their slot leaves."""
    from ..feature_column import EmbeddingCollection
    from ..optim.sparse import sparse_adagrad_fused, sparse_adam_fused
    if args.optimizer not in ("adagrad", "adam"):
        return
    for name, coll in spec.collections.items():
        if (type(coll) is EmbeddingCollection
                and coll.config.fused_slot_columns == 0
                and spec.sparse_optimizers[name].name == args.optimizer):
            dim = coll.config.embedding_dim
            if args.optimizer == "adagrad":
                coll.config = dataclasses.replace(
                    coll.config, fused_slot_columns=dim, fused_slot_init=0.1)
                spec.sparse_optimizers[name] = sparse_adagrad_fused(
                    args.learning_rate, initial_accumulator_value=0.1)
            else:  # adam: m and v ride in the value rows
                coll.config = dataclasses.replace(
                    coll.config, fused_slot_columns=2 * dim,
                    fused_slot_init=0.0)
                spec.sparse_optimizers[name] = sparse_adam_fused(
                    args.learning_rate)


def make_mesh(args):
    """Join the ``--mesh`` group (torchrun's environment, or
    ``--coordinator`` and ``--process_id``) and return this rank's axis on
    ``--device`` (``cuda`` means ``cuda:<local rank>``)."""
    from ..parallel import multihost
    device = torch.device(args.device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if args.coordinator:
        multihost.initialize(args.coordinator, args.mesh, args.process_id,
                             backend=backend)
    else:
        multihost.initialize(backend=backend)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch sees no CUDA device")
        device = torch.device("cuda", multihost.local_rank()
                              % torch.cuda.device_count())
    return multihost.make_mesh(args.mesh, device=device)


def make_trainer(spec: ModelSpec, args, mesh=None):
    """The run's trainer on ``--device``: the dedup-width cap and the
    fused slot columns applied to the collections, a ``ShardedTrainer``
    (``TieredShardedTrainer`` for tiered tables) for ``--mesh`` (on the
    axis ``mesh``, or joining the group :func:`make_mesh` names), a
    ``TieredTrainer`` for tiered device-index tables, ``--micro_batch`` microbatches, the model's weights drawn from
    ``--seed``."""
    from ..config import StorageType
    from .tiered_trainer import TieredTrainer
    from .trainer import Trainer
    check_supported(args)
    # static dedup-width cap: the sparse path runs at unique width
    if args.max_unique_ratio > 0:
        for coll in spec.collections.values():
            if coll.config.max_unique is None:
                flat = coll.total_width * args.batch_size
                mu = max(256, int(flat * args.max_unique_ratio))
                coll.config = dataclasses.replace(coll.config, max_unique=mu)
    _fuse_slot_columns(spec, args)
    init_params(spec.model, args.seed)
    tiered = any(c.config.storage.storage_type is not StorageType.HBM
                 for c in spec.collections.values())
    if args.mesh:
        from ..parallel import ShardedTrainer, TieredShardedTrainer
        cls = TieredShardedTrainer if tiered else ShardedTrainer
        return cls(spec.model, spec.numeric_columns, spec.collections,
                   spec.sparse_optimizers, make_dense_opt(args),
                   mesh=mesh or make_mesh(args), forward=spec.forward,
                   aux_loss_weight=spec.aux_loss_weight,
                   microbatches=args.micro_batch)
    # a tiered device-index table needs the TieredTrainer; host-index
    # tables tier themselves
    device_tiered = any(c.config.storage.storage_type is not StorageType.HBM
                        and not hasattr(c, "demote_cold")
                        for c in spec.collections.values())
    cls = TieredTrainer if device_tiered else Trainer
    return cls(spec.model, spec.numeric_columns, spec.collections,
               spec.sparse_optimizers, make_dense_opt(args),
               forward=spec.forward, aux_loss_weight=spec.aux_loss_weight,
               microbatches=args.micro_batch, device=args.device)


def run(spec: ModelSpec, args) -> dict:
    """Train/eval loop shared by every modelzoo trainer. Returns (and
    prints, as the reference trainers do) the summary metrics."""
    import torch.distributed as dist
    from ..checkpoint.saver import CheckpointManager
    from ..config import StorageType
    from . import metrics as M

    owns_group = bool(args.mesh) and not dist.is_initialized()
    tr = make_trainer(spec, args)  # raises for what is not ported
    device = tr.device
    lead = getattr(tr, "rank", 0) == 0  # on a mesh rank 0 alone reports

    def say(*a):
        if lead:
            print(*a, flush=True)
    host_index = any(hasattr(c, "pack_ids_host")
                     for c in tr.collections.values())

    train_it = spec.train_data(args)
    first = next(iter(train_it))
    state = tr.init(first)

    mgr = None
    if args.checkpoint:
        mgr = CheckpointManager(args.checkpoint, full_secs=args.save_secs,
                                incr_secs=args.incr_save_secs)
        q = getattr(args, "_workqueue", None)
        if q is not None:
            # the queue position saves with every checkpoint; its restore
            # already ran at stream creation (criteo_train_stream)
            mgr.attach_aux("workqueue", q.snapshot, None)
        state, restored = mgr.restore(tr, state)
        if restored:
            say(f"restored from {args.checkpoint} at step {state.step}")

    prof = None
    if args.profile and lead:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        spans.start()
        rows0 = _index_rows(tr, state)
    writer = None
    if args.summary_dir and lead:
        from .summary import SummaryWriter
        writer = SummaryWriter(args.summary_dir)

    tiered = any(c.config.storage.storage_type is not StorageType.HBM
                 for c in spec.collections.values())
    demote_steps = 0
    if tiered:
        demote_steps = args.demote_steps or (
            args.ev_evict_steps // 2 if args.ev_evict_steps
            else 10 * args.log_steps)

    def run_eval(st):
        mstate = M.create(device=device)
        for batch in spec.eval_data(args):
            mstate = tr.eval_step(st, mstate, batch)
        return M.summarize(mstate)

    t0 = time.perf_counter()
    eval_secs = 0.0
    last_health = {}

    def fence_work(state, done):
        """Everything that happens at a fence (the host-index loop's on an
        empty pipeline: resolver == device state), after ``done`` steps of
        this run: the metrics read (a device sync),
        checkpoint timers, growth, the health watchdog, periodic eval,
        demotion."""
        nonlocal last_health, eval_secs
        step = int(state.step)
        m = M.summarize(state.metrics)
        dt = time.perf_counter() - t0
        eps = done * args.batch_size / dt
        say(f"step {step}  loss={m['loss']:.5f}  auc={m['auc']:.4f}  "
            f"({eps:.0f} ex/s)")
        if writer:
            writer.write(step, m, examples_per_sec=eps)
        if mgr is not None:
            mgr.maybe_save(tr, state)
        grown = tr.maybe_grow(state)
        if grown is not state:
            say(f"table growth at step {step}: " + ", ".join(
                f"{n}->{c.config.capacity}"
                for n, c in tr.collections.items()))
            state = grown
        last_health = _check_health(tr, state, writer, last_health, say)
        if args.eval_every and step % args.eval_every < args.log_steps \
                and step >= args.eval_every:
            te = time.perf_counter()
            em = run_eval(state)
            eval_secs += time.perf_counter() - te
            say(f"eval @ step {step}: auc={em['auc']:.4f} "
                f"acc={em['accuracy']:.4f}")
            if writer:
                writer.write(step, em, phase="eval")
        if demote_steps and (step // args.log_steps) % max(
                demote_steps // args.log_steps, 1) == 0:
            state = tr.maybe_demote(state)
            rows = {n: tr.host_tier_rows(n) for n in tr.tiers}
            if any(rows.values()):
                say("host tier rows: " + ", ".join(
                    f"{n}={c}" for n, c in rows.items()))
                if writer:
                    writer.write(step, rows, phase="tier")
        return state

    stream = itertools.islice(itertools.chain([first], train_it),
                              args.steps)
    log_steps = max(1, args.log_steps)
    if host_index:
        state, done = _host_index_loop(tr, state, stream, args, log_steps,
                                       fence_work)
    else:
        state, done = _device_index_loop(tr, state, stream, args, log_steps,
                                         fence_work)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_secs = time.perf_counter() - t0 - eval_secs

    if prof is not None:
        spans.count("rows.created", _index_rows(tr, state) - rows0)
        snap = spans.stop()
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, f"{spec.name}_trace.json")
        prof.export_chrome_trace(path)
        spans.add_to_chrome_trace(path, snap)
    if mgr is not None:
        mgr.save(tr, state)

    train_m = M.summarize(state.metrics)
    # eval on a held-out stream (read-only lookups)
    eval_m = run_eval(state)

    out = {
        "model": spec.name,
        "steps": int(state.step),
        "train_loss": round(train_m["loss"], 5),
        "train_auc": round(train_m["auc"], 5),
        "eval_auc": round(eval_m["auc"], 5),
        "eval_accuracy": round(eval_m["accuracy"], 5),
        "examples_per_sec": round(done * args.batch_size
                                  / max(train_secs, 1e-9), 1),
    }
    if writer:
        writer.write(int(state.step), eval_m, phase="eval")
        writer.close()
    say(json.dumps(out))
    if owns_group:
        dist.destroy_process_group()
    return out


def _index_rows(tr, state) -> int:
    """Keys in the device-index tables' indexes (reads the device)."""
    n = 0
    for name, coll in tr.collections.items():
        view = coll.index_view(state.tables[name].ev)
        if view is not None:
            n += int(view.index.size.sum())
    return n


def _host_index_loop(tr, state, stream, args, log_steps, fence_work):
    """The host-index loop: prefetch workers pack numpy, a
    ``HostStepPipeline`` resolves in step order and copies on a side
    stream, the main thread launches steps. The pipeline is fed no further
    than the next multiple of ``log_steps``, so it is empty when the step
    counter reaches a fence. Each batch carries the number of the step it
    feeds into the spans (``utils/spans.py``). Returns the state and the
    steps run."""
    from ..data.prefetch import staged
    from .pipeline import HostStepPipeline
    pin = tr.device.type == "cuda"

    def pack(item):
        k, batch = item
        with spans.span("pack", k):
            return k, tr.pack_np(batch)

    def finish(packed):
        """The pipeline's resolve stage: step-order index mutation into
        (pinned) host tensors; the transfer stage copies them."""
        return tr.resolve_packed(packed, train=True, pin=pin)
    done = 0
    with staged(enumerate(stream, state.step), prepare=pack,
                depth=args.prefetch_depth,
                workers=args.prefetch_workers) as pf, \
            HostStepPipeline(finish, depth=max(2, args.prefetch_depth),
                             device=tr.device) as pipe:
        pf_it = iter(pf)
        fed = state.step          # the step the last fed batch will reach
        fence = (fed // log_steps + 1) * log_steps
        exhausted = False
        while True:
            while not exhausted and len(pipe) < pipe.depth and fed < fence:
                try:
                    k, packed = next(pf_it)
                    pipe.feed(packed, batch=k)
                    fed += 1
                except StopIteration:
                    exhausted = True
            if not len(pipe):
                break
            with spans.span("loop.next_batch", state.step):
                item = pipe.take()
            state = tr._train_step(state, *item)
            done += 1
            if state.step == fence:
                with spans.span("loop.fence", state.step - 1):
                    state = fence_work(state, done)
                fence += log_steps
    return state, done


def _device_index_loop(tr, state, stream, args, log_steps, fence_work):
    """The device-index loop: prefetch workers pack each batch into
    (page-locked, on the card) host tensors and copy them to the device
    asynchronously, computing the tier probes of a ``TieredTrainer``
    beside it; the main thread promotes the probed tier rows, launches the
    step and runs the fence work at every multiple of ``log_steps``.
    Each batch carries the number of the step it feeds, from before the
    prefetcher to the step, into the spans (``utils/spans.py``). Returns
    the state and the steps run."""
    from ..data.prefetch import staged
    from .pipeline import to_device
    pin = tr.device.type == "cuda"
    tiered = hasattr(tr, "promote_packed")

    def put(host):
        return to_device(host, tr.device, non_blocking=pin)

    def prepare(item):
        k, b = item
        with spans.span("pack", k):
            host = tr.prepare_host(b, pin=pin)
            return k, (host, tr.prepare_probe(b)) if tiered else host

    def device_put(item):
        k, host = item
        with spans.span("copy", k):
            if tiered:  # the probes stay on the host
                return k, (put(host[0]), host[1])
            return k, put(host)
    done = 0
    with staged(enumerate(stream, state.step), prepare=prepare,
                depth=args.prefetch_depth, workers=args.prefetch_workers,
                device_put=device_put) as pf:
        it = iter(pf)
        while True:
            with spans.span("loop.next_batch", state.step):
                item = next(it, None)
            if item is None:
                break
            item = item[1]
            if tiered:
                item, probe = item
                state = tr.promote_packed(state, probe)
            state = tr._train_step(state, *item)
            done += 1
            if state.step % log_steps == 0:
                with spans.span("loop.fence", state.step - 1):
                    state = fence_work(state, done)
    return state, done


# -- shared data plumbing -----------------------------------------------------


def main(argv=None) -> dict:
    """``--model M`` (default DLRM) and its flags: the zoo model's run."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--model", default="DLRM")
    ns, rest = pre.parse_known_args(argv)
    mod = importlib.import_module(
        f"deeprec_tpu_torch.modelzoo.{ns.model}.train")
    parser = mod.parser() if hasattr(mod, "parser") else \
        base_parser(ns.model)
    args = parser.parse_args(rest)
    return run(mod.build(args), args)


def criteo_train_stream(args):
    from ..data.criteo import SyntheticCriteo, read_criteo
    from ..data.work_queue import WorkQueue, input_producer
    if args.data_location and not args.synthetic:
        files = args.data_location.split(",")
        if len(files) > 1:
            files = files[:-1]  # last file is the eval holdout
        if args.workqueue:
            q = WorkQueue(files, path=args.workqueue, num_epochs=1000)
            if getattr(args, "checkpoint", ""):
                # rewind the queue to the newest checkpoint's saved claim
                # state BEFORE any item is claimed: work done between that
                # save and a crash is re-served, not skipped. run() then
                # attaches the snapshot side to the manager.
                from ..checkpoint import format as F
                base, incrs = F.restore_plan(args.checkpoint)
                newest = (incrs[-1] if incrs else base) if base else None
                if newest:
                    p = os.path.join(newest["path"], "aux_workqueue.json")
                    if os.path.exists(p):
                        with open(p) as f:
                            q.restore_snapshot(json.load(f))
            args._workqueue = q
            return input_producer(q, read_criteo, batch_size=args.batch_size)

        def gen():
            while True:
                for f in files:
                    yield from read_criteo(f, args.batch_size)
        return gen()
    return SyntheticCriteo(batch_size=args.batch_size, seed=args.seed)


def criteo_eval_stream(args):
    from ..data.criteo import SyntheticCriteo, read_criteo
    if args.data_location and not args.synthetic:
        # holdout: with several files, the LAST is reserved for eval and
        # excluded from training; a single file has no holdout
        f = args.data_location.split(",")[-1]
        return itertools.islice(read_criteo(f, args.batch_size),
                                args.eval_steps)
    gen = SyntheticCriteo(batch_size=args.batch_size, seed=args.seed + 999)
    return gen.take(args.eval_steps)


def _behavior_kwargs(args) -> dict:
    """The behaviour stream's sizes; its history length only where
    ``--max_len`` is given (else the stream's own default)."""
    kw = {"n_items": args.synthetic_items, "n_users": args.synthetic_users}
    if args.max_len:
        kw["max_len"] = args.max_len
    return kw


def behavior_train_stream(args):
    from ..data.behavior import SyntheticBehavior
    return SyntheticBehavior(batch_size=args.batch_size, seed=args.seed,
                             **_behavior_kwargs(args))


def behavior_eval_stream(args):
    from ..data.behavior import SyntheticBehavior
    gen = SyntheticBehavior(batch_size=args.batch_size, seed=args.seed + 999,
                            **_behavior_kwargs(args))
    return gen.take(args.eval_steps)


if __name__ == "__main__":
    main()
