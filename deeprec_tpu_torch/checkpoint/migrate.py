"""Import DeepRec (TensorBundle) checkpoints into the port.

Port of ``deeprec_tpu/checkpoint/migrate.py``. A DeepRec user's trained
checkpoint holds EV quads (``name-keys/-values/-versions/-freqs``),
per-partition EVs (``name/part_k``), optimizer slot EVs under the
optimizer's scope name (``name/Adagrad``, ``name/Adam`` + ``name/Adam_1``,
...) and dense variables. This module reads them with :mod:`.bundle_reader`
and loads them into live trainer state:

* :func:`scan` catalogues a bundle: EV groups (partitions merged, slots
  attached) and dense tensors.
* :func:`load_ev_arrays` materialises one EV group in the table-array
  schema (keys/values/versions/freqs and slot rows re-aligned to the
  primary's key order).
* :func:`import_tables` inserts the rows into a ``Trainer`` state, or
  into this rank's shard of a ``parallel.ShardedTrainer`` state (the rows
  the owner hash routes here, ``saver.route_to_shards``; every rank takes
  ``ceil(n / S) + 8`` rows' capacity), growing capacity as needed, through
  the saver's training restore (``saver._scatter_train_table``) on the
  table's device.
* :func:`import_dense` copies dense tensors into a model's parameters by
  the JAX tree-path names of its flax variables (``models.ctr``'s carry),
  kernels transposed from ``[in, out]`` to torch's ``[out, in]``.
* ``python -m deeprec_tpu_torch.checkpoint.migrate --prefix P --out D``
  converts a bundle offline to npz table files and a JSON report, the
  same files as the JAX package's.

``scan``, ``load_ev_arrays``, the slot tables and the offline CLI are the
JAX package's numpy code, held to their source by
``tests/test_torch_migrate.py``.

Semantics notes (as in the JAX package):
* ``create_steps``: the reference does not checkpoint creation steps;
  imported rows get ``create_step = version`` (their last trained step).
* AdagradDecay's ``last_period`` starts at ``version // decay_step``
  (``adagrad_decay_step``), so the first update after the import applies
  no catch-up decay.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .bundle_reader import BundleReader, DT_STRING

_PART_RE = re.compile(r"^(.*)/part_(\d+)$")

# Reference optimizer slot-EV suffix order -> our slot dict keys, per our
# optimizer kind (SparseOptimizer.name). TF names slot variables
# ``<var>/<OptimizerName>`` and uniquifies repeats with ``_1``/``_2`` in
# slot-creation order (slot_creator.py via Optimizer._zeros_slot):
#   Adagrad        -> accumulator
#   AdagradDecay   -> accumulator, accumulator_decay_power
#   Adam/AdamAsync -> m, v (adam_async.py:124-125)
#   Ftrl           -> accum, linear
#   Momentum       -> momentum
_SLOT_ORDER: Dict[str, List[Tuple[str, Optional[str]]]] = {
    "sgd": [],
    "adagrad": [("Adagrad", "acc")],
    "adagrad_decay": [("AdagradDecay", "acc"), ("AdagradDecay_1", None)],
    "adam": [("Adam", "m"), ("Adam_1", "v")],
    "adam_async": [("AdamAsync", "m"), ("AdamAsync_1", "v"),
                   ("Adam", "m"), ("Adam_1", "v")],
    "ftrl": [("Ftrl", "accum"), ("Ftrl_1", "linear")],
    "momentum": [("Momentum", "mom")],
    "proximal_gd": [],
    "proximal_adagrad": [("ProximalAdagrad", "acc")],
}
# any suffix that can ever be a slot EV (for scan-time detachment)
_KNOWN_SLOT_SUFFIXES = {s for pairs in _SLOT_ORDER.values()
                        for s, _ in pairs} | {
    "AdagradDecay_1", "AdamAsync_2", "AdamAsync_3", "RMSProp", "RMSProp_1"}


@dataclasses.dataclass
class EVGroup:
    """One logical EmbeddingVariable: its partitions and slot EVs."""
    base: str
    parts: List[str]                     # full bundle names, part order
    dim: int
    rows: int
    slots: Dict[str, "EVGroup"] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BundleCatalog:
    evs: Dict[str, EVGroup]
    dense: Dict[str, Tuple[str, Tuple[int, ...]]]   # name -> (dtype, shape)
    skipped: List[str]                              # e.g. string tensors


def scan(reader: BundleReader) -> BundleCatalog:
    """Catalogue a bundle: EV quads grouped by logical name with partitions
    merged and optimizer-slot EVs attached to their primary."""
    names = set(reader.keys())
    ev_full = sorted(n[:-len("-keys")] for n in names
                     if n.endswith("-keys") and n[:-len("-keys")] + "-values"
                     in names)
    quad_members = set()
    for full in ev_full:
        for suf in ("-keys", "-values", "-versions", "-freqs"):
            quad_members.add(full + suf)

    # group partitions under the logical base name
    groups: Dict[str, EVGroup] = {}
    for full in ev_full:
        m = _PART_RE.match(full)
        base, idx = (m.group(1), int(m.group(2))) if m else (full, 0)
        g = groups.setdefault(base, EVGroup(base, [], 0, 0))
        g.parts.append((idx, full))  # type: ignore[arg-type]
    for g in groups.values():
        g.parts = [full for _idx, full in sorted(g.parts)]
        for full in g.parts:
            vshape = reader.shape(full + "-values")
            g.rows += vshape[0] if vshape else 0
            g.dim = vshape[1] if len(vshape) > 1 else 1

    # detach slot EVs: "<primary>/<KnownSuffix>" where the primary exists
    slots_of: Dict[str, Dict[str, EVGroup]] = {}
    for base in list(groups):
        head, _, suffix = base.rpartition("/")
        if head in groups and suffix in _KNOWN_SLOT_SUFFIXES:
            slots_of.setdefault(head, {})[suffix] = groups.pop(base)
    for head, slots in slots_of.items():
        groups[head].slots = slots

    dense, skipped = {}, []
    for name in sorted(names - quad_members):
        entry = reader.entry(name)
        if entry.dtype_code == DT_STRING:
            skipped.append(name)
        else:
            dense[name] = (str(reader.dtype(name)), reader.shape(name))
    return BundleCatalog(evs=groups, dense=dense, skipped=skipped)


def _aligned_rows(primary_keys: np.ndarray, slot_keys: np.ndarray,
                  slot_rows: np.ndarray, fill: float) -> np.ndarray:
    """Reorder a slot EV's rows to the primary EV's key order (each EV dumps
    its rows in its own hash-map order). Keys absent from the slot EV get
    ``fill`` (the slot's initial value — same as a fresh slot row)."""
    out_shape = (primary_keys.shape[0],) + slot_rows.shape[1:]
    out = np.full(out_shape, fill, slot_rows.dtype)
    if slot_keys.size == 0:
        return out
    order = np.argsort(slot_keys, kind="stable")
    sorted_keys = slot_keys[order]
    pos = np.searchsorted(sorted_keys, primary_keys)
    pos_c = np.minimum(pos, sorted_keys.shape[0] - 1)
    hit = sorted_keys[pos_c] == primary_keys
    out[hit] = slot_rows[order[pos_c[hit]]]
    return out


def _read_group_rows(reader: BundleReader, g: EVGroup,
                     validate: bool) -> Dict[str, np.ndarray]:
    keys, values, versions, freqs = [], [], [], []
    for full in g.parts:
        keys.append(reader.get_tensor(full + "-keys", validate))
        values.append(reader.get_tensor(full + "-values", validate))
        versions.append(reader.get_tensor(full + "-versions", validate))
        freqs.append(reader.get_tensor(full + "-freqs", validate))
    out = {
        "keys": np.concatenate(keys).astype(np.int64),
        "values": np.concatenate(values),
        "versions": np.concatenate(versions).astype(np.int64),
        "freqs": np.concatenate(freqs).astype(np.int64),
    }
    n = out["keys"].shape[0]
    for name in ("values", "versions", "freqs"):
        if out[name].shape[0] != n:
            raise ValueError(
                f"EV {g.base!r}: -{name} rows ({out[name].shape[0]}) != "
                f"-keys rows ({n}) — corrupt or non-EV quad")
    return out


def load_ev_arrays(
    reader: BundleReader,
    group: EVGroup,
    slot_map: Optional[List[Tuple[str, str]]] = None,
    slot_fills: Optional[Dict[str, float]] = None,
    validate: bool = False,
) -> Dict[str, np.ndarray]:
    """One EV group -> our table-array schema. ``slot_map`` is a list of
    (reference_suffix, our_slot_key); matched slots come back under
    ``slotrows__<our_slot_key>`` aligned with ``keys``."""
    arrays = _read_group_rows(reader, group, validate)
    arrays["create_steps"] = arrays["versions"].copy()  # see module doc
    for suffix, ours in (slot_map or []):
        if ours is None or suffix not in group.slots:
            continue
        sg = group.slots[suffix]
        srows = _read_group_rows(reader, sg, validate)
        fill = float((slot_fills or {}).get(ours, 0.0))
        arrays[f"slotrows__{ours}"] = _aligned_rows(
            arrays["keys"], srows["keys"], srows["values"], fill)
    return arrays


# ---------------------------------------------------------------------------
# live import into trainer state


def _leaf_name_for_key(slot_state, key: str) -> Optional[str]:
    """Rendered leaf name (as used in our npz ``slot__<name>`` fields) for a
    top-level dict key of the slot pytree."""
    from . import format as F
    for name, _leaf in F.slot_leaf_names(slot_state):
        if name == f"['{key}']":
            return name
    return None


def import_tables(
    trainer,
    state,
    prefix: str,
    name_map: Optional[Dict[str, str]] = None,
    validate: bool = False,
    adagrad_decay_step: int = 10000,
) -> Tuple[Any, Dict[str, Any]]:
    """Load every matching EV from a DeepRec bundle into ``state``.

    ``name_map`` maps a collection name -> bundle EV base name, or ->
    ``{column_name: ev_base}`` (per-column EVs, re-keyed into the
    collection's salted key space by ``transform_raw_keys``); unmapped
    collections match by identical name. Returns ``(new_state, report)``:
    imported row counts, matched slots, and the collections/EVs left
    untouched. Tables that are not EV tables (host-index, multi-hash,
    adaptive, hash-table) are reported unmatched, as in the JAX package.
    Under a ``ShardedTrainer`` every rank calls it with its own state
    and keeps its shard's rows.
    """
    from . import saver as SV
    from ..sparse import embedding_var as ev

    S, rank = getattr(trainer, "S", 1), getattr(trainer, "rank", 0)
    reader = BundleReader(prefix)
    catalog = scan(reader)
    name_map = dict(name_map or {})
    report: Dict[str, Any] = {"imported": {}, "unmatched_collections": [],
                              "unmatched_evs": [], "slots": {}}

    new_tables = dict(state.tables)
    for name, coll in trainer.collections.items():
        mapping = name_map.get(name, name)
        if not isinstance(getattr(state.tables[name], "ev", None),
                          ev.EVState):
            report["unmatched_collections"].append(name)
            continue
        opt = trainer.sparse_optimizers[name]
        slot_map = _SLOT_ORDER.get(opt.name, [])
        fills = opt.fills if isinstance(opt.fills, dict) else {}
        dim = coll.config.embedding_dim

        if isinstance(mapping, str):
            wanted = [(None, mapping)]
        else:
            wanted = sorted(mapping.items())
        parts_arrays, ev_names = [], []
        for column, ref_name in wanted:
            if ref_name not in catalog.evs:
                continue
            group = catalog.evs[ref_name]
            if group.dim != dim:
                raise ValueError(
                    f"collection {name!r}: embedding_dim {dim} != bundle "
                    f"EV {ref_name!r} dim {group.dim}")
            part = load_ev_arrays(reader, group, slot_map, fills, validate)
            if column is not None:
                part["keys"] = coll.transform_raw_keys(column, part["keys"])
            parts_arrays.append(part)
            ev_names.append(ref_name)
        if not parts_arrays:
            report["unmatched_collections"].append(name)
            continue
        arrays = _concat_parts(parts_arrays, fills)
        n = arrays["keys"].shape[0]
        vcols = dim + coll.config.fused_slot_columns
        vals = np.zeros((n, vcols), np.float32)
        vals[:, :dim] = arrays["values"][:, :dim]
        if coll.config.fused_slot_columns:
            vals[:, dim:] = coll.config.fused_slot_init
            # fused-layout optimizers keep the accumulator inside the values
            # row; lift a matched plain-slot import into those columns
            for suffix, ours in slot_map:
                rk = f"slotrows__{ours}"
                if rk in arrays and ours in ("acc", "accum"):
                    w = min(arrays[rk].shape[1],
                            coll.config.fused_slot_columns)
                    vals[:, dim:dim + w] = arrays[rk][:, :w]
        arrays["values"] = vals

        # rename matched slot rows to this trainer's rendered leaf names
        slot_template = state.tables[name].slot
        matched_slots = []
        for suffix, ours in slot_map:
            rk = f"slotrows__{ours}"
            if rk not in arrays:
                continue
            rows = arrays.pop(rk)
            leaf = _leaf_name_for_key(slot_template, ours)
            if leaf is None:
                continue
            arrays[f"slot__{leaf}"] = rows
            matched_slots.append(f"{suffix}->{ours}")
        if opt.name == "adagrad_decay":
            leaf = _leaf_name_for_key(slot_template, "last_period")
            if leaf is not None:
                arrays[f"slot__{leaf}"] = (
                    arrays["versions"] // adagrad_decay_step).astype(np.int32)
        report["slots"][name] = matched_slots

        # capacity, then scatter through the shared restore machinery
        cap = SV.needed_capacity(int(np.ceil(n / S)) + 8,
                                 coll.config.capacity)
        if cap != coll.config.capacity:
            coll.config = dataclasses.replace(coll.config, capacity=cap)
        st = ev.create(coll.config, state.tables[name].ev.values.device)
        slot = opt.init(st.values)
        st, slot = SV._scatter_train_table(
            st, slot, coll.config, SV.route_to_shards(arrays, S)[rank])
        new_tables[name] = state.tables[name]._replace(ev=st, slot=slot)
        report["imported"][name] = {"evs": ev_names, "rows": int(n)}

    matched_refs = {e for v in report["imported"].values()
                    for e in v["evs"]}
    report["unmatched_evs"] = sorted(set(catalog.evs) - matched_refs)
    if hasattr(trainer, "rejit"):
        trainer.rejit()  # capacities may have grown
    return state._replace(tables=new_tables), report


def _concat_parts(parts_arrays: List[Dict[str, np.ndarray]],
                  fills: Dict[str, float]) -> Dict[str, np.ndarray]:
    """The per-column EV arrays of one collection, concatenated; a column
    whose EV has no such slot contributes fresh-slot fill rows."""
    arrays = {}
    all_keys = {k for p in parts_arrays for k in p}
    for k in sorted(all_keys):
        donor = next(p[k] for p in parts_arrays if k in p)
        fill = 0.0
        if k.startswith("slotrows__"):
            fill = float(fills.get(k[len("slotrows__"):], 0.0))
        pieces = []
        for p in parts_arrays:
            if k in p:
                pieces.append(p[k])
            else:
                n_p = p["keys"].shape[0]
                pieces.append(np.full((n_p,) + donor.shape[1:], fill,
                                      donor.dtype))
        arrays[k] = np.concatenate(pieces)
    return arrays


def import_dense(
    model,
    prefix: str,
    name_map: Dict[str, Any],
    validate: bool = False,
) -> Tuple[Any, List[str]]:
    """Copy dense bundle tensors into ``model`` (a port model with a flax
    tree, ``models.ctr``) in place, by explicit map ``{bundle_name:
    leaf_path}``. ``leaf_path`` is the rendered JAX tree path of the flax
    variable, as the JAX package's ``import_dense`` takes it on the
    trainer's params: ``"['params']['MLPTower_0']['dense_0']['kernel']"``,
    or without the leading ``['params']``. Shapes must match the flax
    variable's exactly (a kernel is ``[in, out]``); it lands transposed in
    the torch weight. Returns ``(model, missing_names)``."""
    import torch
    from ..models.ctr import _flax_params

    reader = BundleReader(prefix)
    by_path = {}
    for path, p, transposed in _flax_params(model):
        full = path if path.startswith(("['params']", "['batch_stats']")) \
            else "['params']" + path
        by_path[full] = (p, transposed)
        if full.startswith("['params']"):
            by_path[full[len("['params']"):]] = (p, transposed)
    missing = []
    for bundle_name, leaf_path in name_map.items():
        if not reader.has_tensor(bundle_name) or leaf_path not in by_path:
            missing.append(bundle_name)
            continue
        p, transposed = by_path[leaf_path]
        t = reader.get_tensor(bundle_name, validate)
        flax_shape = tuple(p.shape[::-1]) if transposed else tuple(p.shape)
        if tuple(t.shape) != flax_shape:
            raise ValueError(
                f"{bundle_name!r} shape {t.shape} != param "
                f"{leaf_path!r} shape {flax_shape}")
        src = torch.from_numpy(np.array(t))
        with torch.no_grad():
            p.copy_((src.T if transposed else src).to(p.device, p.dtype))
    return model, missing


# ---------------------------------------------------------------------------
# offline CLI


def _main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a DeepRec TensorBundle checkpoint into "
        "deeprec_tpu npz table files + a migration report.")
    ap.add_argument("--prefix", required=True,
                    help="bundle prefix (path without .index)")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--validate", action="store_true",
                    help="crc32c-validate every tensor payload")
    args = ap.parse_args(argv)

    reader = BundleReader(args.prefix)
    catalog = scan(reader)
    os.makedirs(args.out, exist_ok=True)
    report = {"evs": {}, "dense": catalog.dense, "skipped": catalog.skipped}
    for base, g in catalog.evs.items():
        # keep reference slot suffixes offline; the live importer renames
        slot_map = [(s, s) for s in g.slots]
        arrays = load_ev_arrays(reader, g, slot_map, validate=args.validate)
        fname = "table-" + base.replace("/", "__") + ".npz"
        np.savez_compressed(os.path.join(args.out, fname), **arrays)
        report["evs"][base] = {
            "file": fname, "rows": int(arrays["keys"].shape[0]),
            "dim": g.dim, "parts": len(g.parts), "slots": sorted(g.slots)}
    dense = {}
    for name in catalog.dense:
        dense[name.replace("/", "__")] = reader.get_tensor(
            name, args.validate)
    if dense:
        np.savez_compressed(os.path.join(args.out, "dense.npz"), **dense)
    with open(os.path.join(args.out, "migration_report.json"), "w") as f:
        json.dump(report, f, indent=2, default=str)
    print(json.dumps({"evs": len(report["evs"]),
                      "dense": len(catalog.dense),
                      "skipped": len(catalog.skipped),
                      "out": args.out}))
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(_main())
