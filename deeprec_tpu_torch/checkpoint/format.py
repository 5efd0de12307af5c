"""On-disk checkpoint layout, shared with the JAX package.

A framework-free copy of ``deeprec_tpu/checkpoint/format.py:46-194``
(``list_saves``, ``restore_plan``, ``write_save`` with its multi-rank
part files, ``read_dense``, ``read_table``, ``slot_leaf_names``): the
port reads and writes the same directories as ``deeprec_tpu.checkpoint``.
One save is one directory::

    <dir>/full-0000000100/
        manifest.json          # kind/step/tables/time/parts
        dense.npz              # flattened (params, opt_state, step) leaves
        table-<name>.npz       # keys int64[n], values [n,d], versions[n],
                               # freqs[n], create_steps[n], slot rows
    <dir>/incr-0000000130/     # same shape, delta rows only

A save of ``S`` ranks holds ``table-<name>.part<k>.npz``, one per rank,
in place of ``table-<name>.npz``.

npz has no bfloat16: such arrays travel as uint16 bit patterns under a
``__bf16raw`` name suffix. Here they decode to ``torch.bfloat16`` tensors
(a view of the payload) and a ``torch.bfloat16`` tensor encodes back.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.tree import leaves_with_paths

MANIFEST = "manifest.json"
DENSE = "dense.npz"
_BF16 = "__bf16raw"


def step_dirname(kind: str, step: int) -> str:
    return f"{kind}-{step:010d}"


def list_saves(directory: str) -> List[Dict[str, Any]]:
    """All complete saves, sorted by step then kind (full first)."""
    out = []
    if not os.path.isdir(directory):
        return out
    names = set(os.listdir(directory))
    for name in names:
        if name.endswith(".tmp"):
            continue  # in-flight save directory
        if ".old." in name:
            # superseded copy, but the ONLY copy if a crash hit write_save
            # between its two renames: recover it then
            if name.split(".old.")[0] in names:
                continue
        mpath = os.path.join(directory, name, MANIFEST)
        if not os.path.isfile(mpath):
            continue
        with open(mpath) as f:
            m = json.load(f)
        m["path"] = os.path.join(directory, name)
        out.append(m)
    out.sort(key=lambda m: (m["step"], 0 if m["kind"] == "full" else 1))
    return out


def restore_plan(directory: str) -> Tuple[Optional[Dict], List[Dict]]:
    """(latest full save, incrementals after it in replay order)."""
    saves = list_saves(directory)
    fulls = [m for m in saves if m["kind"] == "full"]
    if not fulls:
        return None, []
    base = fulls[-1]
    incrs = [m for m in saves
             if m["kind"] == "incr" and m["step"] > base["step"]]
    return base, incrs


def write_save(path: str, manifest: Dict[str, Any], dense_leaves: List,
               tables: Dict[str, Dict[str, Any]],
               part: Optional[int] = None, n_parts: int = 1,
               barrier=None) -> None:
    """Write one save atomically enough: into ``<path>.tmp``, manifest
    last, then rename. A re-save of an existing step first renames the old
    directory aside; :func:`list_saves` recovers that ``.old.*`` copy if a
    crash lands between the two renames, and it is deleted once the new
    manifest is in place.

    A multi-rank save (``part``/``n_parts``/``barrier`` set): every rank
    writes its shard's rows as ``table-<name>.part<k>.npz``; after the
    ``barrier`` confirms every part is on disk, part 0 writes the dense
    leaves and the manifest and renames; a second barrier holds every rank
    until the save is in place. :func:`read_table` merges the parts."""
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    suffix = "" if part is None else f".part{part:03d}"
    for name, arrays in tables.items():
        np.savez(os.path.join(tmp, f"table-{name}{suffix}.npz"),
                 **_encode_dtypes(arrays))
    if barrier is not None:
        barrier()
    if part in (None, 0):
        np.savez(os.path.join(tmp, DENSE), **_encode_dtypes(
            {f"d{i:05d}": leaf for i, leaf in enumerate(dense_leaves)}))
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(dict(manifest, time=time.time(),
                           parts=1 if part is None else n_parts), f)
        old = None
        if os.path.isdir(path):
            old = path + f".old.{os.getpid()}"
            os.rename(path, old)
        os.rename(tmp, path)
        if old is not None and os.path.isfile(os.path.join(path, MANIFEST)):
            shutil.rmtree(old, ignore_errors=True)
    if barrier is not None:
        barrier()


def _encode_dtypes(arrays: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in arrays.items():
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                out[k + _BF16] = (v.detach().cpu().contiguous()
                                  .view(torch.int16).numpy().view(np.uint16))
                continue
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _decode_dtypes(arrays: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out = {}
    for k, v in arrays.items():
        if k.endswith(_BF16):
            out[k[: -len(_BF16)]] = torch.from_numpy(
                np.ascontiguousarray(v).view(np.int16)).view(torch.bfloat16)
        else:
            out[k] = v
    return out


def read_dense(path: str) -> List:
    with np.load(os.path.join(path, DENSE)) as z:
        d = _decode_dtypes({k: z[k] for k in z.files})
        return [d[k] for k in sorted(d)]


def slot_leaf_name(path: str) -> str:
    return path.replace("/", "_")


def slot_leaf_names(slot_state) -> List[Tuple[str, Any]]:
    """Stable (name, leaf) pairs for an optimizer slot state: the names
    the JAX package's ``slot_leaf_names`` gives the same tree."""
    return [(slot_leaf_name(path), leaf)
            for path, leaf in leaves_with_paths(slot_state)]


def read_table(path: str, name: str) -> Dict[str, Any]:
    """Read one table's arrays; multi-process part files are merged (row
    arrays concatenated, scalars taken from the first part)."""
    single = os.path.join(path, f"table-{name}.npz")
    if os.path.isfile(single):
        with np.load(single) as z:
            return _decode_dtypes({k: z[k] for k in z.files})
    parts = sorted(glob.glob(os.path.join(path, f"table-{name}.part*.npz")))
    if not parts:
        raise FileNotFoundError(single)
    merged: Dict[str, list] = {}
    scalars: Dict[str, np.ndarray] = {}
    for p in parts:
        with np.load(p) as z:
            nk = int(z["keys"].shape[0]) if "keys" in z.files else None
            for k in z.files:
                v = z[k]
                row_like = (nk is not None and v.ndim >= 1
                            and v.shape[0] == nk
                            and not k.startswith(("scalar__", "cbf")))
                if k == "keys" or row_like:
                    merged.setdefault(k, []).append(v)
                else:
                    scalars.setdefault(k, v)
    out = {k: np.concatenate(v) for k, v in merged.items()}
    out.update(scalars)
    return _decode_dtypes(out)
