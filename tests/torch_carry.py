"""Carry JAX-package state into the port's types, through numpy (the two
packages draw different random numbers, so parity tests start both sides
from one state). One function per state type."""
import numpy as np
import torch

from deeprec_tpu.sparse import keys as jkeys

from deeprec_tpu_torch.sparse import adaptive as tad
from deeprec_tpu_torch.sparse import embedding_var as tev
from deeprec_tpu_torch.sparse import hash_table_api as thta
from deeprec_tpu_torch.sparse import hashtable as tht
from deeprec_tpu_torch.sparse import multihash as tmh


def t(x, device="cpu"):
    return torch.from_numpy(np.array(x)).to(device)


def keys_np(jk):
    """A JAX ``Keys`` pair as int64 numpy."""
    return jkeys.to_numpy(jk)


def hash_table(jidx, device="cpu"):
    return tht.HashTable(keys=t(keys_np(jidx.stored_keys), device),
                         size=t(jidx.size, device).long(),
                         overflow=t(jidx.overflow, device).long())


def ev_state(js, device="cpu"):
    return tev.EVState(
        index=hash_table(js.index, device), values=t(js.values, device),
        freqs=t(js.freqs, device), versions=t(js.versions, device),
        create_steps=t(js.create_steps, device),
        cbf=None if js.cbf is None else t(js.cbf, device))


def multihash_state(js, device="cpu"):
    """JAX ``[size_i, d]`` sub-tables -> the port's, with the zero null row
    appended."""
    return tmh.MultiHashState(tables=tuple(
        torch.cat([t(x), torch.zeros((1, x.shape[1]))]).to(device)
        for x in js.tables))


def adaptive_state(js, device="cpu"):
    return tad.AdaptiveState(ev=ev_state(js.ev, device),
                             static=t(js.static, device))


def hash_table_state(js, device="cpu"):
    return thta.HashTableState(
        index=hash_table(js.index, device), ids=t(js.ids, device),
        next_id=t(js.next_id, device),
        cbf=None if js.cbf is None else t(js.cbf, device))


def tensible(jt, device="cpu"):
    return thta.Tensible(rows=t(jt.rows, device))


def slot_tree(jslot, device="cpu"):
    """A JAX slot tree (dicts, tuples, lists) of arrays as tensors."""
    if isinstance(jslot, dict):
        return {k: slot_tree(v, device) for k, v in jslot.items()}
    if isinstance(jslot, (tuple, list)):
        return type(jslot)(slot_tree(v, device) for v in jslot)
    return t(jslot, device)
