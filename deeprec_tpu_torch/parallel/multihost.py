"""Process groups, the mesh axis and host collectives.

Port of ``deeprec_tpu/parallel/multihost.py`` for one process per rank
on ``torch.distributed``. The JAX engine is single-controller SPMD: one
``shard_map`` over a 1-D mesh axis, its collectives named by the axis.
Here every rank is a process holding one device and one shard of every
table, and :class:`Axis` carries what the named axis did: the group, this
rank, the size, and the collectives the sharded step runs
(``all_to_all`` of ``[S, C, ...]`` buckets, ``psum``, ``pmean``,
``all_gather``, ``broadcast``). NCCL on cards, gloo on the CPU; the
backend is the caller's choice and nothing switches to another one.

Every collective must run on every rank of the group in the same order,
so a decision that can differ between ranks (grow, widen the buckets,
serve a batch again, which saves to load) goes through :func:`all_max`,
a ``psum`` or :func:`broadcast_object` first.

``globalize``, ``host_to_global``, ``stack_rowsharded``,
``addressable_blocks`` and ``np_global`` have no counterpart: they place
or read process-spanning arrays of one global view, and here each rank
keeps only its own shard (a save writes one part file per rank; a
restore routes the saved rows and keeps its own). ``local_shard_range``
is ``(rank, rank + 1)``; :func:`shard_ranges` gathers every rank's range
once, when a host-side engine forms, and refuses a layout that is not one
shard per rank in rank order (the JAX host-sharded engine assumed it).

:func:`initialize` keeps the rendezvous it joined, whether it came as an
argument, from torchrun's environment or as a file store, and
:func:`advertise_host` derives from it the address a host
socket of this process is reached at (the JAX bucket exchange read only
``COORDINATOR_ADDRESS`` and advertised 127.0.0.1 when the coordinator
came as an argument). :func:`store` is the group's c10d key-value store.

Usage on every rank of a job::

    from deeprec_tpu_torch.parallel import multihost, make_mesh
    multihost.initialize("10.0.0.1:29500", 4, rank, backend="nccl")
    axis = make_mesh(4, device=f"cuda:{local_rank}")
    tr = ShardedTrainer(..., mesh=axis)
    # every rank is handed the same global batch and keeps its slice

Under ``torchrun`` the arguments may be left out: the launcher's
``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` then apply.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

_RENDEZVOUS: Optional[str] = None  # the init method initialize() joined


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: str = "nccl",
               timeout_s: float = 300.0) -> None:
    """``torch.distributed.init_process_group`` with ``num_processes``
    ranks, this one ``process_id``, meeting at ``coordinator_address``:
    ``host:port`` (``tcp://``), or an init-method URL such as
    ``file:///shared/path``. Without a coordinator the torchrun
    environment variables apply. A no-op when a default group exists."""
    global _RENDEZVOUS
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        missing = [v for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                               "RANK") if v not in os.environ]
        if missing:
            raise RuntimeError(
                "no coordinator address given and no torchrun environment "
                f"(missing {', '.join(missing)})")
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        _RENDEZVOUS = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and "
                         "process_id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=timeout)
    _RENDEZVOUS = url


def store():
    """The default group's c10d key-value store (the rendezvous's own
    TCP or file store)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize "
                           "first")
    return dist.distributed_c10d._get_default_store()


def advertise_host(rendezvous_url: Optional[str] = None) -> str:
    """The address other ranks reach a socket of this process at: the
    local end of a route to the rendezvous host (a UDP ``connect`` sends
    nothing), 127.0.0.1 when the rendezvous is on this host or is a file
    store (one host, or a shared file system whose hosts must then be
    given a ``tcp://`` rendezvous instead)."""
    url = rendezvous_url if rendezvous_url is not None else _RENDEZVOUS
    if not url or not url.startswith("tcp://"):
        return "127.0.0.1"
    host, _, port = url[len("tcp://"):].rpartition(":")
    host = host.strip("[]")
    if host in ("localhost", "127.0.0.1", "::1", ""):
        return "127.0.0.1"
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((host, int(port or 1)))
        return s.getsockname()[0]


def local_rank() -> int:
    """This process's index among the ranks of its host (torchrun's
    ``LOCAL_RANK``, else the global rank)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


class Axis:
    """The mesh axis of one rank: a process group, this rank and the group
    size, with the collectives the sharded engine runs on it. A gloo
    group's tensors may live on the CPU or on a card (gloo copies a card's
    through host memory itself)."""

    def __init__(self, group=None, device="cuda"):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = torch.device(device)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[S, ...]`` chunks out: chunk ``j`` goes to rank ``j``, and
        chunk ``j`` of the result came from rank ``j`` (``lax.all_to_all``
        with split and concat axis 0). bfloat16 travels as its bytes
        (gloo takes neither bfloat16 nor int16), bit-exact on every
        backend."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_to_all of {tuple(x.shape)} over "
                             f"{self.size} ranks")
        bf16 = x.dtype == torch.bfloat16
        y = x.contiguous()
        if bf16:
            y = y.view(torch.uint8)

        out = torch.empty_like(y)
        dist.all_to_all_single(out, y, group=self.group)
        return out.view(torch.bfloat16) if bf16 else out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        return self.psum(x) / self.size

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along axis 0, in rank order."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0):
        """Overwrite ``tensors`` in place with rank ``src``'s values, in one
        collective per dtype."""
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        root = dist.get_global_rank(self.group, src) \
            if self.group is not None else src
        for ts in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in ts])
            dist.broadcast(flat, root, group=self.group)
            o = 0
            with torch.no_grad():
                for t in ts:
                    t.copy_(flat[o:o + t.numel()].view_as(t))
                    o += t.numel()

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)


def make_mesh(num_devices: Optional[int] = None, axis: str = "dp",
              group=None, device="cuda") -> Axis:
    """The :class:`Axis` over ``group`` (the default group when None),
    this rank on ``device``. ``num_devices``, when given, must equal the
    group's size; ``axis`` names it, as the JAX mesh axis does."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "multihost.initialize first")
    ax = Axis(group, device)
    if num_devices and num_devices != ax.size:
        raise ValueError(f"a mesh of {num_devices} needs {num_devices} "
                         f"ranks; the group has {ax.size}")
    ax.name = axis
    return ax


def barrier(axis: Optional[Axis] = None) -> None:
    """Cross-rank sync point (a save's part files). No-op on one rank."""
    if axis is not None:
        axis.barrier()
    elif dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host_group_tensor(axis: Axis, x: np.ndarray) -> torch.Tensor:
    """``x`` as a tensor the group's backend takes (NCCL: on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dist.get_backend(axis.group) == "nccl":
        t = t.to(axis.device)
    return t


def all_max(value: int, axis: Axis) -> int:
    """Global max of a per-rank host integer (a collective, so every rank
    takes the same branch)."""
    if axis.size == 1:
        return int(value)
    t = _host_group_tensor(axis, np.asarray([value], np.int64))
    return int(axis.pmax(t).item())


def broadcast_object(obj, axis: Axis, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank (a collective): one
    rank decides, every rank follows."""
    if axis.size == 1:
        return obj
    box = [obj]
    root = dist.get_global_rank(axis.group, src) \
        if axis.group is not None else src
    dist.broadcast_object_list(
        box, root, group=axis.group,
        device=axis.device if dist.get_backend(axis.group) == "nccl"
        else torch.device("cpu"))
    return box[0]


def allgather_varlen(x: np.ndarray, axis: Axis, fill=-1) -> np.ndarray:
    """Concatenate per-rank host arrays of different leading sizes, in
    rank order (a collective)."""
    x = np.asarray(x)
    if axis.size == 1:
        return x
    counts = axis.all_gather(_host_group_tensor(
        axis, np.asarray([x.shape[0]], np.int64))).cpu().numpy()
    m = max(int(counts.max()), 1)
    pad = np.full((m,) + x.shape[1:], fill, x.dtype)
    pad[:x.shape[0]] = x
    g = axis.all_gather(_host_group_tensor(axis, pad)[None]).cpu().numpy()
    return np.concatenate([g[p, :counts[p]] for p in range(len(counts))])


def local_shard_range(axis: Axis):
    """``(lo, hi)`` table-shard ids this rank owns: its own, one."""
    return axis.rank, axis.rank + 1


def shard_ranges(axis: Axis) -> List[Tuple[int, int]]:
    """Every rank's :func:`local_shard_range`, in rank order (one
    collective). Raises unless rank ``q`` owns exactly shard ``q``: the
    host-side engines index peer blocks by these ranges and hold one
    shard per rank."""
    mine = np.asarray(local_shard_range(axis), np.int64)
    if axis.size == 1:
        got = [tuple(int(v) for v in mine)]
    else:
        g = axis.all_gather(_host_group_tensor(axis, mine[None])).cpu()
        got = [tuple(int(v) for v in row) for row in g.numpy()]
    want = [(q, q + 1) for q in range(axis.size)]
    if got != want:
        raise ValueError(f"shard ranges {got} over {axis.size} ranks: each "
                         "rank must own one shard, rank q shard q")
    return got


def psum_all(tensors: List[torch.Tensor], axis: Axis) -> List[torch.Tensor]:
    """Each tensor summed over the group, one ``all_reduce`` per dtype
    (the tensors flattened into one buffer); returns new tensors."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in by_dtype.values():
        flat = axis.psum(torch.cat([tensors[i].reshape(-1) for i in idx]))
        o = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[o:o + n].view_as(tensors[i])
            o += n
    return out
