"""HTTP model server over a :class:`~deeprec_tpu_torch.serving.Predictor`.

A copy of ``deeprec_tpu/serving/server.py:51-329`` (``batch_from_json``,
``DynamicBatcher``, ``PredictService``, ``make_server``) over the port's
predictor: a small stdlib HTTP front end with TF-Serving-style JSON.

  POST /v1/predict    {"instances": [{col: value, ...}, ...]}
                      or {"inputs": {col: [values...], ...}}
                      -> {"predictions": [p, ...], "step": N}
  GET  /healthz       -> {"status": "ok", "step": N,
                          "tables": {name: device_rows}}
  POST /refresh       -> {"changed": bool, "step": N}  (pick up new saves)

One lock serializes predict and refresh: a serving-state swap must not
interleave with a half-run batch. Requests run at their own batch size
(the JAX server pads to powers of two only to bound XLA recompiles; torch
has none). ``dynamic_batch_ms > 0`` coalesces concurrent requests with the
same column signature into one predict call, and each caller receives
exactly its own rows.

The command line (``serving/server.py:332-385`` of the JAX package)::

    python -m deeprec_tpu_torch.serving.server --model DLRM \
        --ckpt_dir DIR [--port 8500] [--device_row_budget N] [-- ...]

``--model`` names a ``deeprec_tpu_torch.modelzoo.<M>.train`` module (or a
full module path) whose ``build(args)`` makes the model and collections;
the remaining arguments go to the trainer CLI's parser (the model's
widths: ``--emb_dim``, ``--bf16``, ...; ``--device cpu`` serves on the
CPU). :func:`build_server` returns the server unstarted (port 0 picks a
free port); :func:`main` serves forever.

``--mesh N`` serves a save row-sharded over N ranks, one process each
(``torchrun --nproc_per_node N``, or the trainer CLI's ``--coordinator``
and ``--process_id`` after ``--``): every rank restores its shard into a
``ShardedPredictor``. Rank 0 serves HTTP; for each request that passes
its checks it broadcasts the batch (:class:`MeshPredictor`) and every
rank runs ``predict`` together, rank 0 answering; ``/refresh`` applies
rank 0's listing of the saves on every rank. The other ranks follow in
:class:`RankLoop` until rank 0's server shuts down, which tells them to
stop. A malformed request is rejected on rank 0 before anything is
broadcast, so no rank waits for a collective that never comes.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np


def _as_column(name: str, values) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype == object:
        raise ValueError(
            f"column {name!r}: ragged values — sequence features must be "
            "fixed-length lists (pad with -1)")
    if arr.dtype.kind in "iu":
        return arr.astype(np.int64)
    if arr.dtype.kind == "f":
        return arr.astype(np.float32)
    raise ValueError(f"column {name!r}: unsupported dtype {arr.dtype}")


def batch_from_json(payload: dict) -> Dict[str, np.ndarray]:
    """Decode a predict request body into a feature batch."""
    if "instances" in payload:
        rows = payload["instances"]
        if not rows:
            raise ValueError("empty instances")
        cols = {}
        for k in rows[0]:
            cols[k] = _as_column(k, [r[k] for r in rows])
        return cols
    if "inputs" in payload:
        cols = {k: _as_column(k, v) for k, v in payload["inputs"].items()}
        if not cols or any(len(v) == 0 for v in cols.values()):
            raise ValueError("empty inputs")
        return cols
    raise ValueError("body must contain 'instances' or 'inputs'")


class _PendingRequest:
    __slots__ = ("cols", "n", "sig", "event", "out", "err")

    def __init__(self, cols, n, sig):
        self.cols, self.n, self.sig = cols, n, sig
        self.event = threading.Event()
        self.out = None
        self.err = None


def _batch_signature(cols: Dict[str, np.ndarray]):
    """Requests are coalescible iff they share columns, dtypes and
    trailing (per-row) shapes — then axis-0 concatenation is exact."""
    return tuple(sorted((k, v.dtype.str, v.shape[1:])
                        for k, v in cols.items()))


class DynamicBatcher:
    """Triton-style dynamic batching (the reference serves through
    Triton, whose ``dynamic_batching`` coalesces concurrent requests
    into one model execution — model_config dynamic_batching semantics).

    Concurrent predict requests with the same column signature are
    concatenated and run as ONE predict call: up to ``max_batch`` rows,
    waiting at most ``max_delay_ms`` for co-arrivals. Each caller gets
    exactly its own rows back. A predict call has a fixed cost (dedup,
    probe loop, kernel launches, copies) besides its per-row cost, which
    coalescing shares. Requests issued while a batch runs accumulate for
    the next one.
    """

    def __init__(self, run, max_batch: int = 4096,
                 max_delay_ms: float = 2.0):
        self._run = run                   # batch -> probs
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self._cv = threading.Condition()
        self._pending = []
        self._stopped = False
        self.batches = 0                  # device calls issued
        threading.Thread(target=self._loop, daemon=True,
                         name="dynamic-batcher").start()

    def submit(self, cols: Dict[str, np.ndarray], n: int) -> np.ndarray:
        req = _PendingRequest(cols, n, _batch_signature(cols))
        with self._cv:
            if self._stopped:
                raise RuntimeError("batcher stopped")
            self._pending.append(req)
            self._cv.notify()
        req.event.wait()
        if req.err is not None:
            raise req.err
        return req.out

    def stop(self):
        with self._cv:
            self._stopped = True
            self._cv.notify()

    def _take_batch(self):
        """Block for the first request, then gather same-signature
        co-arrivals until max_batch rows or the delay window closes."""
        with self._cv:
            while not self._pending and not self._stopped:
                self._cv.wait()
            if self._stopped and not self._pending:
                return None
            sig = self._pending[0].sig
            deadline = time.monotonic() + self.max_delay

            def ready():
                return sum(r.n for r in self._pending
                           if r.sig == sig) >= self.max_batch
            while not ready():
                left = deadline - time.monotonic()
                if left <= 0 or self._stopped:
                    break
                self._cv.wait(timeout=left)
            taken, rest, rows = [], [], 0
            for r in self._pending:
                if r.sig == sig and rows < self.max_batch:
                    taken.append(r)
                    rows += r.n
                else:
                    rest.append(r)
            self._pending = rest
            return taken

    def _loop(self):
        while True:
            taken = self._take_batch()
            if taken is None:
                return
            try:
                cols = {k: np.concatenate([r.cols[k] for r in taken])
                        for k in taken[0].cols}
                probs = np.asarray(self._run(cols))
                self.batches += 1
                off = 0
                for r in taken:
                    r.out = probs[off:off + r.n]
                    off += r.n
            except Exception as e:  # propagate to every caller in the batch
                for r in taken:
                    r.err = e
            finally:
                for r in taken:
                    r.event.set()


class PredictService:
    """Thread-safe predict/refresh/health over one predictor.

    ``dynamic_batch_ms`` > 0 turns on request coalescing (DynamicBatcher):
    concurrent small requests share one device call instead of
    serializing on the predict lock."""

    def __init__(self, predictor, dynamic_batch_ms: float = 0.0,
                 max_batch: int = 4096):
        self.predictor = predictor
        self._lock = threading.Lock()
        self.requests = 0
        self.batcher = None
        if dynamic_batch_ms > 0:
            self.batcher = DynamicBatcher(self._run_locked,
                                          max_batch=max_batch,
                                          max_delay_ms=dynamic_batch_ms)

    def _run_locked(self, batch):
        with self._lock:
            return self.predictor.predict(batch)

    def predict(self, payload: dict):
        batch = batch_from_json(payload)
        sizes = {len(v) for v in batch.values()}
        if len(sizes) != 1:
            raise ValueError(f"column batch sizes differ: {sorted(sizes)}")
        if self.batcher is not None:
            probs = self.batcher.submit(batch, len(next(iter(batch.values()))))
            with self._lock:
                self.requests += 1
                step = self._step()
            return {"predictions": np.asarray(probs).tolist(), "step": step}
        with self._lock:
            probs = self.predictor.predict(batch)
            self.requests += 1
            step = self._step()
        return {"predictions": np.asarray(probs).tolist(), "step": step}

    def refresh(self):
        with self._lock:
            changed = self.predictor.refresh()
            return {"changed": bool(changed), "step": self._step()}

    def health(self):
        with self._lock:
            out = {"status": "ok", "step": self._step(),
                   "requests": self.requests,
                   **({"device_batches": self.batcher.batches}
                      if self.batcher else {}),
                   "tables": {n: int(np.sum(np.asarray(st.index.size.cpu())))
                              for n, st in self.predictor.tables.items()}}
            return out

    def _step(self) -> Optional[int]:
        s = getattr(self.predictor, "step", None)
        return int(s) if s is not None else None


class _Handler(BaseHTTPRequestHandler):
    service: PredictService = None  # set by make_server

    def _reply(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/healthz", "/health"):
            self._reply(200, self.service.health())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        try:
            if self.path in ("/v1/predict", "/predict"):
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                self._reply(200, self.service.predict(payload))
            elif self.path == "/refresh":
                self._reply(200, self.service.refresh())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})
        except (ValueError, KeyError) as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:  # surface, don't kill the worker thread
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    def log_message(self, *a):  # quiet by default
        pass


class MeshPredictor:
    """Rank 0's face of a ``ShardedPredictor``: each call is broadcast to
    the other ranks' :class:`RankLoop` first, then run here, so every rank
    enters the same collectives. A request is checked before the broadcast
    (each column the model reads present, one batch size)."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.tables = predictor.tables  # this rank's shard (/healthz)
        names = [c.name for c in predictor.numeric_columns]
        for coll in predictor.collections.values():
            names += [c.categorical.name for c in coll.columns]
        self._needs = names

    @property
    def step(self):
        return getattr(self.predictor, "step", None)

    def _send(self, msg):
        from ..parallel.multihost import broadcast_object
        broadcast_object(msg, self.predictor.axis)

    def predict(self, batch):
        missing = [n for n in self._needs if n not in batch]
        if missing:
            raise ValueError(f"missing columns {missing}")
        sizes = {len(v) for v in batch.values()}
        if len(sizes) != 1 or 0 in sizes:
            raise ValueError(f"column batch sizes {sorted(sizes)}")
        self._send(("predict", batch))
        return self.predictor.predict(batch)

    def refresh(self):
        self._send(("refresh", None))
        return self.predictor.refresh()

    def stop(self):
        self._send(("stop", None))


class RankLoop:
    """A rank other than 0 of a ``--mesh`` server: it runs rank 0's
    broadcast calls on its ``ShardedPredictor`` until told to stop. Its
    :meth:`serve_forever` stands where rank 0's server's does."""

    def __init__(self, predictor):
        self.predictor = predictor
        self.calls = 0

    def serve_forever(self):
        from ..parallel.multihost import broadcast_object
        while True:
            kind, batch = broadcast_object(None, self.predictor.axis)
            if kind == "stop":
                return
            self.calls += 1
            try:
                if kind == "predict":
                    self.predictor.predict(batch)
                else:
                    self.predictor.refresh()
            except Exception:  # rank 0 meets the same error and answers
                pass

    def shutdown(self):
        pass

    def server_close(self):
        pass


def make_server(predictor, host: str = "127.0.0.1", port: int = 8500,
                refresh_secs: float = 0.0, dynamic_batch_ms: float = 0.0,
                max_batch: int = 4096):
    """Build a ThreadingHTTPServer (call ``.serve_forever()``); if
    ``refresh_secs`` > 0 a daemon thread applies new checkpoint saves on
    that cadence (the reference's incremental-serving loop);
    ``dynamic_batch_ms`` > 0 coalesces concurrent requests into shared
    device calls (Triton dynamic_batching)."""
    service = PredictService(predictor, dynamic_batch_ms=dynamic_batch_ms,
                             max_batch=max_batch)
    handler = type("Handler", (_Handler,), {"service": service})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.service = service
    if isinstance(predictor, MeshPredictor):
        # the other ranks stop when rank 0's server is closed
        close = srv.server_close

        def server_close():
            close()
            with service._lock:
                predictor.stop()
        srv.server_close = server_close
    if refresh_secs > 0:
        def loop():
            while not getattr(srv, "_BaseServer__shutdown_request", False):
                time.sleep(refresh_secs)
                try:
                    service.refresh()
                except Exception:
                    pass  # transient partial save; retried next tick
        threading.Thread(target=loop, daemon=True).start()
    return srv


def build_server(argv=None):
    """The command line's server, built and not started: ``(server,
    args)``. ``Predictor`` over ``--ckpt_dir``, or ``TieredPredictor``
    with ``--device_row_budget``, on the device the trainer CLI's
    ``--device`` names (the card by default). With ``--mesh`` every rank
    calls it: rank 0 gets the HTTP server over a :class:`MeshPredictor`,
    the others a :class:`RankLoop`; closing rank 0's server
    (``server_close``) stops them."""
    import argparse
    import importlib

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", required=True,
                    help="modelzoo name (DLRM, WDL, ...) or module path")
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--refresh_secs", type=float, default=0.0)
    ap.add_argument("--dynamic_batch_ms", type=float, default=0.0,
                    help="coalesce concurrent predict requests for up to "
                         "this many ms into one device call (0 = off)")
    ap.add_argument("--max_batch", type=int, default=4096,
                    help="row cap per coalesced device call")
    ap.add_argument("--mesh", type=int, default=0,
                    help="serve row-sharded over N ranks, one process "
                         "each; rank 0 serves HTTP")
    ap.add_argument("--device_row_budget", type=int, default=0,
                    help="serve with the cold tail in host DRAM")
    args, rest = ap.parse_known_args(argv)
    if rest and rest[0] == "--":
        rest = rest[1:]
    from ..train import cli as tcli
    name = (args.model if "." in args.model
            else f"deeprec_tpu_torch.modelzoo.{args.model}.train")
    targs = tcli.base_parser("serving").parse_args(rest)
    spec = importlib.import_module(name).build(targs)

    from . import Predictor, ShardedPredictor, TieredPredictor
    if args.mesh:
        if args.device_row_budget:
            raise ValueError("--mesh with --device_row_budget: the sharded "
                             "server keeps every row on the devices")
        targs.mesh = args.mesh
        pred = ShardedPredictor(spec.model, spec.numeric_columns,
                                spec.collections, args.ckpt_dir,
                                mesh=tcli.make_mesh(targs),
                                forward=spec.forward)
        if pred.rank != 0:
            return RankLoop(pred), args
        pred = MeshPredictor(pred)
    elif args.device_row_budget:
        pred = TieredPredictor(spec.model, spec.numeric_columns,
                               spec.collections, args.ckpt_dir,
                               device_row_budget=args.device_row_budget,
                               device=targs.device, forward=spec.forward)
    else:
        pred = Predictor(spec.model, spec.numeric_columns, spec.collections,
                         args.ckpt_dir, device=targs.device,
                         forward=spec.forward)
    srv = make_server(pred, args.host, args.port, args.refresh_secs,
                      dynamic_batch_ms=args.dynamic_batch_ms,
                      max_batch=args.max_batch)
    return srv, args


def main(argv=None):
    srv, args = build_server(argv)
    if isinstance(srv, RankLoop):
        srv.serve_forever()
        return
    host, port = srv.server_address[:2]
    print(f"serving {args.model} from {args.ckpt_dir} on {host}:{port}",
          flush=True)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()


if __name__ == "__main__":
    main()
