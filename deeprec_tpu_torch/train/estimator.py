"""Estimator: the train / evaluate / predict workflow over a model dir.

Port of ``deeprec_tpu/train/estimator.py``: a :class:`~.trainer.Trainer`
and a :class:`~..checkpoint.saver.CheckpointManager` behind the
``tf.estimator.Estimator`` workflow: restore the newest save at first use,
save full and incremental checkpoints on the manager's clocks, summarise
the metrics, and hand a final save to serving
(``serving.Predictor(model, ..., model_dir)``). Training runs the host
half of each batch (``Trainer.prepare_host``: packing, and a host-index
table's resolve, in step order on the one worker) in a prefetch worker
(``data.prefetch.staged``), which also copies it to the device, page-locked
and asynchronous on the card.

``mesh=`` (a ``parallel.multihost.Axis``, from ``parallel.make_mesh``)
puts a ``parallel.ShardedTrainer`` behind the same workflow, as the JAX
``Estimator(mesh=)`` does: every rank constructs the estimator and calls
each method together with the same input stream; saves go through the
multi-rank part writer (one part per rank), and ``predict`` yields the
whole batch's probabilities on every rank.
"""
from __future__ import annotations

import itertools
from typing import Callable, Optional


class Estimator:
    """train / evaluate / predict over ``model_dir``; the other arguments
    are the :class:`~.trainer.Trainer`'s (``device``: the card unless the
    caller names the CPU; on a mesh the axis's device)."""

    def __init__(self, model, numeric_columns, collections,
                 sparse_optimizers, dense_optimizer, model_dir: str,
                 forward: Optional[Callable] = None,
                 save_secs: Optional[float] = 600.0,
                 incr_save_secs: Optional[float] = None,
                 mesh=None, log_steps: int = 100, device="cuda"):
        from ..checkpoint.saver import CheckpointManager
        from .trainer import Trainer
        args = (model, numeric_columns, collections, sparse_optimizers,
                dense_optimizer)
        if mesh is not None:
            from ..parallel import ShardedTrainer
            from ..parallel.multihost import Axis
            if not isinstance(mesh, Axis):
                raise TypeError(
                    f"mesh={type(mesh).__name__}: Estimator(mesh=) takes "
                    "the parallel.multihost.Axis of parallel.make_mesh")
            self.trainer = ShardedTrainer(*args, mesh=mesh, forward=forward)
        else:
            self.trainer = Trainer(*args, forward=forward, device=device)
        self.model_dir = model_dir
        self.mgr = CheckpointManager(model_dir, full_secs=save_secs,
                                     incr_secs=incr_save_secs)
        self.log_steps = log_steps
        self._state = None

    # -- state -------------------------------------------------------------
    def _ensure_state(self, sample_batch):
        if self._state is None:
            st = self.trainer.init(sample_batch)
            self._state, _ = self.mgr.restore(self.trainer, st)
        return self._state

    @property
    def global_step(self) -> int:
        return int(self._state.step) if self._state is not None else 0

    # -- workflow ------------------------------------------------------------
    def train(self, input_fn, steps: Optional[int] = None) -> dict:
        """``input_fn() -> batch iterator``; trains ``steps`` steps (or the
        whole stream) with the manager's saves and growth every
        ``log_steps``, then a full save. Returns the summarised metrics."""
        from ..data.prefetch import staged
        from . import metrics as M
        from .pipeline import to_device
        tr = self.trainer
        pin = tr.device.type == "cuda"
        it = iter(input_fn())
        first = next(it)
        state = self._ensure_state(first)
        stream = itertools.chain([first], it)
        if steps is not None:
            stream = itertools.islice(stream, steps)
        done = 0
        with staged(stream, prepare=lambda b: tr.prepare_host(b, pin=pin),
                    device_put=lambda h: to_device(h, tr.device,
                                                   non_blocking=pin)) as pf:
            for packed in pf:
                state = tr._train_step(state, *packed)
                done += 1
                if done % self.log_steps == 0:
                    self.mgr.maybe_save(tr, state)
                    state = tr.maybe_grow(state)
        self._state = state
        self.mgr.save(tr, state)
        return M.summarize(state.metrics)

    def evaluate(self, input_fn, steps: Optional[int] = None) -> dict:
        from . import metrics as M
        it = iter(input_fn())
        if steps is not None:
            it = itertools.islice(it, steps)
        first = next(it)
        state = self._ensure_state(first)
        ms = M.create(device=self.trainer.device)
        for batch in itertools.chain([first], it):
            ms = self.trainer.eval_step(state, ms, batch)
        return M.summarize(ms)

    def predict(self, input_fn):
        """Yields ``[B]`` numpy probabilities per input batch; read-only
        (an unseen key reads its init row and is not inserted)."""
        import torch
        from ..feature_column import normalize_dense
        tr = self.trainer
        for batch in input_fn():
            state = self._ensure_state(batch)
            if hasattr(tr, "predict"):  # the mesh: every rank, whole batch
                yield tr.predict(state, batch)
                continue
            dense, cats, _ = tr.prepare_batch(batch, train=False)
            with torch.no_grad():
                if dense is not None:
                    dense = normalize_dense(tr.numeric_columns, dense)
                outputs = {}
                for name, coll in tr.collections.items():
                    aux, urows = coll.readonly_rows(state.tables[name].ev,
                                                    cats[name])
                    outputs[name] = (coll.embeddings(urows, aux),
                                     coll.sequence_embeddings(urows, aux))
                out = tr.forward(tr.model, dense, outputs, False)
                logits = out[0] if isinstance(out, tuple) else out
            yield torch.sigmoid(logits).cpu().numpy()

    def export_saved_model(self) -> str:
        """Serving handoff: a final full save; serve it with
        ``serving.Predictor(model, ..., self.model_dir)``."""
        if self._state is not None:
            self.mgr.save(self.trainer, self._state)
        return self.model_dir
