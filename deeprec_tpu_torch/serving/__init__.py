"""Serving: the checkpoint-backed Predictor, its tiered and row-sharded
variants and the HTTP front end (``make_server``, imported lazily so the predictors stay
importable without the server)."""
from .predictor import Predictor, ShardedPredictor, TieredPredictor


def make_server(predictor, host="127.0.0.1", port=8500, refresh_secs=0.0):
    """HTTP front end over a predictor: see
    :mod:`deeprec_tpu_torch.serving.server`."""
    from .server import make_server as _mk
    return _mk(predictor, host=host, port=port, refresh_secs=refresh_secs)


__all__ = ["Predictor", "ShardedPredictor", "TieredPredictor",
           "make_server"]
