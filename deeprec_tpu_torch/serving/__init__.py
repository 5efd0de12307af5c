"""Serving: the checkpoint-backed Predictor, its tiered variant and the
HTTP front end."""
from .predictor import Predictor, TieredPredictor

__all__ = ["Predictor", "TieredPredictor"]
