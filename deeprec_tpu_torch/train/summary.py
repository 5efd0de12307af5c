"""Training summaries: an append-only JSONL event log.

A framework-free copy of ``deeprec_tpu/train/summary.py``
(``tests/test_torch_imports.py`` holds it to its source): one
``events.jsonl`` per run directory, step-stamped and append-only, so runs
restarted into the same directory merge. The CLI writes the fence
metrics, health, tier and eval records into it.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class SummaryWriter:
    def __init__(self, directory: str, name: str = "events"):
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"{name}.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, values: Dict[str, float], **extra):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "dtype") or isinstance(v, (int, float))
                        else v) for k, v in values.items()})
        rec.update(extra)
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(directory: str, name: str = "events"):
    path = os.path.join(directory, f"{name}.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
