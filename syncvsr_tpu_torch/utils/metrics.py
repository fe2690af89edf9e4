"""Metric aggregation and logging (the port's copy of
``syncvsr_tpu/utils/metrics.py``; numpy and the standard library only).

AverageMeter mirrors the reference (LRW/landmark/src/main.py:29-45: running
averages, ``use_latest`` keys like learning_rate reported as-is). The logger
writes JSONL to disk and, with ``use_wandb``, to W&B. Unlike the JAX copy,
a missing or failing ``wandb`` raises instead of turning the sink off.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, Optional

import numpy as np


class AverageMeter:
    def __init__(self, use_latest: Iterable[str] = ("learning_rate",)):
        self.buffer = defaultdict(list)
        self.use_latest = set(use_latest)

    def update(self, metrics: Dict[str, Any], weight=1.0):
        """``weight`` makes partial (padded) eval batches exact: pass the
        real sample count so tail batches don't skew the averages. A dict
        gives per-key weights (``__default__`` for the rest) — used for
        token-/slot-normalized metrics whose true denominator is not the
        sample count."""
        for k, v in metrics.items():
            if isinstance(weight, dict):
                w = weight.get(k, weight.get("__default__", 1.0))
            else:
                w = weight
            self.buffer[k].append((np.asarray(v), float(w)))

    def summary(self, prefix: str = "") -> Dict[str, float]:
        out = {}
        for k, vs in self.buffer.items():
            if k in self.use_latest:
                v = vs[-1][0]
            else:
                total_w = sum(w for _, w in vs)
                v = sum(np.mean(x) * w for x, w in vs) / max(total_w, 1e-12)
            out[f"{prefix}{k}"] = float(v)
        self.buffer.clear()
        return out


class MetricLogger:
    """JSONL + optional W&B sink (reference logs everything to W&B:
    LRW/video/src/train.py:35-38)."""

    def __init__(self, path: Optional[str] = None, use_wandb: bool = False,
                 project: str = "syncvsr_tpu", name: str = "run",
                 config: Optional[dict] = None):
        self.path = path
        self.wandb = None
        if use_wandb:
            import wandb   # an ImportError here names the missing package

            wandb.init(project=project, name=name, config=config or {})
            self.wandb = wandb
        self.fh = open(path, "a") if path else None

    def log(self, metrics: Dict[str, float], step: int):
        record = {"step": step, "time": time.time(), **metrics}
        if self.fh:
            self.fh.write(json.dumps(record) + "\n")
            self.fh.flush()
        if self.wandb:
            self.wandb.log(metrics, step=step)
        return record

    def close(self):
        if self.fh:
            self.fh.close()
        if self.wandb:
            self.wandb.finish()


def split_eval_weights(metrics):
    """Pop the in-graph denominators an eval step returns and build the
    per-key weight dict for AverageMeter.update: ``_weight`` is the real
    sample count of the batch (exact repeat-padded-tail handling),
    ``_tokens``/``_slots`` are the true denominators of the token-/slot-
    normalized metrics (decoder_acc, loss_audio) — sample-count weighting
    would break eval_batch_size invariance for those."""
    m = dict(metrics)
    weights = {"__default__": float(m.pop("_weight", 1.0))}
    if "_tokens" in m:
        weights["decoder_acc"] = float(m.pop("_tokens"))
    if "_slots" in m:
        weights["loss_audio"] = float(m.pop("_slots"))
    return m, weights
