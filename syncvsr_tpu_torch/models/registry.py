"""Model factory: Config -> task module on a device."""

from __future__ import annotations

from typing import Optional, Union

import torch

from syncvsr_tpu_torch.config import Config
from syncvsr_tpu_torch.utils.device import resolve_device


def build_model(config: Config, device: Optional[Union[str, torch.device]] = None):
    """The model of ``config`` (word-level or sentence-level) with seeded
    random weights (``train.seed``), on ``device`` (None = the GPU). As in
    the JAX package, ``model.encoder.kind`` picks the TCN family for a word
    model and a transformer for any other kind; a sentence model is a
    Conformer whatever the kind. An unknown ``model.task`` is a ValueError."""
    task = config.model.task
    if task not in ("word", "sentence"):
        raise ValueError(f"unknown task: {task}")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.train.seed)
        if task == "sentence":
            from syncvsr_tpu_torch.models.e2e import SentenceVSRModel

            model = SentenceVSRModel(config.model)
        else:
            from syncvsr_tpu_torch.models.word import WordVSRModel

            model = WordVSRModel(config.model, cutmix_alpha=config.data.cutmix_alpha,
                                 use_cutmix=config.data.use_cutmix)
    return model.to(dev)
