"""Model factory: Config -> task module on a device."""

from __future__ import annotations

from typing import Optional, Union

import torch

from syncvsr_tpu_torch.config import Config
from syncvsr_tpu_torch.utils.device import resolve_device


def _check_ported(config: Config) -> None:
    """Raise for configurations whose modules the port does not have yet."""
    m = config.model
    missing = []
    if m.frontend.kind != "conv3d_resnet":
        missing.append(f"model.frontend.kind={m.frontend.kind!r}")
    if m.task == "word":
        if m.encoder.kind != "transformer":
            missing.append(f"model.encoder.kind={m.encoder.kind!r}")
        if not (m.encoder.use_rmsnorm and m.encoder.use_glu):
            missing.append("a LayerNorm or plain-GELU transformer")
    elif m.task == "sentence":
        if m.encoder.kind != "conformer":
            missing.append(f"model.encoder.kind={m.encoder.kind!r} for task='sentence'")
    else:
        missing.append(f"model.task={m.task!r}")
    if m.remat:
        missing.append("model.remat=True")
    if missing:
        raise NotImplementedError(
            "not ported to PyTorch yet: " + ", ".join(missing))


def build_model(config: Config, device: Optional[Union[str, torch.device]] = None):
    """The model of ``config`` (word-level or sentence-level) with seeded
    random weights (``train.seed``), on ``device`` (None = the GPU)."""
    dev = resolve_device(device)
    _check_ported(config)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.train.seed)
        if config.model.task == "sentence":
            from syncvsr_tpu_torch.models.e2e import SentenceVSRModel

            model = SentenceVSRModel(config.model)
        else:
            from syncvsr_tpu_torch.models.word import WordVSRModel

            model = WordVSRModel(config.model, cutmix_alpha=config.data.cutmix_alpha,
                                 use_cutmix=config.data.use_cutmix)
    return model.to(dev)
