"""Training driver for every ported workload (port of
``syncvsr_tpu/train.py``).

Usage (on the GPU):
    python -m syncvsr_tpu_torch.train preset=lrw_video data.root=/data/LRW \\
        optim.lr=1e-4 train.epochs=10
    python -m syncvsr_tpu_torch.train config=path/to/config.json [overrides...]

The JAX driver's loop over the PyTorch engine: the loader feeds numpy
batches that go to the device, metrics aggregate in an AverageMeter one step
late (a step's metrics are read after the next step is enqueued, so the
host never waits for the device in between), periodic eval tracks the
monitored metric into ``best.msgpack``, ``step_<N>.msgpack`` is written
every ``train.ckpt_every`` steps in the JAX package's format (either
package resumes from the other's), ``resume=auto`` continues from the
newest, ``train.pretrained`` warm-starts by intersection, and
``train.profile_steps=a:b`` profiles steps a..b with torch.profiler into
``train.profile_dir``. ``metrics.jsonl`` in ``train.ckpt_dir`` holds every
logged record; besides the JAX driver's keys, each train record has
``train/launches/<kernel>``, the hand-written kernels' launches a train
step over the steps since the last record (0 on the CPU, where the plain
versions run).

``model.codec.in_step=true model.codec.ckpt=<vq-wav2vec .pt>`` quantizes
the loader's raw waveforms inside the step (``ops/codec.py``): the frozen
codec's tensors live in the batch hook's closure, in no optimizer group and
no checkpoint, and the hook runs before the augmentation, on the init
example and on every eval batch that carries ``audio``.

It runs on one GPU and raises without one (``train(config,
device="cpu")`` runs the plain PyTorch path on the CPU, as the tests do).
``mesh.data > 1``, model or sequence axes, ``mesh.fsdp`` and
``train.distributed`` raise until the multi-GPU layer is ported;
``train.scoped_vmem_kib`` and ``train.donate`` are the JAX package's
compiler settings and are ignored.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from syncvsr_tpu_torch.config import PRESETS, Config, parse_cli_overrides
from syncvsr_tpu_torch.data.factory import build_loaders
from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.ops import launch_counts
from syncvsr_tpu_torch.ops.image import (
    build_eval_transform,
    build_sentence_aug,
    build_sentence_eval_transform,
    build_word_aug,
)
from syncvsr_tpu_torch.utils import checkpoint as ckpt
from syncvsr_tpu_torch.utils.device import resolve_device
from syncvsr_tpu_torch.utils.metrics import AverageMeter, MetricLogger, split_eval_weights
from syncvsr_tpu_torch.utils.profiling import StepTimer, Trace


def load_config(argv: Sequence[str]) -> Config:
    overrides = parse_cli_overrides(argv)
    preset = overrides.pop("preset", None)
    config_path = overrides.pop("config", None)
    if config_path:
        with open(config_path) as f:
            config = Config.from_dict(json.load(f))
    elif preset:
        config = PRESETS[preset]()
    else:
        config = Config()
    return config.override(**overrides) if overrides else config


def monitored_metric(config: Config) -> str:
    # val accuracy for word-level (train.py:19-21), decoder acc for sentence
    # (LRS/video/main.py:21-23)
    return "acc1" if config.model.task == "word" else "decoder_acc"


def check_single_device(config: Config) -> None:
    """Raise for the multi-device options the port does not have yet."""
    m = config.mesh
    asked = [name for name, on in (
        (f"mesh.data={m.data}", m.data not in (-1, 1)),
        (f"mesh.model={m.model}", m.model != 1), (f"mesh.seq={m.seq}", m.seq != 1),
        ("mesh.fsdp=true", m.fsdp), ("train.distributed=true", config.train.distributed))
        if on]
    if asked:
        raise NotImplementedError("not ported to PyTorch yet: " + ", ".join(asked))


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def host_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def transforms(config: Config):
    """(eval transform, train-time augmentation) of the config's task."""
    if config.model.task == "word":
        return build_eval_transform(config.data), build_word_aug(config.data)
    return (build_sentence_eval_transform(config.data, config.data.dataset),
            build_sentence_aug(config.data))


def instep_tokenizer(config: Config, device: torch.device):
    """The in-step vq-wav2vec batch hook of ``model.codec`` (frozen codec
    tensors on ``device``), or None when ``in_step`` is off."""
    if not config.model.codec.in_step:
        return None
    from syncvsr_tpu_torch.ops.codec import load_vq_codec, make_instep_tokenizer

    params, geom = load_vq_codec(config.model.codec.ckpt, device)
    return make_instep_tokenizer(params, alignment=config.model.codec.audio_alignment,
                                 strides=geom["strides"], **geom["features"])


def train(config: Config, device: Optional[Union[str, torch.device]] = None
          ) -> Dict[str, float]:
    dev = resolve_device(device)
    check_single_device(config)
    model = build_model(config, device=dev)
    train_loader, eval_loader = build_loaders(config)
    base_eval_transform, aug_fn = transforms(config)
    tokenize = instep_tokenizer(config, dev)

    def eval_transform(batch):
        batch = base_eval_transform(batch)
        return tokenize(batch) if tokenize is not None and "audio" in batch else batch

    if tokenize is not None:
        base_aug = aug_fn
        aug_fn = lambda gen, b: base_aug(gen, tokenize(b))  # noqa: E731

    example = next(iter(train_loader))
    state = create_train_state(config, model, eval_transform(to_device(example, dev)),
                               device=dev)
    n_params = sum(p.numel() for p in state.params)
    print(f"[train] params: {n_params / 1e6:.2f}M, device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""))
    if config.train.tabulate:
        print(model)

    if config.train.pretrained:
        pre = ckpt.load_msgpack(config.train.pretrained)
        ckpt.load_params(state.model, pre.get("params", pre))
    start_step = 0
    latest = ckpt.latest_checkpoint(config.train.ckpt_dir) \
        if config.train.resume == "auto" else (config.train.resume or None)
    if latest and os.path.exists(latest):
        ckpt.restore_train_state(latest, state)
        start_step = state.step
        print(f"[train] resumed from {latest} @ step {start_step}")

    train_step = build_train_step(aug_fn=aug_fn)
    eval_step = build_eval_step()

    os.makedirs(config.train.ckpt_dir, exist_ok=True)
    logger = MetricLogger(path=os.path.join(config.train.ckpt_dir, "metrics.jsonl"),
                          use_wandb=config.train.wandb, name=config.name,
                          config=config.to_dict())
    meter = AverageMeter()
    monitor = monitored_metric(config)
    best = -np.inf
    # serialization + disk IO overlap training; only the host copy is sync
    saver = ckpt.AsyncCheckpointer()
    step = start_step
    t_start = time.time()
    timer = StepTimer(device=dev)
    # optional torch.profiler window over a step range ("start:stop")
    prof_range, prof = None, None
    if config.train.profile_steps:
        a, b = config.train.profile_steps.split(":")
        prof_range, prof = (int(a), int(b)), Trace(config.train.profile_dir)

    def run_eval() -> Dict[str, float]:
        em = AverageMeter()
        for batch in eval_loader:
            m = host_metrics(eval_step(state, eval_transform(to_device(batch, dev))))
            m, w = split_eval_weights(m)
            em.update(m, weight=w)
        return em.summary("val/")

    def save_best(val: Dict[str, float]) -> None:
        nonlocal best
        if val.get(f"val/{monitor}", -np.inf) > best:
            best = val[f"val/{monitor}"]
            params, batch_stats = ckpt.model_variables(state.model)
            saver.save_msgpack(os.path.join(config.train.ckpt_dir, "best.msgpack"),
                               {"params": params, "batch_stats": batch_stats,
                                "step": step, monitor: best})

    # metrics accounting lags one step: reading step N's metrics waits for
    # the device, so it happens after step N+1 is enqueued
    pending_metrics = None
    launched, window_steps = dict.fromkeys(launch_counts(), 0), 0
    try:
        for epoch in range(config.train.epochs):
            for batch in train_loader:
                if prof_range and step == prof_range[0]:
                    prof.start()
                before = launch_counts()
                with timer:
                    state, metrics = train_step(state, to_device(batch, dev))
                    if pending_metrics is not None:
                        meter.update(host_metrics(pending_metrics))
                    pending_metrics = metrics
                for k, n in launch_counts().items():
                    launched[k] += n - before[k]
                step += 1
                window_steps += 1
                if prof_range and step == prof_range[1]:
                    prof.stop()
                    print(f"[trace] wrote {config.train.profile_dir}")
                if step % config.train.log_every == 0:
                    summary = meter.summary("train/")
                    summary["train/steps_per_sec"] = config.train.log_every / max(
                        time.time() - t_start, 1e-6)
                    if timer.avg_ms:
                        summary["train/step_ms_ema"] = timer.avg_ms
                    summary.update({f"train/launches/{k}": n / window_steps
                                    for k, n in launched.items()})
                    launched, window_steps = dict.fromkeys(launched, 0), 0
                    t_start = time.time()
                    logger.log(summary, step)
                    print(f"[step {step}] " + " ".join(
                        f"{k.split('/')[-1]}={v:.4f}" for k, v in summary.items()))
                if step % config.train.eval_every == 0:
                    val = run_eval()
                    logger.log(val, step)
                    print(f"[eval {step}] " + " ".join(
                        f"{k.split('/')[-1]}={v:.4f}" for k, v in val.items()))
                    save_best(val)
                if step % config.train.ckpt_every == 0:
                    saver.save(config.train.ckpt_dir, ckpt.gather_for_save(state), step)
                if config.optim.total_steps and step >= config.optim.total_steps:
                    break
            else:
                continue
            break

        if pending_metrics is not None:  # flush the lagged final-step metrics
            meter.update(host_metrics(pending_metrics))
            tail = meter.summary("train/")  # partial window since the last log
            if tail:
                logger.log(tail, step)
        final = run_eval()
        logger.log(final, step)
        saver.save(config.train.ckpt_dir, ckpt.gather_for_save(state), step)
        saver.wait()
    finally:
        saver.close()
        logger.close()
    return final


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> Dict[str, float]:
    config = load_config(sys.argv[1:] if argv is None else argv)
    final = train(config, device=device)
    print("[done]", json.dumps(final))
    return final


if __name__ == "__main__":
    main()
