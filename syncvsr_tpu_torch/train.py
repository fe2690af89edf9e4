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
``train.profile_dir``, with the spans of ``utils/profiling.py`` on.
``metrics.jsonl`` in ``train.ckpt_dir`` holds every logged record; besides
the keys the JAX package logs, each train record has, over the steps since
the last record, a step's ``train/launches/<kernel>`` (the hand-written
kernels' launches; 0 on the CPU, where the plain versions run),
``train/loader_wait_ms`` (the host's wait for the loader's next batch, the
``train.loader_wait`` span) and ``train/host_reads`` (the host's reads of
device values in the step and the lagged metrics' read).

``model.codec.in_step=true model.codec.ckpt=<vq-wav2vec .pt>`` quantizes
the loader's raw waveforms inside the step (``ops/codec.py``): the frozen
codec's tensors live in the batch hook's closure, in no optimizer group and
no checkpoint, and the hook runs before the augmentation, on the init
example and on every eval batch that carries ``audio``.

It runs on the GPU and raises without one (``train(config,
device="cpu")`` runs the plain PyTorch path on the CPU, as the tests do).
Under ``torchrun`` (``WORLD_SIZE`` in the environment) or with
``train.distributed=true`` it joins the process group (NCCL, each rank on
``cuda:LOCAL_RANK``; gloo for ``device="cpu"``) and trains data-parallel
over it, as the JAX driver over its mesh: each rank loads its rows of
every global batch of ``data.batch_size``, the step reduces over the
global batch (``engine/steps.py``), ``mesh.fsdp=true`` splits the
parameters and Adam moments over the ranks (``parallel/mesh.py``), each
rank draws dropout from its own stream (``train.dropout_seed`` and the
rank), and rank 0 alone prints, logs ``metrics.jsonl`` and writes
checkpoints (every rank joins the gather before a write). ``mesh.data``
x ``mesh.seq`` x ``mesh.model`` must be the world size (``mesh.data=-1``
takes what the others leave): ``mesh.model`` splits the model rule's
leaves over the model ranks (tensor parallel, under ``mesh.fsdp`` as the
JAX driver places the state), ``mesh.seq`` the clips' time over the seq
ranks (sequence parallel, ``parallel/sequence.py``; a clip length that
does not divide it runs whole on every seq rank). The ranks of one data
index load the same rows. ``train.scoped_vmem_kib`` and
``train.donate`` are the JAX package's compiler settings and are ignored.

    torchrun --nproc-per-node 8 -m syncvsr_tpu_torch.train preset=lrs3 \\
        data.dataset=lrs3 data.root=/data mesh.fsdp=true
    torchrun --nproc-per-node 8 -m syncvsr_tpu_torch.train preset=lrs3 \\
        data.dataset=lrs3 data.root=/data mesh.seq=2
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

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
from syncvsr_tpu_torch.parallel import create_mesh, resident_bytes, shard_state
from syncvsr_tpu_torch.parallel.mesh import seed_dropout
from syncvsr_tpu_torch.utils import checkpoint as ckpt
from syncvsr_tpu_torch.utils.device import resolve_device
from syncvsr_tpu_torch.utils.metrics import AverageMeter, MetricLogger, split_eval_weights
from syncvsr_tpu_torch.utils.profiling import (StepTimer, Trace, host_read, host_read_counts,
                                                span)


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


def init_distributed(config: Config, device: Optional[Union[str, torch.device]] = None
                     ) -> Tuple[torch.device, bool]:
    """This process's device, and whether this call started the process
    group. Under ``torchrun`` (``WORLD_SIZE`` set) or ``train.distributed``
    it joins the group from the environment (``MASTER_ADDR``, ``RANK``,
    ...): NCCL on ``cuda:LOCAL_RANK``, gloo for a CPU device. Where a host
    starts more processes than it has cards (``LOCAL_WORLD_SIZE``), they
    share the cards (``cuda:LOCAL_RANK % cards``) over gloo, which NCCL
    refuses: a check of a mesh on fewer cards, not a way to scale. A group
    that exists already is used as it is."""
    dev = resolve_device(device)
    if not (config.train.distributed or "WORLD_SIZE" in os.environ):
        return dev, False
    shared = False
    if dev.type == "cuda":
        local, cards = int(os.environ.get("LOCAL_RANK", 0)), torch.cuda.device_count()
        shared = int(os.environ.get("LOCAL_WORLD_SIZE", 1)) > cards
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev, False
    if dev.type == "cuda" and not shared:
        dist.init_process_group("nccl", device_id=dev)
    else:
        if shared and int(os.environ.get("LOCAL_RANK", 0)) == 0:
            print(f"[train] {os.environ['LOCAL_WORLD_SIZE']} processes share "
                  f"{torch.cuda.device_count()} card(s): gloo (NCCL takes one process a "
                  "card); this checks the mesh, it does not scale")
        dist.init_process_group("gloo")
    return dev, True


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    with span("train.to_device"):
        return {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def host_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """Each metric read to the host: one host read a key the step computed
    (``learning_rate`` is made on the host, so its read waits on nothing)."""
    with span("train.host_metrics"):
        host_read("train.host_metrics", sum(k != "learning_rate" for k in metrics))
        return {k: float(v) for k, v in metrics.items()}


def waited(loader, seconds: List[float]):
    """The loader's batches; the host's wait for each (the
    ``train.loader_wait`` span) is added to ``seconds[0]``."""
    batches = iter(loader)
    while True:
        t0 = time.perf_counter()
        with span("train.loader_wait"):
            batch = next(batches, None)
        seconds[0] += time.perf_counter() - t0
        if batch is None:
            return
        yield batch


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
    dev, started = init_distributed(config, device)
    try:
        return _train(config, dev)
    finally:
        if started:
            dist.destroy_process_group()


def _train(config: Config, dev: torch.device) -> Dict[str, float]:
    mesh = create_mesh(config.mesh.data, config.mesh.model, config.mesh.seq, device=dev)
    lead = mesh.rank == 0
    model = build_model(config, device=dev)
    # the loaders split over the data axis: the seq and model ranks of a
    # data index read the same rows
    train_loader, eval_loader = build_loaders(config, process_index=mesh.data_index,
                                              process_count=mesh.data)
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
    if lead:
        print(f"[train] params: {n_params / 1e6:.2f}M, device: {dev}"
              + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else "")
              + f", processes: {mesh.size}"
              + (f" ({dist.get_backend()})" if dist.is_initialized() else "")
              + f", mesh data {mesh.data} x seq {mesh.seq} x model {mesh.model}")
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
        if lead:
            print(f"[train] resumed from {latest} @ step {start_step}")
    seed_dropout(state, mesh)
    if config.mesh.fsdp:
        # split the parameters and Adam moments after the restore and the
        # warm start, which every rank reads whole
        # (and over a model axis, as the JAX driver's shard_state does)
        state = shard_state(mesh, state, fsdp=True, fsdp_min_size=config.mesh.fsdp_min_size)
    if lead:
        held = resident_bytes(state)
        print(f"[train] state a rank holds: params {held['params']} B, Adam moments "
              f"{held['moments']} B")

    train_step = build_train_step(aug_fn=aug_fn, mesh=mesh)
    eval_step = build_eval_step(mesh)

    os.makedirs(config.train.ckpt_dir, exist_ok=True)
    logger = MetricLogger(path=os.path.join(config.train.ckpt_dir, "metrics.jsonl")
                          if lead else None,
                          use_wandb=config.train.wandb and lead, name=config.name,
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
    if config.train.profile_steps and lead:   # one trace, rank 0's
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
        # every rank takes the same branch (the metrics are the global
        # batch's): the gather is a collective under FSDP
        nonlocal best
        if val.get(f"val/{monitor}", -np.inf) > best:
            best = val[f"val/{monitor}"]
            whole = ckpt.gather_for_save(state)
            if lead:
                params, batch_stats = ckpt.state_variables(whole)
                saver.save_msgpack(os.path.join(config.train.ckpt_dir, "best.msgpack"),
                                   {"params": params, "batch_stats": batch_stats,
                                    "step": step, monitor: best})

    def save(at: int) -> None:
        to_save = ckpt.gather_for_save(state)
        if lead:
            saver.save(config.train.ckpt_dir, to_save, at)

    # metrics accounting lags one step: reading step N's metrics waits for
    # the device, so it happens after step N+1 is enqueued
    pending_metrics = None
    launched, window_steps = dict.fromkeys(launch_counts(), 0), 0
    wait_s, reads = [0.0], 0
    try:
        for epoch in range(config.train.epochs):
            for batch in waited(train_loader, wait_s):
                if prof_range and step == prof_range[0]:
                    prof.start()
                before, reads_before = launch_counts(), host_read_counts()
                with timer:
                    state, metrics = train_step(state, to_device(batch, dev))
                    if pending_metrics is not None:
                        meter.update(host_metrics(pending_metrics))
                    pending_metrics = metrics
                for k, n in launch_counts().items():
                    launched[k] += n - before[k]
                reads += sum(host_read_counts().values()) - sum(reads_before.values())
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
                    summary["train/loader_wait_ms"] = 1e3 * wait_s[0] / window_steps
                    summary["train/host_reads"] = reads / window_steps
                    launched, window_steps = dict.fromkeys(launched, 0), 0
                    wait_s[0], reads = 0.0, 0
                    t_start = time.time()
                    logger.log(summary, step)
                    if lead:
                        print(f"[step {step}] " + " ".join(
                            f"{k.split('/')[-1]}={v:.4f}" for k, v in summary.items()))
                if step % config.train.eval_every == 0:
                    val = run_eval()
                    logger.log(val, step)
                    if lead:
                        print(f"[eval {step}] " + " ".join(
                            f"{k.split('/')[-1]}={v:.4f}" for k, v in val.items()))
                    save_best(val)
                if step % config.train.ckpt_every == 0:
                    save(step)
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
        save(step)
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
