"""Train and eval steps (port of ``syncvsr_tpu/engine/steps.py``).

The step order of the JAX package: augmentation (mixup stream), forward in
train mode (BatchNorm running stats updated in place), backward, then the
clipped AdamW update. The forward draws CutMix's span or the TCN path's
batch-mixup weight from the same mixup generator (the state's, on the CPU),
after the augmentation; every batch key reaches the model as a keyword
(``word_mask``, ``attention_mask``, ``sample_weight``, ...). The update goes
through the configured wrappers (``optim.accum_steps``,
``optim.skip_nonfinite``; ``state.apply_gradients``), while the BatchNorm
running statistics move on every mini-step, as in the JAX package.
``grad_norm`` is the mini-batch gradient's, taken before clipping, and
``learning_rate`` the rate of the last inner update applied (``current_lr``).
PyTorch runs eagerly, so the state is updated in place and returned for the
JAX calling shape.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from syncvsr_tpu_torch.engine.state import TrainState, apply_gradients, grad_norm
from syncvsr_tpu_torch.parallel import collectives, sequence
from syncvsr_tpu_torch.parallel.mesh import Mesh, all_reduce_flat, split_time


def build_train_step(aug_fn: Optional[Callable] = None,
                     mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``;
    ``aug_fn(gen, batch) -> batch`` runs first, drawing from the state's
    mixup generator (``ops.image.build_word_aug``). ``batch`` holds this
    process's rows of the global batch of a ``mesh`` of several processes,
    which the step treats as the JAX package's global ``jit`` treats the
    batch sharded on ``data``: the forward and backward run with the mesh
    active (global BatchNorm statistics and loss means, global CutMix and
    mixup partners; ``parallel/collectives.py``; on a state split over the
    model axis, ``state.tp``, the split layers column-parallel,
    ``parallel/tensor.py``), then the gradients are summed over the data
    group (one all-reduce of one flat bucket; under FSDP, ``state.fsdp``, a
    reduce-scatter of the split leaves after their parameters were gathered
    for the forward), and every rank applies the update to what it holds
    (the model ranks to their own columns). On a mesh with a seq axis the
    step first splits the time of a batch of the data index's rows
    (``mesh.split_time`` in the frontend's input frames; a ``shard_batch``
    batch is split already), runs
    the forward and backward with that slice current
    (``parallel/sequence.py``), and sums the gradients over the data x seq
    ranks (one all-reduce; under FSDP one more over the seq ranks after the
    reduce-scatter). The metrics are the global batch's on every rank."""
    seq = mesh is not None and mesh.seq > 1
    distributed = mesh is not None and mesh.data * mesh.seq > 1

    def train_step(state: TrainState, batch: Dict[str, Any]):
        layout = state.fsdp
        batch = split_time(mesh, batch, state.model.frontend.frame if seq else 1)
        with collectives.data_parallel(mesh), sequence.batch(getattr(batch, "time", None)):
            if layout is not None:
                layout.gather()
            if aug_fn is not None:
                batch = aug_fn(state.mixup_gen, batch)
            for p in state.params:
                p.grad = None
            out = state.model(**batch, det=False, mixup_gen=state.mixup_gen,
                              dropout_gen=state.dropout_gen)
            out["loss"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in state.params]
        for p in state.params:
            p.grad = None
        if layout is not None:
            grads = layout.reduce_gradients(grads)
            layout.release()
            if seq:
                grads = all_reduce_flat(grads, mesh.seq_group)
        elif distributed:
            grads = all_reduce_flat(grads, mesh.over("data", "seq"))
        norm = grad_norm(state, grads)
        lr = apply_gradients(state, grads)
        metrics = {k: v.detach() for k, v in out.items()}
        metrics["learning_rate"] = torch.tensor(lr, dtype=torch.float32)
        metrics["grad_norm"] = norm
        return state, metrics

    return train_step


def build_eval_step(mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``eval_step(state, batch) -> metrics``: the forward with
    BatchNorm on its running statistics. Over a ``mesh`` of several
    processes the metrics, and ``_weight`` (the real rows' count), are the
    global batch's, as the JAX package's step returns them; on a mesh with
    a seq axis the forward runs on the rank's time slice, as the train
    step's."""
    seq = mesh is not None and mesh.seq > 1

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]):
        layout = state.fsdp
        batch = split_time(mesh, batch, state.model.frontend.frame if seq else 1)
        with collectives.data_parallel(mesh), sequence.batch(getattr(batch, "time", None)):
            if layout is not None:
                layout.gather()
            try:
                metrics = state.model(**batch, det=True)
                if batch.get("sample_weight") is not None:
                    metrics = dict(metrics, _weight=collectives.global_sum(
                        batch["sample_weight"].float().sum()))
            finally:
                if layout is not None:
                    layout.release()
        return metrics

    return eval_step
