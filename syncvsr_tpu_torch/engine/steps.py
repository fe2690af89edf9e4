"""Train and eval steps (port of ``syncvsr_tpu/engine/steps.py``).

The step order of the JAX package: augmentation (mixup stream), forward in
train mode (BatchNorm running stats updated in place), backward, then the
clipped AdamW update. CutMix's span or the TCN path's batch-mixup weight
come from the same mixup generator (the state's, on the CPU), after the
augmentation's draws; the host makes every draw before the device work
(``build_train_step``); every batch key reaches the model as a keyword
(``word_mask``, ``attention_mask``, ``sample_weight``, ...). The update goes
through the configured wrappers (``optim.accum_steps``,
``optim.skip_nonfinite``; ``state.apply_gradients``), while the BatchNorm
running statistics move on every mini-step, as in the JAX package.
``grad_norm`` is the mini-batch gradient's, taken before clipping, and
``learning_rate`` the rate of the last inner update applied (``current_lr``).
The state is updated in place and returned for the JAX calling shape. On a
CUDA device a step that can be replayed is captured as one CUDA graph at
the second step of its input signature and replayed from then on
(``engine/graph.py``, which says when a step stays eager).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from syncvsr_tpu_torch.engine.graph import GraphedStep
from syncvsr_tpu_torch.engine.state import TrainState, apply_gradients, grad_norm, take_grads
from syncvsr_tpu_torch.ops.image import TrainAug
from syncvsr_tpu_torch.parallel import collectives, sequence
from syncvsr_tpu_torch.parallel.mesh import Mesh, all_reduce_flat, split_time
from syncvsr_tpu_torch.utils.profiling import span


def build_train_step(aug_fn: Optional[TrainAug] = None,
                     mesh: Optional[Mesh] = None) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``. The step
    draws first, on the host, from the state's mixup generator: the
    augmentation's values (``aug_fn.draw``; ``aug_fn`` is an
    ``ops.image.TrainAug``, ``ops.image.build_word_aug``), then the model's
    CutMix or mixup (``model.draw_mix``); its device work then applies
    them (``aug_fn.apply``, the model's ``mix``). ``batch`` holds this
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
    reduce-scatter). The metrics are the global batch's on every rank.
    The step is a ``graph.GraphedStep``: where it can be, the device work
    is replayed as a CUDA graph, with the same draws, arithmetic and
    metrics."""
    seq = mesh is not None and mesh.seq > 1
    distributed = mesh is not None and mesh.data * mesh.seq > 1

    def draw(state: TrainState, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The step's host draws, in order: the augmentation's, then the
        model's."""
        gen = state.mixup_gen
        with collectives.data_parallel(mesh), sequence.batch(getattr(batch, "time", None)):
            return {"aug": None if aug_fn is None else aug_fn.draw(gen, batch),
                    "mix": state.model.draw_mix(gen, batch)}

    def run(state: TrainState, batch: Dict[str, Any], drawn: Dict[str, Any],
            update: Callable[[List[torch.Tensor]], Any]):
        """The step's device work with the host's draws: augmentation,
        forward, backward, the gradients' collection and ``grad_norm``, then
        ``update(grads)``; (the model's outputs, the norm, what ``update``
        returned)."""
        layout = state.fsdp
        with collectives.data_parallel(mesh), sequence.batch(getattr(batch, "time", None)):
            if layout is not None:
                layout.gather()
            with span("step.forward"):
                if aug_fn is not None:
                    with span("step.augment"):
                        batch = aug_fn.apply(batch, drawn["aug"])
                for p in state.params:
                    p.grad = None
                out = state.model(**batch, det=False, mix=drawn["mix"],
                                  dropout_gen=state.dropout_gen)
            with span("step.backward"):
                out["loss"].backward()
        with span("step.update"):
            grads = take_grads(state)
            if layout is not None:
                grads = layout.reduce_gradients(grads)
                layout.release()
                if seq:
                    grads = all_reduce_flat(grads, mesh.seq_group)
            elif distributed:
                grads = all_reduce_flat(grads, mesh.over("data", "seq"))
            norm = grad_norm(state, grads)
            applied = update(grads)
        return {k: v.detach() for k, v in out.items()}, norm, applied

    def train_step(state: TrainState, batch: Dict[str, Any]):
        batch = split_time(mesh, batch, state.model.frontend.frame if seq else 1)
        out, norm, lr = run(state, batch, draw(state, batch),
                            lambda grads: apply_gradients(state, grads))
        return state, dict(out, learning_rate=torch.tensor(lr, dtype=torch.float32),
                           grad_norm=norm)

    return GraphedStep(train_step, draw, run, mesh)


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
