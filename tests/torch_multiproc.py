"""Multi-process runs of the port for the data-parallel, FSDP and tensor
parallel parity tests (tests/test_torch_parallel.py,
tests/test_torch_fsdp.py, tests/test_torch_tensor_parallel*.py).

``spawn(job, world, tmp)`` starts ``world`` processes (``spawn`` start
method, one CPU thread each: the suite runs under ``-n 6``) that join a
gloo group on a free port, each run ``JOBS[job["kind"]]`` on its rows of
the job's global batch, and each save what it returns; the parent reads
the results back. A job's ``model`` and ``seq`` (default 1) are its
mesh's model and seq axes (data x seq x model = world). ``train_steps`` is also what the tests call in the
parent for the one-process reference (``mesh=None``). This module imports
no JAX: the workers import the port only.
"""

from __future__ import annotations

import contextlib
import os
import socket
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from syncvsr_tpu_torch.config import Config
from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
from syncvsr_tpu_torch.models import build_model, word
from syncvsr_tpu_torch.ops.image import (batch_hook, build_sentence_aug, build_word_aug,
                                         fused_train_aug_apply)
from syncvsr_tpu_torch.parallel import create_mesh, resident_bytes, shard_batch, shard_state
from syncvsr_tpu_torch.parallel.mesh import seed_dropout
from syncvsr_tpu_torch.utils import checkpoint as ckpt
from syncvsr_tpu_torch.utils.bridge import load_flax, to_flax
import torch_threads  # noqa: F401  (one torch thread a process, in the workers too)

TIMEOUT = 240   # seconds for a whole spawn


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rows(mesh, batch: Dict[str, np.ndarray], frame: int = 1) -> Dict[str, torch.Tensor]:
    """The whole batch (one process) or this rank's rows (and frames of
    ``frame`` elements), as CPU tensors."""
    if mesh is None:
        return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return shard_batch(mesh, batch, frame)


def train_steps(job: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """``job["steps"]`` train steps of the model of ``job["config"]`` (a
    port config dict) from the flax ``params``/``batch_stats``, on this
    rank's rows of the global ``batch``. Optional injected draws, global
    and sliced here: ``aug`` (the augmentation's sampled values, applied by
    ``fused_train_aug_apply``), ``cutmix`` ((ratio, start)) and ``lam``
    (the mixup weight); ``aug_dtype`` the augmented clips' dtype (bf16);
    ``port_aug`` augments with the port's own sampler instead
    (``build_word_aug``/``build_sentence_aug``, from the state's mixup
    stream);
    ``no_dropout`` zeroes every dropout rate of the model (the DenseTCN's is
    fixed). ``fsdp`` (min size) splits the state over data; on a mesh with a
    model axis the state is split over it by the rule at ``min_dim``
    (default 512) unless ``tp`` is False. Returns the
    metrics of every step, the params, batch_stats and moments as flax
    trees (gathered under FSDP) after the first step (``first``) and the
    last, the rank's resident bytes and its first dropout draws."""
    torch.manual_seed(0)
    cfg = Config.from_dict(job["config"])
    model = build_model(cfg, device="cpu")
    load_flax(model, job["params"], job["batch_stats"])
    batch = _rows(mesh, job["batch"], model.frontend.frame)
    if job.get("no_dropout"):   # the DenseTCN's fixed dropout
        for m in model.modules():
            if hasattr(m, "rate"):
                m.rate = 0.0
    state = create_train_state(cfg, model, batch, device="cpu")
    if mesh is not None:
        seed_dropout(state, mesh)
        if job.get("fsdp") or (mesh.model > 1 and job.get("tp", True)):
            state = shard_state(mesh, state, fsdp=bool(job.get("fsdp")),
                                fsdp_min_size=job.get("fsdp") or 2 ** 15,
                                min_dim=job.get("min_dim", 512))
    aug_fn = None
    if job.get("aug") is not None:
        drawn = _rows(mesh, job["aug"])
        d = cfg.data
        key = "inputs" if cfg.model.task == "word" else "videos"
        dtype = getattr(torch, job.get("aug_dtype", "bfloat16"))
        aug_fn = batch_hook(lambda bt: dict(bt, **{key: fused_train_aug_apply(
            bt[key], drawn, d.crop_size, d.mean, d.std, dtype)}))
    if job.get("port_aug"):
        aug_fn = (build_word_aug if cfg.model.task == "word" else build_sentence_aug)(cfg.data)
    if job.get("cutmix") is not None:
        ratio, start = (torch.tensor(np.float32(v)) for v in job["cutmix"])
        word.sample_cutmix = lambda gen, alpha: (ratio, start)
    if job.get("lam") is not None:
        word.sample_mixup = lambda gen, alpha: torch.tensor(np.float32(job["lam"]))
    step = build_train_step(aug_fn=aug_fn, mesh=mesh)
    at = state.dropout_gen.get_state()
    dropout_draw = torch.rand(4, generator=state.dropout_gen).tolist()
    state.dropout_gen.set_state(at)
    metrics: List[Dict[str, float]] = []
    out = {"dropout_draw": dropout_draw}
    for i in range(job["steps"]):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["first"] = _snapshot(state)
    out.update(_snapshot(state), metrics=metrics, resident=resident_bytes(state))
    whole = ckpt.gather_for_save(state)
    if job.get("eval"):
        ev = build_eval_step(mesh)(state, _rows(mesh, job["eval"]))
        out["eval"] = {k: float(v) for k, v in ev.items()}
    if job.get("save") and (mesh is None or mesh.rank == 0):
        ckpt.save_train_state(job["save"], whole, state.step)
    return out


def _snapshot(state) -> Dict[str, Any]:
    """Params, batch_stats and Adam's moments as flax trees (gathered under
    FSDP: a collective)."""
    whole = ckpt.gather_for_save(state)
    params, stats = ckpt.state_variables(whole)
    return {"params": params, "batch_stats": stats,
            "mu": to_flax(dict(zip(whole.names, whole.mu)))[0],
            "nu": to_flax(dict(zip(whole.names, whole.nu)))[0]}


def cli(job: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """``syncvsr_tpu_torch.<job["module"]>.main(job["args"], device="cpu")``
    in ``job["cwd"]`` (the process group already joined); its summary, or
    with ``job["capture"]`` {"summary": it, "stdout": what it printed}."""
    import importlib
    import io

    os.chdir(job["cwd"])
    main = importlib.import_module(f"syncvsr_tpu_torch.{job['module']}").main
    if not job.get("capture"):
        return main(job["args"], device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = main(job["args"], device="cpu")
    return {"summary": summary, "stdout": out.getvalue()}


def seq_ops(job: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """The sequence-parallel primitives on this rank's frames of
    ``job["x"]`` [B, T, C] inside the time-split region: for each
    ``(left, right)`` of ``job["halos"]`` the ``halo`` and the gradient of
    <its output, this rank's ``job["cot"][r]`` window>; ``gather_kv`` and
    the gradient of <its output, ``job["cot"][r]``> (a rank's own
    cotangent of every frame); ``gather_time`` and the gradient of
    ``replicated(<its output, job["cot"][0]>)`` (alike on every rank), as
    the step weights the replicated part."""
    from syncvsr_tpu_torch.parallel import collectives, sequence

    x_all = torch.from_numpy(job["x"])
    cots = torch.from_numpy(job["cot"])
    batch = shard_batch(mesh, {"inputs": x_all})
    out: Dict[str, Any] = {"time": (batch.time.start, batch.time.length)}
    with collectives.data_parallel(mesh), sequence.batch(batch.time):
        for name, fn, cot in (
                [(f"halo{l}_{r}", lambda x, l=l, r=r: sequence.halo(x, l, r), None)
                 for l, r in job["halos"]]
                + [("gather_kv", sequence.gather_kv, cots[mesh.rank]),
                   ("gather_time", sequence.gather_time, cots[0])]):
            x = batch["inputs"].clone().requires_grad_(True)
            with sequence.region() if name != "gather_time" else contextlib.nullcontext():
                y = fn(x)
            if cot is None:   # a halo: this rank's window of the padded clip
                cot = cots[mesh.rank]
            loss = (y * cot[:, :y.shape[1]]).sum()
            if name == "gather_time":
                loss = sequence.replicated(loss)
            loss.backward()
            out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def resnet1d(job: Dict[str, Any], mesh=None) -> Dict[str, Any]:
    """A float64 ResNet1D of ``job["width"]`` (weights from seed 0) in
    train mode on this rank's samples of the waveform ``job["audio"]``
    [B, S] (``shard_batch``: frames of 640 samples where they divide seq,
    else the whole) inside the time-split region: its frames' output, and
    the gradients of <output, this rank's frames of ``job["cot"]``> with
    respect to the rank's samples and each parameter."""
    from syncvsr_tpu_torch.models.frontend import Conv1DResNetFrontend
    from syncvsr_tpu_torch.models.resnet import ResNet1D
    from syncvsr_tpu_torch.parallel import collectives, sequence

    torch.manual_seed(0)
    net = ResNet1D(job["width"], dtype=torch.float64).double()
    batch = shard_batch(mesh, {"videos": torch.from_numpy(job["audio"])},
                        Conv1DResNetFrontend.frame)
    time = batch.time
    x = batch["videos"].clone().requires_grad_(True)
    with collectives.data_parallel(mesh), sequence.batch(time), sequence.region():
        y = net(x[..., None], True)
        t0 = time.start if time is not None else 0
        (y * torch.from_numpy(job["cot"])[:, t0:t0 + y.shape[1]]).sum().backward()
    return {"time": None if time is None else (time.start, time.length, time.total),
            "y": y.detach().numpy(), "gx": x.grad.numpy(),
            "gw": {n: p.grad.numpy() for n, p in net.named_parameters()}}


JOBS = {"train": train_steps, "cli": cli, "seq_ops": seq_ops, "resnet1d": resnet1d}


def _worker(rank: int, world: int, port: int, path: str) -> None:
    jobs = torch.load(path, weights_only=False)   # written by the parent test
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        out = []
        for job in jobs:
            mesh = create_mesh(model=job.get("model", 1), seq=job.get("seq", 1),
                               device="cpu")
            out.append(JOBS[job["kind"]](job, mesh))
        torch.save(out, f"{path}.{rank}")
    finally:
        dist.destroy_process_group()


def spawn(job, world: int, tmp, timeout: float = TIMEOUT):
    """Run ``job`` in ``world`` gloo processes; every rank's result. A list
    of jobs runs in one group, one after the other: a list, per job, of
    every rank's result. ``timeout`` bounds the whole group (a test file
    gives its own: about 3x the time it measured, at least 60 s)."""
    jobs = job if isinstance(job, list) else [job]
    path = os.path.join(str(tmp), f"job_{jobs[0]['kind']}_{time.monotonic_ns()}.pt")
    torch.save(jobs, path)
    ctx = mp.spawn(_worker, args=(world, free_port(), path), nprocs=world, join=False)
    start = time.monotonic()
    deadline = start + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{jobs[0]['kind']} on {world} processes: over "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    # the time a spawn takes, against its limit (pytest -rP shows it)
    print(f"spawn: {len(jobs)} job(s) on {world} processes in "
          f"{time.monotonic() - start:.1f} s of {timeout} s", file=sys.stderr)
    ranks = [torch.load(f"{path}.{r}", weights_only=False) for r in range(world)]
    per_job = [[ranks[r][i] for r in range(world)] for i in range(len(jobs))]
    return per_job if isinstance(job, list) else per_job[0]
