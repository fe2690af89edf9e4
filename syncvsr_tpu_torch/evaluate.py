"""Evaluation driver (port of ``syncvsr_tpu/evaluate.py``).

Word-level: top-1/top-5 accuracy over the split, exact under the loader's
repeat-padded tail (reference LRW/video/src/inference.py). Sentence-level:
per-utterance beam-search WER (reference LRS/video/lightning.py:114-129,
224-234) with the hybrid CTC/attention decoder (``decode=beam``, one clip
at a time, or ``decode=beam_batched``, a bucket at a time, padded to the
largest eval bucket with ``decode_pad=max`` or to its own with
``decode_pad=bucket``), greedy-CTC WER (``decode=greedy``), or CTC forced
alignment of the transcripts (``decode=align``). Every hypothesis goes to
``hypotheses.jsonl`` in the working directory; the summary is the last line
of the output, one JSON object.

Evaluates the **test** split by default (override with ``data.split=val``).
``ckpt=`` takes a checkpoint of either package (``best.msgpack`` or
``step_<N>.msgpack``). Optional LM shallow fusion mirrors the reference's
config-built LM scorer (LRS/video/lightning.py:243-279,
config/lrs3.yaml:64-71): ``lm_ckpt=`` a flax LM msgpack or an
espnet-trained torch LM (``.pth``, converted on load by
``utils/torch_convert.py::convert_lm``), and ``lm_weight=0.1``.

Under ``torchrun`` (or ``train.distributed=true``) each process reads its
rows of every eval batch, as the train driver's ranks do: the word-level
step returns the global batch's metrics on every rank (``_weight`` the
global real-row count), and the decoders run on each rank's rows, whose
hypotheses rank 0 gathers in the loader's order, scores and writes. The
WER, the accuracy and the hypotheses equal one process's. With
``mesh.model > 1`` or ``mesh.seq > 1`` the weights stay whole on every
rank (the JAX driver's ``_eval_mesh`` replicates them too) and the rows
split over the data axis: the seq and model ranks of one data index
evaluate the same rows (the word-level step splits their clips' time over
the seq ranks, as the train step does; the decoders run whole clips, as
JAX's data-only decode mesh does). A mesh config
that does not fit the process group (``mesh.data`` another size) decodes
unsharded, every rank the whole split, with the JAX driver's message.

Usage (on the GPU):
    python -m syncvsr_tpu_torch.evaluate preset=lrs3 data.root=/data \\
        ckpt=best.msgpack decode=beam beam_size=40 \\
        [lm_ckpt=lm.msgpack lm_weight=0.1] [data.split=val]
    torchrun --nproc-per-node 8 -m syncvsr_tpu_torch.evaluate preset=lrs3 ...
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from syncvsr_tpu_torch.config import PRESETS, Config, parse_cli_overrides
from syncvsr_tpu_torch.data.factory import build_loaders
from syncvsr_tpu_torch.decode import BeamSearchConfig
from syncvsr_tpu_torch.decode.api import (
    make_batched_beam_decoder,
    make_beam_decoder,
    make_forced_aligner,
    make_greedy_ctc_decoder,
)
from syncvsr_tpu_torch.engine import build_eval_step, create_train_state
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.parallel import Mesh, create_mesh
from syncvsr_tpu_torch.parallel.mesh import world
from syncvsr_tpu_torch.train import host_metrics, init_distributed, to_device, transforms
from syncvsr_tpu_torch.utils import checkpoint as ckpt
from syncvsr_tpu_torch.utils.bridge import load_flax, to_flax
from syncvsr_tpu_torch.utils.metrics import AverageMeter, split_eval_weights
from syncvsr_tpu_torch.utils.text import WordErrorRate


def load_lm(path: str, kind: str, vocab: int, shape: Dict[str, int], device: torch.device):
    """The LM of ``kind`` ("transformer" or "rnn") at ``shape``: an espnet
    torch checkpoint at ``path`` is converted (``convert_lm``) and loaded
    whole; a flax msgpack's weights are merged onto a seeded init
    (``partial_load``, so a checkpoint that predates a module still loads)."""
    from syncvsr_tpu_torch.models.lm import RNNLM, TransformerLM

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        if kind == "rnn":
            lm = RNNLM(vocab, layers=shape["layers"], dim=shape["dim"],
                       embed_dim=shape["embed_dim"])
        else:
            lm = TransformerLM(vocab, **shape)
    with open(path, "rb") as f:
        magic = f.read(2)
    # torch saves are zip ("PK") or legacy pickle (0x80); flax msgpack
    # payloads are msgpack maps (0x8N fixmap / 0xde / 0xdf)
    if magic[:2] == b"PK" or (magic and magic[0] == 0x80):
        from syncvsr_tpu_torch.utils.torch_convert import convert_lm

        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        load_flax(lm, convert_lm(sd, kind, shape["dim"], shape["heads"], shape["layers"]))
        return lm.to(device).eval()
    payload = ckpt.load_msgpack(path)
    pre = payload.get("params", payload)
    if kind != "rnn" and not any("input_norm" in k for k in ckpt.flatten(pre)):
        # a checkpoint predating TransformerLM's input_norm loads (a fresh
        # identity LayerNorm fills the gap), but the ReLU added beside it
        # still changes the function the checkpoint was trained with
        print("[lm] WARNING: LM checkpoint has no input_norm subtree (predates the "
              "espnet embed LayerNorm+ReLU); its fusion scores will differ from "
              "training time — re-convert or re-train the LM.", file=sys.stderr)
    params, _ = ckpt.partial_load(to_flax(lm.state_dict())[0], pre)
    load_flax(lm, params)
    return lm.to(device).eval()


def _valid_rows(batch: Dict[str, Any]):
    """Real rows of a bucket batch (sample_weight marks repeat-padding).
    Scoring only these keeps WER invariant to eval_batch_size (each
    utterance counted exactly once, reference LRS/video/lightning.py:114-129)."""
    if "sample_weight" in batch:
        weight = batch["sample_weight"]
        if isinstance(weight, torch.Tensor):
            weight = weight.cpu().numpy()
        return [int(i) for i in np.flatnonzero(np.asarray(weight) > 0)]
    return list(range(batch["videos"].shape[0]))


def eval_mesh(config: Config, device: torch.device) -> Mesh:
    """The mesh of the process group, or, where the mesh config does not
    fit it (``mesh.data`` another size), this process alone, decoding the
    whole split unsharded (the JAX driver's ``_eval_mesh``)."""
    try:
        return create_mesh(config.mesh.data, config.mesh.model, config.mesh.seq,
                           device=device)
    except ValueError as e:
        print(f"eval: mesh config unusable here ({e}); decoding unsharded",
              file=sys.stderr)
        return Mesh(size=1, rank=world()[0], device=device)


def gather_records(records: List[Tuple[Tuple[int, int], Dict[str, Any]]], mesh: Mesh
                   ) -> List[Dict[str, Any]]:
    """Every rank's (batch, row) keyed records, on rank 0 in the loaders'
    order: data index d's row i of batch k is row (k, i, d) of the split,
    which is one process's order (the loaders give data index d the strided
    rows d, d + D, ...; the seq and model ranks of one data index decode
    the same rows, and seq index 0's model index 0's count). Other ranks
    get an empty list."""
    if mesh.size == 1:
        return [rec for _, rec in records]
    gathered = [None] * mesh.size
    dist.all_gather_object(gathered, records)
    if mesh.rank:
        return []
    per_data = mesh.seq * mesh.model   # ranks a data index: rank d * per_data leads
    keyed = [(key + (r // per_data,), rec) for r, recs in enumerate(gathered)
             if r % per_data == 0 for key, rec in recs]
    return [rec for _, rec in sorted(keyed, key=lambda kr: kr[0])]


def _segments(frames):
    """[token, start, end) runs of the non-blank frames of an alignment."""
    segments = []
    for t0, tok in enumerate(frames):
        if tok != 0 and (not segments or segments[-1][0] != tok
                         or segments[-1][2] != t0):
            segments.append([tok, t0, t0 + 1])
        elif tok != 0:
            segments[-1][2] = t0 + 1
    return segments


def main(argv: Optional[Sequence[str]] = None,
         device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    overrides = parse_cli_overrides(sys.argv[1:] if argv is None else argv)
    preset = overrides.pop("preset", None)
    ckpt_path = overrides.pop("ckpt", None)
    decode_mode = overrides.pop("decode", "beam")
    beam_size = int(overrides.pop("beam_size", 40))
    # length bonus (reference beam-search "penalty" weight,
    # LRS/video/lightning.py:261-266; 0.0 in the published configs)
    penalty = float(overrides.pop("penalty", 0.0))
    # beam_batched: "max" (default) pads every bucket to the largest eval
    # bucket (one decode length for the whole test set); "bucket" pads each
    # batch to its own bucket
    decode_pad = str(overrides.pop("decode_pad", "max"))
    lm_ckpt = overrides.pop("lm_ckpt", None)
    lm_weight = float(overrides.pop("lm_weight", 0.0))
    # lm_kind=transformer|rnn (espnet TransformerLM / RNNLM scorers)
    lm_kind = str(overrides.pop("lm_kind", "transformer"))
    # LM shape defaults per kind: transformer follows the reference
    # lrs3.yaml language_model (16L, att 512, 8 heads, unit 2048, embed 128);
    # rnn follows espnet lm/default.py's RNNLM defaults (2 layers x 650 units,
    # embedding = unit width). Override with lm_layers=/lm_dim=/...
    lm_defaults = (
        (("layers", 2), ("dim", 650), ("heads", 1),
         ("hidden", 650), ("embed_dim", 650)) if lm_kind == "rnn" else
        (("layers", 16), ("dim", 512), ("heads", 8),
         ("hidden", 2048), ("embed_dim", 128)))
    lm_shape = {k: int(overrides.pop(f"lm_{k}", d)) for k, d in lm_defaults}
    # espnet BeamSearch length-ratio knobs (beam_search.py:330-360);
    # the published configs use 0.0/0.0
    maxlenratio = float(overrides.pop("maxlenratio", 0.0))
    minlenratio = float(overrides.pop("minlenratio", 0.0))
    config = (PRESETS[preset]() if preset else Config()).override(**overrides)
    split = config.data.split or "test"
    dev, started = init_distributed(config, device)
    try:
        return _evaluate(config, split, dev, ckpt_path, decode_mode, beam_size, penalty,
                         decode_pad, lm_ckpt, lm_weight, lm_kind, lm_shape, maxlenratio,
                         minlenratio)
    finally:
        if started:
            dist.destroy_process_group()


def _evaluate(config: Config, split: str, dev: torch.device, ckpt_path, decode_mode,
              beam_size, penalty, decode_pad, lm_ckpt, lm_weight, lm_kind, lm_shape,
              maxlenratio, minlenratio) -> Dict[str, Any]:
    mesh = eval_mesh(config, dev)
    lead = mesh.rank == 0
    model = build_model(config, device=dev)
    # the weights stay whole on every rank (the JAX driver's ``_eval_mesh``:
    # replicated); the rows split over the data axis
    _, eval_loader = build_loaders(config, eval_split=split,
                                   process_index=mesh.data_index if mesh.size > 1 else 0,
                                   process_count=mesh.data)
    eval_transform, _ = transforms(config)
    example = eval_transform(to_device(next(iter(eval_loader)), dev))
    state = create_train_state(config, model, example, device=dev)
    if ckpt_path:
        payload = ckpt.load_msgpack(ckpt_path)
        ckpt.load_params(model, payload.get("params", payload),
                         payload.get("batch_stats"))

    if config.model.task == "word":
        eval_step = build_eval_step(mesh)
        meter = AverageMeter()
        for batch in eval_loader:
            # exact accuracy over every test clip: the loader repeat-pads the
            # tail batch and marks real rows in sample_weight; the model
            # computes weighted means, the step returns the real count and
            # the slot denominators for cross-batch aggregation, all of the
            # global batch (the same on every rank)
            m = host_metrics(eval_step(state, eval_transform(to_device(batch, dev))))
            m, w = split_eval_weights(m)
            meter.update(m, weight=w)
        summary = meter.summary(f"{split}/")
        if lead:
            print(json.dumps(summary))
        return summary

    # sentence-level: WER
    from syncvsr_tpu_torch.data.tokenizer import build_text_transform

    model.eval()
    tt = build_text_transform(config.data.spm_vocab)
    records = []   # ((batch, row), record) of this rank's rows

    def record(key, ref, hyp, score=None):
        records.append((key, {"ref": ref, "hyp": hyp,
                              **({"score": score} if score is not None else {})}))

    lm = None
    if lm_ckpt and lm_weight != 0.0:
        lm = load_lm(lm_ckpt, lm_kind, config.model.labels, lm_shape, dev)
    bs_config = BeamSearchConfig(beam_size=beam_size, ctc_weight=config.model.mtlalpha,
                                 lm_weight=lm_weight, penalty=penalty,
                                 maxlenratio=maxlenratio, minlenratio=minlenratio)

    if decode_mode == "beam":
        decode = make_beam_decoder(model, bs_config, lm=lm)
        for k, batch in enumerate(eval_loader):
            batch = eval_transform(to_device(batch, dev))
            for i in _valid_rows(batch):
                toks, n, score = decode(batch["videos"][i:i + 1], batch["lengths"][i])
                hyp = tt.post_process(toks[: int(n)].cpu().numpy())
                ref = tt.post_process(batch["labels"][i].cpu().numpy())
                record((k, i), ref, hyp, float(score))
    elif decode_mode == "beam_batched":
        from syncvsr_tpu_torch.data.lrs import bucket_for_length

        t_max = bucket_for_length(config.data.max_frames_val, config.data.length_buckets)
        decoders = {}
        for k, batch in enumerate(eval_loader):
            batch = eval_transform(to_device(batch, dev))
            v = batch["videos"]
            audio_mode = v.dim() == 2  # waveform [B, S]: 640 samples/frame
            tf = v.shape[1] // 640 if audio_mode else v.shape[1]
            if decode_pad == "max":
                tf = t_max
            want = tf * 640 if audio_mode else tf
            if v.shape[1] < want:
                pad = torch.zeros((v.shape[0], want - v.shape[1]) + tuple(v.shape[2:]),
                                  dtype=v.dtype, device=v.device)
                v = torch.cat([v, pad], 1)
            if tf not in decoders:
                decoders[tf] = make_batched_beam_decoder(model, bs_config, max_len=tf, lm=lm)
            toks, ns, scores = decoders[tf](v, batch["lengths"])
            toks, ns, scores = toks.cpu().numpy(), ns.cpu().numpy(), scores.cpu().numpy()
            for i in _valid_rows(batch):
                hyp = tt.post_process(toks[i][: int(ns[i])])
                ref = tt.post_process(batch["labels"][i].cpu().numpy())
                record((k, i), ref, hyp, float(scores[i]))
    elif decode_mode == "align":
        # CTC forced alignment of the ground-truth transcripts (the
        # reference CTC class's forced_align, espnet ctc.py:181-245): per
        # utterance, the frame-level token ids and [token, start, end)
        # segments
        align = make_forced_aligner(model)
        for k, batch in enumerate(eval_loader):
            batch = eval_transform(to_device(batch, dev))
            al = align(batch["videos"], batch["lengths"], batch["labels"]).cpu().numpy()
            for i in _valid_rows(batch):
                frames = al[i][al[i] >= 0]
                records.append(((k, i), {
                    "ref": tt.post_process(batch["labels"][i].cpu().numpy()),
                    "alignment": frames.tolist(),
                    "segments": [[tt.post_process(np.asarray([tok])), a, b]
                                 for tok, a, b in _segments(frames.tolist())]}))
    elif decode_mode == "greedy":
        decode = make_greedy_ctc_decoder(model)
        for k, batch in enumerate(eval_loader):
            batch = eval_transform(to_device(batch, dev))
            toks, lens = decode(batch["videos"], batch["lengths"])
            toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
            for i in _valid_rows(batch):
                hyp = tt.post_process(toks[i][: int(lens[i])])
                ref = tt.post_process(batch["labels"][i].cpu().numpy())
                record((k, i), ref, hyp)
    else:
        raise ValueError(f"decode={decode_mode!r}: expected beam, beam_batched, greedy "
                         "or align")
    hyp_records = gather_records(records, mesh)
    if not lead:
        return {}
    wer = WordErrorRate()
    if decode_mode != "align":
        for r in hyp_records:
            wer.update(r["ref"], r["hyp"])
    # per-utterance hypothesis dump (asr_utils.add_results_to_json role)
    with open("hypotheses.jsonl", "w") as f:
        for r in hyp_records:
            f.write(json.dumps(r) + "\n")
    if decode_mode == "align":
        summary = {f"{split}/aligned_utts": len(hyp_records),
                   "hypotheses": "hypotheses.jsonl"}
    else:
        summary = {f"{split}/wer": wer.wer,
                   f"{split}/edit_distance": wer.total_edit_distance,
                   f"{split}/words": wer.total_length,
                   "hypotheses": "hypotheses.jsonl"}
    if decode_mode == "beam_batched":
        summary["decode_compiles"] = len(decoders)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
