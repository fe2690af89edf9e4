"""PyTorch port: the train and evaluate CLIs reading datasets from files, on
the CPU (``device="cpu"``): a tiny ``lrs3`` model trained from a packed
synthetic LRS3 tree (``syncvsr_tpu_torch/data/synthetic_tree.py``, packed by
the port's ``tools/pack_dataset.py``) with ``model.remat``,
``optim.accum_steps=2`` and ``optim.skip_nonfinite`` over the
``max_batch_frames`` bucket schedule, its checkpoint in the JAX package's
wrapped layout, then greedy-CTC ``evaluate`` of the test split; and a tiny
``lrw_landmark`` model trained and evaluated from ``.npy`` clips."""

import json
import os

import numpy as np
import pytest

from syncvsr_tpu_torch import evaluate as tevaluate
from syncvsr_tpu_torch import train as ttrain
from syncvsr_tpu_torch.data.synthetic_tree import write_landmark_tree, write_lrs_tree
from syncvsr_tpu_torch.tools import pack_dataset
from syncvsr_tpu_torch.utils import checkpoint as tckpt
import torch_threads  # noqa: F401  (one torch thread a test process)

pytest.importorskip("cv2")

SENTENCE = [
    "preset=lrs3", 'data.dataset="lrs3"', "model.encoder.layers=1", "model.encoder.dim=16",
    "model.encoder.heads=2", "model.encoder.conv_kernel=7", "model.decoder.layers=1",
    "model.decoder.dim=16", "model.decoder.heads=2", "model.decoder.hidden=32",
    "model.frontend.resnet_width=8", "model.codec.audio_vocab_size=11",
    'model.dtype="float32"', "data.crop_size=16", "data.length_buckets=[8,16,32]",
    "data.max_frames=32", "data.max_frames_val=32", "data.batch_size=4",
    "data.eval_batch_size=4", "data.max_label_len=24", "data.num_workers=2"]


def _records(ckpt_dir):
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train/launches/sync_ce_fwd" in r]


def test_lrs3_from_a_packed_tree_with_remat_and_accumulation(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    write_lrs_tree(root, "LRS3", {"train": [5, 7, 3, 12, 16, 9, 14, 20, 31, 25, 40, 6, 26],
                                  "val": [6, 11], "test": [4, 9, 30, 13, 7]},
                   seed=4, size=20, vocab=11)
    packed = str(tmp_path / "packed")
    pack_dataset.main([root, packed, "--task", "sentence", "--dataset", "LRS3",
                       "--splits", "train", "val", "test"])
    ckpt_dir = str(tmp_path / "ckpt")
    final = ttrain.main(SENTENCE + [
        f"data.root={json.dumps(packed)}", "data.packed=true", "data.max_batch_frames=32",
        "model.remat=true", "optim.accum_steps=2", "optim.skip_nonfinite=true",
        "optim.total_steps=0", "train.epochs=1", "train.log_every=1", "train.eval_every=100",
        "train.ckpt_every=100", f"train.ckpt_dir={json.dumps(ckpt_dir)}"], device="cpu")
    assert np.isfinite(final["val/loss"])
    records = _records(ckpt_dir)
    # buckets of 8, 16 and 32 frames at 4, 2 and 1 clips: 1 + 2 + 5 batches
    assert [r["step"] for r in records] == list(range(1, 9))
    assert all(np.isfinite(r["train/loss"]) for r in records[1:])
    payload = tckpt.load_msgpack(os.path.join(ckpt_dir, "step_8.msgpack"))
    opt = payload["opt_state"]
    assert int(opt["mini_step"]) == 0 and int(opt["gradient_step"]) == 4
    assert int(opt["inner_opt_state"]["inner_state"]["count"]) == 4
    assert bool(opt["inner_opt_state"]["last_finite"])

    capsys.readouterr()
    res = tevaluate.main(SENTENCE + [
        f"data.root={json.dumps(packed)}", "data.packed=true", 'data.split="test"',
        "decode=greedy", f"ckpt={json.dumps(os.path.join(ckpt_dir, 'step_8.msgpack'))}"],
        device="cpu")
    assert np.isfinite(res["test/wer"]) and res["test/words"] > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res
    assert len(open(tmp_path / "hypotheses.jsonl").read().splitlines()) == 5


def test_lrw_landmark_from_npy_files(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    root = write_landmark_tree(str(tmp_path / "LRW"), ("ABOUT", "WORLD", "THERE"),
                               ("train", "val", "test"), n=4, seed=3)
    args = ["preset=lrw_landmark", 'data.dataset="lrw_landmark"', f"data.root={json.dumps(root)}",
            "model.encoder.layers=1", "model.encoder.dim=32", "model.encoder.heads=2",
            "model.labels=3", "model.codec.audio_vocab_size=17", 'model.dtype="float32"',
            "data.batch_size=4", "data.eval_batch_size=5", "data.num_workers=2"]
    ckpt_dir = str(tmp_path / "ckpt")
    final = ttrain.main(args + ["optim.total_steps=0", "train.epochs=2", "train.log_every=1",
                                "train.eval_every=3", "train.ckpt_every=100",
                                f"train.ckpt_dir={json.dumps(ckpt_dir)}"], device="cpu")
    assert np.isfinite(final["val/loss"]) and 0.0 <= final["val/acc1"] <= 1.0
    assert [r["step"] for r in _records(ckpt_dir)] == list(range(1, 7))
    res = tevaluate.main(args + [f"ckpt={json.dumps(os.path.join(ckpt_dir, 'best.msgpack'))}"],
                         device="cpu")
    assert np.isfinite(res["test/acc1"]) and np.isfinite(res["test/acc5"])
