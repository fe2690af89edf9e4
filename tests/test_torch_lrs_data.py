"""PyTorch port: the sentence-level loaders against the JAX package's, on
the CPU, on one synthetic tree (``syncvsr_tpu_torch/data/synthetic_tree.py``:
JPEG frames, a PCM ``audio`` field, per-word timestamps, unigram-5000
transcripts). ``LRSBucketLoader`` batches bitwise equal to
``syncvsr_tpu.data.factory.LRSBucketLoader``'s over two epochs: pkl and
packed trees, video and waveforms (with babble noise), ``vox2``'s
length-distribution windowing, the ``max_batch_frames`` schedule, the eval
loader's repeat-padded tails with ``sample_weight``, and the strided slice
of each of two processes. The copied numpy modules (``data/audio.py``, the
length index, ``BucketBatcher``) and the pack and index tools write and
compute what the JAX package's do."""

import os

import jax
import numpy as np
import pytest

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.data import audio as jaudio
from syncvsr_tpu.data import factory as jfactory
from syncvsr_tpu.data import lrs as jlrs
from syncvsr_tpu.data.packed_lrs import pack_lrs_split as jpack
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.data import audio as taudio
from syncvsr_tpu_torch.data import factory as tfactory
from syncvsr_tpu_torch.data import lrs as tlrs
from syncvsr_tpu_torch.data.synthetic_tree import write_lrs_tree
from syncvsr_tpu_torch.tools import index_lengths, pack_dataset
from test_torch_data import assert_same
import torch_threads  # noqa: F401  (one torch thread a test process)

pytest.importorskip("cv2")
# clip lengths (frames) over buckets of 8, 16 and 32 frames, two past
# max_frames = 32 (windowed)
TRAIN = [5, 7, 8, 3, 12, 16, 9, 14, 20, 31, 25, 32, 40, 6, 11, 50, 28, 2]
VAL = [4, 9, 30, 13, 6]
BASE = {"data.length_buckets": (8, 16, 32), "data.max_frames": 32,
        "data.max_frames_val": 24, "data.batch_size": 4, "data.eval_batch_size": 3,
        "data.max_label_len": 12, "data.num_workers": 2}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The LRS3 and VOX2 pkl trees (12x12 frames), their packs by each
    package, a length histogram and a noise clip."""
    base = tmp_path_factory.mktemp("lrs")
    root = str(base / "data")
    for name in ("LRS3", "VOX2"):
        write_lrs_tree(root, name, {"train": TRAIN, "val": VAL}, seed=2, size=12)
    np.save(os.path.join(root, "video_length.npy"), np.array([6, 10, 14, 20], np.int64))
    np.save(os.path.join(root, "noise.npy"),
            np.random.RandomState(5).randn(64 * 640).astype(np.float32))
    packed = {}
    for who in ("jax", "port"):
        out = str(base / f"packed_{who}")
        for split in ("train", "val"):
            if who == "jax":
                jpack(root, "LRS3", split, os.path.join(out, "LRS3"))
            else:
                pack_dataset.main([root, out, "--task", "sentence", "--dataset", "lrs3",
                                   "--splits", split])
        packed[who] = out
    return root, packed


def _configs(root, preset="lrs3_config", **over):
    o = dict(BASE, **{"data.root": root,
                      "data.dataset": "vox2" if preset == "vox2_config" else "lrs3"}, **over)
    return getattr(jcfg, preset)().override(**o), getattr(tcfg, preset)().override(**o)


def _compare_loaders(cfg_j, cfg_t, epochs=2, procs=(0, 1), monkeypatch=None, root_t=None):
    """Both packages' (train, eval) loaders over ``epochs`` epochs, every
    batch bitwise; the port's as process ``procs[0]`` of ``procs[1]``
    (the JAX package's through patched ``jax.process_index``/``count``).
    Returns the bucket lengths of the train batches."""
    if procs != (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda: procs[0])
        monkeypatch.setattr(jax, "process_count", lambda: procs[1])
    if root_t is not None:
        cfg_t = cfg_t.override(**{"data.root": root_t})
    buckets = []
    for name, jl, tl in zip(("train", "eval"), jfactory.build_loaders(cfg_j),
                            tfactory.build_loaders(cfg_t, "", *procs)):
        assert len(tl) == len(jl)
        for epoch in range(epochs):
            got, want = list(tl), list(jl)
            assert len(got) == len(want) > 0, (name, epoch)
            for i, (g, w) in enumerate(zip(got, want)):
                assert_same(g, w, f"{name} epoch {epoch} batch {i}")
                if name == "train":   # in frames (640 samples each for waveforms)
                    buckets.append(g["audio_tokens"].shape[1] // 4)
    return buckets


@pytest.mark.parametrize("packed", [False, True], ids=["pkl", "packed"])
@pytest.mark.parametrize("modality", ["video", "audio"])
def test_lrs_loader_matches_jax(tree, packed, modality):
    """pkl and packed trees, video frames and waveforms (babble noise at a
    random SNR in training, clean in eval), the max_batch_frames budget:
    batches of 4, 2 and 1 clips over the three buckets."""
    root, packs = tree
    over = {"data.max_batch_frames": 32}
    if modality == "audio":
        over.update({"data.modality": "audio",
                     "data.noise_path": os.path.join(root, "noise.npy")})
    if packed:
        over["data.packed"] = True
        cfg_j, cfg_t = _configs(packs["jax"], **over)
        buckets = _compare_loaders(cfg_j, cfg_t, root_t=packs["port"])
    else:
        cfg_j, cfg_t = _configs(root, **over)
        buckets = _compare_loaders(cfg_j, cfg_t)
    assert set(buckets) == {8, 16, 32}


def test_vox2_windowing_matches_jax(tree):
    """vox2's windows: lengths drawn from the histogram per (epoch, clip),
    the transcript re-selected from the word timestamps."""
    root, _ = tree
    cfg_j, cfg_t = _configs(root, "vox2_config")
    _compare_loaders(cfg_j, cfg_t, epochs=3)
    loader = tfactory.LRSBucketLoader(cfg_t, "train", True)
    assert loader.ds.length_distribution is not None and any(
        loader.ds.plan_window(i, int(t))[1] != t for i, t in enumerate(loader.lengths))


def test_strided_slice_of_two_processes_matches_jax(tree, monkeypatch):
    """Process 1 of 2: every global batch's odd rows; the budget then gives
    each process half of the global bucket batch."""
    root, _ = tree
    cfg_j, cfg_t = _configs(root, **{"data.max_batch_frames": 64})
    _compare_loaders(cfg_j, cfg_t, epochs=1, procs=(1, 2), monkeypatch=monkeypatch)
    with pytest.raises(ValueError, match="global"):
        next(iter(tfactory.LRSBucketLoader(cfg_t.override(**{"data.max_batch_frames": 40}),
                                           "train", True, 1, 2)))


def test_eval_tails_are_weighted(tree):
    """The eval loader keeps every clip once: repeat-padded tails carry
    sample_weight 0, and the real rows count the split."""
    root, _ = tree
    _, cfg_t = _configs(root)
    _, ev = tfactory.build_loaders(cfg_t)
    batches = list(ev)
    assert sum(float(b["sample_weight"].sum()) for b in batches) == len(VAL)
    assert any(float(b["sample_weight"].min()) == 0.0 for b in batches)


def test_length_index_and_tools_match_jax(tree, tmp_path):
    """The sidecar length index (lengths and fingerprint) and the pack
    tool's files are the JAX package's."""
    root, packs = tree
    files = tlrs.glob_lrs_files(root, "LRS3", "train")
    assert files == jlrs.glob_lrs_files(root, "LRS3", "train")
    in_order = lambda lengths, fs: [lengths[int(os.path.basename(f)[4:8])] for f in fs]
    assert tlrs._file_fingerprint(files) == jlrs._file_fingerprint(files)
    out = str(tmp_path / "t.lengths.npz")
    np.testing.assert_array_equal(tlrs.build_length_index(files, out, 2),
                                  in_order(TRAIN, files))
    np.testing.assert_array_equal(jlrs.load_length_index(root, "LRS3", "train", files, 2),
                                  in_order(TRAIN, files))
    index_lengths.main(["--root", root, "--dataset", "LRS3", "--splits", "val",
                        "--threads", "2"])
    idx = np.load(tlrs.length_index_path(root, "LRS3", "val"))
    vfiles = tlrs.glob_lrs_files(root, "LRS3", "val")
    assert str(idx["fingerprint"]) == jlrs._file_fingerprint(vfiles)
    np.testing.assert_array_equal(jlrs.load_length_index(root, "LRS3", "val", vfiles),
                                  in_order(VAL, vfiles))
    for split in ("train", "val"):
        for ext in (".bin", ".wav.bin"):
            a, b = (open(os.path.join(packs[w], "LRS3", split + ext), "rb").read()
                    for w in ("jax", "port"))
            assert a == b, split + ext
        a, b = (np.load(os.path.join(packs[w], "LRS3", split + ".npz")) for w in ("jax", "port"))
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_audio_module_matches_jax():
    """pcm_to_float, to_waveform on each payload kind, AddNoise and the
    per-(epoch, clip) AudioTransform in train and eval."""
    rng = np.random.RandomState(0)
    pcm = (rng.randn(2000) * 3000).astype(np.int16)
    for fn in ("pcm_to_float", "to_waveform"):
        np.testing.assert_array_equal(getattr(taudio, fn)(pcm.tobytes()),
                                      getattr(jaudio, fn)(pcm.tobytes()))
    for payload in (pcm, pcm.astype(np.int32), rng.randn(300).astype(np.float64)):
        np.testing.assert_array_equal(taudio.to_waveform(payload), jaudio.to_waveform(payload))
    stereo = (rng.randn(400) * 100).astype(np.int16).tobytes()
    np.testing.assert_array_equal(taudio.pcm_to_float(stereo, 2, 2),
                                  jaudio.pcm_to_float(stereo, 2, 2))
    noise = rng.randn(5000).astype(np.float32)
    wav = rng.randn(1200).astype(np.float32)
    for train in (True, False):
        for snr in (5.0, 999999.0):
            t = taudio.AudioTransform(train, noise, snr_target=snr, seed=3)
            j = jaudio.AudioTransform(train, noise, snr_target=snr, seed=3)
            for index, epoch in ((0, 0), (4, 1), (7, 9)):
                np.testing.assert_array_equal(t(wav, index, epoch), j(wav, index, epoch))
    np.testing.assert_array_equal(taudio.AudioTransform(True)(wav),
                                  jaudio.AudioTransform(True)(wav))
    for snr in (0.0, 20.0):
        np.testing.assert_array_equal(
            taudio.AddNoise(noise)(wav, snr, np.random.RandomState(1)),
            jaudio.AddNoise(noise)(wav, snr, np.random.RandomState(1)))


def test_bucket_batcher_matches_jax():
    """add/flush over a stream of video and waveform samples at a frames
    budget: the same batches, tails repeat-padded."""
    rng = np.random.RandomState(1)
    for audio in (False, True):
        bt = tlrs.BucketBatcher((8, 16, 32), 4, 6, 2, 4, max_batch_frames=40)
        bj = jlrs.BucketBatcher((8, 16, 32), 4, 6, 2, 4, max_batch_frames=40)
        assert bt.bucket_bs == bj.bucket_bs == {8: 4, 16: 2, 32: 1}
        for i in range(15):
            t = int(rng.randint(1, 40))
            s = {"videos": (rng.randn(t * 640).astype(np.float32) if audio
                            else rng.randint(0, 255, (t, 5, 5, 1)).astype(np.uint8)),
                 "labels": rng.randint(1, 9, (rng.randint(1, 9),)).astype(np.int32),
                 "audio_tokens": rng.randint(0, 9, (t * 4, 2)).astype(np.int32),
                 "lengths": np.int32(t * 640 - 3 if audio else t)}
            a, b = bt.add(s), bj.add(s)
            assert (a is None) == (b is None)
            if a is not None:
                assert_same(a, b, f"batch at sample {i}")
        for a, b in zip(bt.flush(), bj.flush(), strict=True):
            assert_same(a, b, "flushed")
