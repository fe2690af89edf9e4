"""PyTorch port: the LRW loaders and the host-side utilities the drivers
use, against the JAX package's, on the CPU: the LRW video, DC-TCN and packed
datasets on a pkl tree written here (cv2 JPEGs, torch-saved pkls), the
loader's sharding and repeat-padded tail, the factory, the csv
``load_durations``, the batch JPEG decoder, the metric meter and logger, and
the step timer. Each copied module is held equal to its original: the same
samples, batches and numbers from the same inputs (exactly: these are
integer and copy paths), and the native source byte for byte."""

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from syncvsr_tpu import config as jcfg
from syncvsr_tpu.data import factory as jfactory
from syncvsr_tpu.data import jpeg as jjpeg
from syncvsr_tpu.data import loader as jloader
from syncvsr_tpu.data import lrw as jlrw
from syncvsr_tpu.data import packed as jpacked
from syncvsr_tpu.utils import metrics as jmetrics
from syncvsr_tpu.utils import profiling as jprofiling
from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.data import factory as tfactory
from syncvsr_tpu_torch.data import jpeg as tjpeg
from syncvsr_tpu_torch.data import loader as tloader
from syncvsr_tpu_torch.data import lrw as tlrw
from syncvsr_tpu_torch.data import packed as tpacked
from syncvsr_tpu_torch.utils import metrics as tmetrics
from syncvsr_tpu_torch.utils import profiling as tprofiling
from tests.conftest import make_lrw_tree
import torch_threads  # noqa: F401  (one torch thread a test process)

cv2 = pytest.importorskip("cv2")
REPO = Path(__file__).resolve().parents[1]


def assert_same(got, want, what=""):
    """Equal sample dicts or batches: the same keys, each value of the same
    dtype and shape and equal."""
    assert set(got) == set(want), what
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} {k}"
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two LRW pkl trees (3 clips a word and split): tokens in the video
    pkls, and tokens in a parallel released-token tree."""
    base = tmp_path_factory.mktemp("lrw")
    root = make_lrw_tree(base / "LRW", n=3)
    split_root = make_lrw_tree(base / "LRW_split", n=3, token_root=base / "tokens", seed=1)
    return str(root), str(split_root), str(base / "tokens")


def test_copied_sources_are_equal():
    port = REPO / "syncvsr_tpu_torch" / "native" / "jpeg_batch.cpp"
    assert port.read_bytes() == (REPO / "syncvsr_tpu" / "native" / "jpeg_batch.cpp").read_bytes()


def test_load_durations_matches_pandas(tree):
    path = os.path.join(tree[0], "durations.csv")
    df, got = jlrw.load_durations(path), tlrw.load_durations(path)
    assert sorted(got) == sorted(df.index)
    for name, length in got.items():
        assert type(length) is int and length == int(df.loc[name].length)


def test_discover_and_glob_match(tree):
    root = tree[0]
    assert tlrw.discover_labels(root) == jlrw.discover_labels(root) == ["ABOUT", "WORLD"]
    for split in ("train", "val"):
        assert tlrw.glob_lrw_files(root, split) == jlrw.glob_lrw_files(root, split)


@pytest.mark.parametrize("tokens", ["embedded", "released"])
def test_lrw_video_dataset_matches_jax(tree, tokens):
    root, split_root, token_root = tree
    if tokens == "released":
        root, audio_root = split_root, token_root
    else:
        audio_root = None
    labels = jlrw.discover_labels(root)
    files = jlrw.glob_lrw_files(root, "train")
    path = os.path.join(root, "durations.csv")
    jds = jlrw.LRWVideoDataset(files, labels, audio_root=audio_root,
                               durations_df=jlrw.load_durations(path))
    tds = tlrw.LRWVideoDataset(files, labels, audio_root=audio_root,
                               durations=tlrw.load_durations(path))
    assert len(tds) == len(jds) == 6
    for i in range(len(jds)):
        assert_same(tds[i], jds[i], f"sample {i}")
    assert tds[0]["inputs"].shape == (29, 24, 28, 1) and tds[0]["word_mask"].sum() == 11


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_dctcn_dataset_matches_jax(tree, train):
    """The DC-TCN wrapper's mask/trim augmentations: the same draws for
    each (index, visit), so two visits of each sample match too."""
    root = tree[0]
    labels = jlrw.discover_labels(root)
    files = jlrw.glob_lrw_files(root, "train")
    path = os.path.join(root, "durations.csv")
    jds = jlrw.DCTCNDataset(jlrw.LRWVideoDataset(
        files, labels, durations_df=jlrw.load_durations(path)), train=train, seed=3)
    tds = tlrw.DCTCNDataset(tlrw.LRWVideoDataset(
        files, labels, durations=tlrw.load_durations(path)), train=train, seed=3)
    for visit in range(2):
        for i in range(len(jds)):
            assert_same(tds[i], jds[i], f"visit {visit} sample {i}")
    assert "attention_mask" in tds[0]


def test_packed_split_matches_jax(tree, tmp_path):
    """pack_lrw_split writes the JAX package's files byte for byte (the
    blob) and array for array (the index); the packed readers give the pkl
    readers' samples; a codec mismatch fails in both."""
    root = tree[0]
    path = os.path.join(root, "durations.csv")
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    for split in ("train", "val"):
        jpacked.pack_lrw_split(root, split, out_j, durations_df=jlrw.load_durations(path))
        tpacked.pack_lrw_split(root, split, out_t, durations=tlrw.load_durations(path))
        assert (Path(out_t) / f"{split}.bin").read_bytes() == \
            (Path(out_j) / f"{split}.bin").read_bytes()
        ij, it = np.load(Path(out_j) / f"{split}.npz"), np.load(Path(out_t) / f"{split}.npz")
        assert sorted(it.files) == sorted(ij.files)
        for k in ij.files:
            np.testing.assert_array_equal(it[k], ij[k], err_msg=k)
    jds, tds = jpacked.PackedLRWDataset(out_j, "train"), tpacked.PackedLRWDataset(out_t, "train")
    ref = tlrw.LRWVideoDataset(tlrw.glob_lrw_files(root, "train"), tlrw.discover_labels(root),
                               durations=tlrw.load_durations(path))
    assert tds.label_names == jds.label_names == ref.labels
    for i in range(len(jds)):
        assert_same(tds[i], jds[i], f"packed sample {i}")
        assert_same(tds[i], ref[i], f"packed vs pkl sample {i}")
    for mod, out in ((jpacked, out_j), (tpacked, out_t)):
        with pytest.raises(ValueError, match="wav2vec2"):
            mod.PackedLRWDataset(out, "train", codec="wav2vec2")


def _batches(loader):
    return [dict(b) for b in loader]


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)], ids=["one", "p0of2", "p1of2"])
def test_loader_matches_jax(tree, shard):
    """Train (shuffled, tail dropped) and eval (tail repeat-padded with
    sample_weight 0) batches of each process's strided shard, two epochs."""
    root = tree[0]
    files = jlrw.glob_lrw_files(root, "val")
    labels = jlrw.discover_labels(root)
    ds = tlrw.LRWVideoDataset(files, labels)
    collate = tloader.pad_word_collate(29, 120, 2)
    pi, pc = shard
    for kw in ({"shuffle": True, "drop_last": True},
               {"shuffle": False, "drop_last": False, "pad_last": True}):
        jl = jloader.DataLoader(ds, 4, seed=5, collate=jloader.pad_word_collate(29, 120, 2),
                                num_threads=2,
                                process_index=pi, process_count=pc, **kw)
        tl = tloader.DataLoader(ds, 4, seed=5, collate=collate, num_threads=2,
                                process_index=pi, process_count=pc, **kw)
        assert len(tl) == len(jl)
        for epoch in range(2):
            got, want = _batches(tl), _batches(jl)
            assert len(got) == len(want) > 0
            for b, (g, w) in enumerate(zip(got, want)):
                assert_same(g, w, f"{kw} epoch {epoch} batch {b}")
    # the padded tail: 6 clips over batches of 4 -> 2 real rows, 2 of weight 0
    tail = _batches(tloader.DataLoader(ds, 4, shuffle=False, collate=collate,
                                       drop_last=False, pad_last=True))[-1]
    np.testing.assert_array_equal(tail["sample_weight"], [1, 1, 0, 0])
    with pytest.raises(ValueError, match="divide"):
        tloader.DataLoader(ds, 3, process_count=2)


def _lrw_configs(root, **over):
    o = {"data.dataset": "lrw", "data.root": root, "data.batch_size": 4,
         "data.eval_batch_size": 4, "model.codec.audio_vocab_size": 13, **over}
    return jcfg.lrw_video_config().override(**o), tcfg.lrw_video_config().override(**o)


@pytest.mark.parametrize("encoder", ["transformer", "dense_tcn"])
def test_build_loaders_matches_jax(tree, encoder):
    """The factory's LRW loaders (word boundary from durations.csv; the
    DC-TCN's data contract for a TCN encoder): every train and eval batch."""
    cfg_j, cfg_t = _lrw_configs(tree[0], **{"model.encoder.kind": encoder})
    for jl, tl in zip(jfactory.build_loaders(cfg_j), tfactory.build_loaders(cfg_t)):
        got, want = _batches(tl), _batches(jl)
        assert len(got) == len(want) > 0
        for b, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"batch {b}")
    assert ("attention_mask" in got[0]) == (encoder == "dense_tcn")
    assert "word_mask" in got[0] and "sample_weight" in got[0]


def test_build_loaders_packed_and_lrw1000_match_jax(tree, tmp_path):
    """data.packed=true reads the packed split; the lrw1000 preset (no word
    boundary) reads the pkl tree without durations."""
    root = tree[0]
    for split in ("train", "val"):
        jpacked.pack_lrw_split(root, split, str(tmp_path),
                               durations_df=jlrw.load_durations(f"{root}/durations.csv"))
    cfg_j, cfg_t = _lrw_configs(str(tmp_path), **{"data.packed": True})
    o = {"data.root": root, "data.batch_size": 4, "data.eval_batch_size": 4,
         "model.codec.name": "vq", "model.codec.audio_alignment": 4,
         "model.codec.audio_vocab_size": 13, "data.num_frames": 29}
    pairs = [(cfg_j, cfg_t), (jcfg.lrw1000_config().override(**o),
                              tcfg.lrw1000_config().override(**o))]
    for cj, ct in pairs:
        for jl, tl in zip(jfactory.build_loaders(cj), tfactory.build_loaders(ct)):
            for b, (g, w) in enumerate(zip(_batches(tl), _batches(jl))):
                assert_same(g, w, f"{ct.data.dataset} batch {b}")
    assert "word_mask" not in g


def test_synthetic_loader_matches_jax():
    o = {"model.encoder.layers": 1, "data.batch_size": 2, "data.crop_size": 8,
         "data.num_frames": 3}
    for make in ("lrw_video_config", "lrs3_config"):
        cj = getattr(jcfg, make)().override(**o)
        ct = getattr(tcfg, make)().override(**o)
        for jl, tl in zip(jfactory.build_loaders(cj), tfactory.build_loaders(ct)):
            assert len(tl) == len(jl)
            for g, w in zip(tl, jl):
                assert_same(g, w, make)


@pytest.mark.parametrize("dataset", ["lrs3", "lrs2", "vox2", "lrw_landmark"])
def test_loaders_still_to_port_raise(dataset, tmp_path):
    """No loader is left to port: over an empty tree each of these datasets
    gets the JAX package's loaders (the same kinds and lengths, no batch);
    an unknown name still raises."""
    o = {"data.dataset": dataset, "data.root": str(tmp_path), "data.length_distribution": ""}
    cfg = tcfg.lrs3_config().override(**o)
    got, want = tfactory.build_loaders(cfg), jfactory.build_loaders(
        jcfg.lrs3_config().override(**o))
    for g, w in zip(got, want, strict=True):
        assert type(g).__name__ == type(w).__name__ and len(g) == len(w)
        assert list(g) == list(w) == []
    with pytest.raises(ValueError, match="unknown dataset"):
        tfactory.build_loaders(cfg.override(**{"data.dataset": "nope"}))


def _jpegs(rng, n, size):
    return [cv2.imencode(".jpg", rng.randint(0, 256, size, np.uint8))[1].tobytes()
            for _ in range(n)]


def test_jpeg_decode_matches_jax():
    """The native decoder against the JAX package's: same size, and frames
    padded and cropped to another size, and the SOF parser."""
    rng = np.random.RandomState(0)
    frames = _jpegs(rng, 5, (20, 24))
    assert tjpeg.native_available()
    for hw in ((None, None), (24, 28), (16, 20)):
        got = tjpeg.decode_gray_batch(frames, *hw)
        want = jjpeg.decode_gray_batch(frames, *hw)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert tjpeg.jpeg_dimensions(frames[0]) == jjpeg.jpeg_dimensions(frames[0]) == (20, 24)
    with pytest.raises(ValueError, match="empty"):
        tjpeg.decode_gray_batch([])


def test_jpeg_without_a_decoder_raises(monkeypatch):
    """No native decoder: cv2 decodes the same frames; without cv2 too the
    call raises naming both, and never returns blank frames."""
    rng = np.random.RandomState(1)
    frames = _jpegs(rng, 3, (12, 16))
    want = tjpeg.decode_gray_batch(frames)
    monkeypatch.setattr(tjpeg, "_lib", None)
    monkeypatch.setattr(tjpeg, "_why_not", "the native decoder is unavailable (test)")
    np.testing.assert_array_equal(tjpeg.decode_gray_batch(frames), want)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="no JPEG decoder.*unavailable.*cv2"):
        tjpeg.decode_gray_batch(frames)


def test_jpeg_build_failure_is_recorded(monkeypatch, tmp_path):
    """A source that does not compile leaves the decoder unavailable, with
    g++'s reason."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tjpeg, "_SRC", bad)
    monkeypatch.setattr(tjpeg, "_BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(tjpeg, "_lib", None)
    monkeypatch.setattr(tjpeg, "_why_not", None)
    assert not tjpeg.native_available()
    assert "g++ failed" in tjpeg._why_not


def test_average_meter_and_eval_weights_match_jax():
    """Weighted means with per-key denominators, latest-value keys, and the
    eval step's _weight/_tokens/_slots split."""
    steps = [{"loss": 2.0, "acc1": 0.5, "decoder_acc": 0.25, "loss_audio": 3.0,
              "learning_rate": 1e-3, "_weight": 3.0, "_tokens": 10.0, "_slots": 40.0},
             {"loss": 1.0, "acc1": 1.0, "decoder_acc": 0.75, "loss_audio": 1.0,
              "learning_rate": 2e-3, "_weight": 1.0, "_tokens": 30.0, "_slots": 8.0}]
    out = []
    for mod in (jmetrics, tmetrics):
        meter = mod.AverageMeter()
        for m in steps:
            vals, w = mod.split_eval_weights(m)
            meter.update(vals, weight=w)
        out.append(meter.summary("val/"))
    assert out[1] == out[0]
    assert out[1]["val/decoder_acc"] == pytest.approx((0.25 * 10 + 0.75 * 30) / 40)
    assert out[1]["val/learning_rate"] == 2e-3


def test_metric_logger_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 123.0)
    for mod, name in ((jmetrics, "jax"), (tmetrics, "port")):
        logger = mod.MetricLogger(path=str(tmp_path / f"{name}.jsonl"))
        logger.log({"train/loss": 1.5}, 3)
        logger.log({"val/acc1": 0.25}, 4)
        logger.close()
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()
    assert json.loads((tmp_path / "port.jsonl").read_text().splitlines()[0]) == \
        {"step": 3, "time": 123.0, "train/loss": 1.5}
    # train.wandb=true without the package raises (the JAX copy turns W&B off)
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError):
        tmetrics.MetricLogger(use_wandb=True)


def test_step_timer_matches_jax_on_the_host(monkeypatch):
    """On the CPU the port's timer is the JAX one: the host clock, warm-up
    steps left out, then an EMA."""
    timers = (jprofiling.StepTimer(warmup=1), tprofiling.StepTimer(warmup=1))
    for t in timers:
        ticks = iter(np.cumsum([0, 5, 1, 7, 2, 3]) * 1e-3)
        monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
        for _ in range(3):
            with t:
                pass
    assert timers[1].count == timers[0].count == 3
    assert timers[1].avg_ms == pytest.approx(timers[0].avg_ms)
    assert timers[1].steps_per_sec == pytest.approx(timers[0].steps_per_sec)
    assert not tprofiling.StepTimer(device=torch.device("cpu")).cuda


def test_bucket_for_length_matches_jax():
    from syncvsr_tpu.data.lrs import bucket_for_length as jb
    from syncvsr_tpu_torch.data.lrs import bucket_for_length as tb

    buckets = (160, 320, 640, 1200, 1800)
    for n in (1, 160, 161, 500, 1800, 5000):
        assert tb(n, buckets) == jb(n, buckets)
