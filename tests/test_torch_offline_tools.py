"""PyTorch port: the offline data tools (``syncvsr_tpu_torch/tools/roi.py``,
``preprocess_lrw.py``, ``prepare_lrs.py``, ``train_spm.py``,
``transcribe.py``) are the port's own copies of the JAX package's, held
equal to the originals on synthetic inputs, as ``tests/test_tools.py`` and
``tests/test_train_spm.py`` test those: the crop geometry, the JPEG
bundles, stage 2 of ``preprocess_lrw`` (the same pkl), the Vox2 route of
``prepare_lrs`` (the same pkls), the unigram trainer (the same ``.model``
and units bytes, from the CLI too); the detectors (mediapipe, ultralytics,
whisperx) are absent here and raise a clear error when called, and a
detector's device is the card unless ``--device cpu`` asks for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from syncvsr_tpu.tools import preprocess_lrw as j_lrw
from syncvsr_tpu.tools import prepare_lrs as j_lrs
from syncvsr_tpu.tools import roi as j_roi
from syncvsr_tpu.tools import train_spm as j_spm
from syncvsr_tpu_torch.tools import preprocess_lrw as t_lrw
from syncvsr_tpu_torch.tools import prepare_lrs as t_lrs
from syncvsr_tpu_torch.tools import roi as t_roi
from syncvsr_tpu_torch.tools import train_spm as t_spm
from syncvsr_tpu_torch.tools import transcribe as t_transcribe
from test_train_spm import _corpus

cv2 = pytest.importorskip("cv2")


def _frames(n, h, w, seed):
    rng = np.random.RandomState(seed)
    base = cv2.GaussianBlur(rng.randint(0, 256, (h, w, 3), np.uint8), (0, 0), 3)
    return [np.clip(base.astype(np.int16) + rng.randint(-20, 20, (h, w, 3)), 0,
                    255).astype(np.uint8) for _ in range(n)]


def _mp4(path, frames):
    h, w = frames[0].shape[:2]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, (w, h))
    for f in frames:
        out.write(f)
    out.release()
    return str(path)


def _same_pkl(a, b):
    da, db = torch.load(a, weights_only=False), torch.load(b, weights_only=False)
    assert sorted(da) == sorted(db)
    for k in da:
        if isinstance(da[k], dict):
            assert sorted(da[k]) == sorted(db[k])
            for kk in da[k]:
                np.testing.assert_array_equal(da[k][kk], db[k][kk])
        else:
            assert da[k] == db[k], k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_roi_geometry_matches_the_original(seed):
    rng = np.random.RandomState(seed)
    lm = (np.full((478, 3), 0.5) + rng.randn(478, 3) * 0.05).astype(np.float32)
    w, h = 256 + 16 * seed, 240
    assert t_roi.lip_bbox_from_landmarks(lm, w, h) == j_roi.lip_bbox_from_landmarks(lm, w, h)
    box = [float(v) for v in rng.randint(-30, 200, 4)]
    assert t_roi.clamp_bbox(box) == j_roi.clamp_bbox(box)
    frame = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    bbox = j_roi.lip_bbox_from_landmarks(lm, w, h)
    np.testing.assert_array_equal(t_roi.crop_fixed(frame, bbox), j_roi.crop_fixed(frame, bbox))
    cx, cy, fh = (float(v) for v in rng.randint(0, 240, 3))
    np.testing.assert_array_equal(t_roi.face_center_crop(frame, cx, cy, fh),
                                  j_roi.face_center_crop(frame, cx, cy, fh))
    np.testing.assert_array_equal(t_roi.vox2_center_crop(frame), j_roi.vox2_center_crop(frame))
    crops = _frames(3, 96, 112, seed)
    assert t_roi.encode_jpeg_frames(crops) == j_roi.encode_jpeg_frames(crops)


def test_roi_bundles_and_resumes_as_the_original(tmp_path):
    jpgs = j_roi.encode_jpeg_frames(_frames(4, 96, 112, 5))
    audio = {"array": np.arange(640, dtype=np.int16), "sample_rate": 16000}
    for mod, name in ((t_roi, "port"), (j_roi, "jax")):
        mod.bundle_pkl(str(tmp_path / name / "a.pkl"), jpgs, audio=audio, text="HI",
                       extra={"k": 1})
    _same_pkl(tmp_path / "port" / "a.pkl", tmp_path / "jax" / "a.pkl")
    srcs = [str(tmp_path / f"{i}.mp4") for i in range(4)]
    done = lambda s: str(tmp_path / "port" / "a.pkl") if s.endswith("1.mp4") else s + ".x"  # noqa: E731
    assert t_roi.pending_files(srcs, ".mp4", done) == j_roi.pending_files(srcs, ".mp4", done)


def test_preprocess_lrw_stage2_writes_the_original_pkl(tmp_path):
    """Stage 2 (landmarks npy -> lip-ROI pkl) of a synthetic clip: the same
    JPEG frames and audio entry as the JAX package's tool."""
    frames = _frames(6, 240, 256, 3)
    src = _mp4(tmp_path / "clip.mp4", frames)
    rng = np.random.RandomState(3)
    lm = (np.full((6, 478, 3), 0.5) + rng.randn(6, 478, 3) * 0.03).astype(np.float32)
    np.save(str(tmp_path / "clip.npy"), lm)
    t_lrw.process_pkl(src, str(tmp_path / "port.pkl"))
    j_lrw.process_pkl(src, str(tmp_path / "jax.pkl"))
    _same_pkl(tmp_path / "port.pkl", tmp_path / "jax.pkl")
    assert len(torch.load(tmp_path / "port.pkl", weights_only=False)["video"]) == 6
    assert len(t_lrw.read_video_frames(src)) == len(j_lrw.read_video_frames(src)) == 6
    with pytest.raises(RuntimeError, match="mediapipe"):
        t_lrw.extract_landmarks(src)


def test_prepare_lrs_vox2_writes_the_original_pkls(tmp_path, monkeypatch):
    """The Vox2 route (a fixed crop, no detector) of the CLI over a tree of
    two clips with transcripts: the same pkls; LRS3's route needs the
    ultralytics detector on the card (or ``--device cpu``)."""
    root = tmp_path / "root" / "id0"
    root.mkdir(parents=True)
    for i in range(2):
        _mp4(root / f"c{i}.mp4", _frames(3 + i, 224, 224, 10 + i))
        (root / f"c{i}.txt").write_text(f"Text:  HELLO {i}\nConf: 1\n")
    for mod, name in ((t_lrs, "port"), (j_lrs, "jax")):
        monkeypatch.setattr(sys, "argv", ["prepare_lrs", "vox2", "--root",
                                          str(tmp_path / "root"), "--out",
                                          str(tmp_path / name)])
        mod.main()
    for i in range(2):
        _same_pkl(tmp_path / "port" / "id0" / f"c{i}.pkl",
                  tmp_path / "jax" / "id0" / f"c{i}.pkl")
    src = str(root / "c0.mp4")
    assert t_lrs.read_transcript(src) == j_lrs.read_transcript(src) == "HELLO 0"
    with pytest.raises(RuntimeError, match="ultralytics"):
        t_lrs.load_face_detector()
    argv = ["prepare_lrs", "lrs3", "--root", str(tmp_path / "root"), "--out",
            str(tmp_path / "lrs3")]
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(RuntimeError, match="no CUDA device" if not torch.cuda.is_available()
                       else "ultralytics"):
        t_lrs.main()
    monkeypatch.setattr(sys, "argv", argv + ["--device", "cpu"])
    with pytest.raises(RuntimeError, match="ultralytics"):
        t_lrs.main()


def test_transcribe_needs_whisperx(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="whisperx"):
        t_transcribe.load_whisper("tiny", "cpu")
    monkeypatch.setattr(sys, "argv", ["transcribe", "--root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device" if not torch.cuda.is_available()
                       else "whisperx"):
        t_transcribe.main()


@pytest.mark.parametrize("vocab,seed", [(60, 0), (100, 3)])
def test_train_spm_writes_the_original_model_bytes(tmp_path, vocab, seed):
    """The unigram trainer's pieces and scores, the ``.model`` bytes and the
    units table are the JAX package's."""
    lines = _corpus(seed=seed)
    assert t_spm.normalize(lines[0]) == j_spm.normalize(lines[0])
    pieces = t_spm.train_unigram(lines, vocab)
    assert pieces == j_spm.train_unigram(lines, vocab)
    for mod, name in ((t_spm, "port"), (j_spm, "jax")):
        mod.write_model(str(tmp_path / f"{name}.model"), pieces)
        mod.write_units(str(tmp_path / f"{name}_units.txt"), lines,
                        str(tmp_path / f"{name}.model"))
    for suffix in (".model", "_units.txt"):
        assert ((tmp_path / f"port{suffix}").read_bytes()
                == (tmp_path / f"jax{suffix}").read_bytes())


def test_train_spm_cli_matches_the_original(tmp_path):
    inp = tmp_path / "input.txt"
    inp.write_text("\n".join(_corpus(seed=3)) + "\n", encoding="utf8")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    for pkg in ("syncvsr_tpu_torch", "syncvsr_tpu"):
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.tools.train_spm", str(inp), "--model-prefix",
             str(tmp_path / pkg / "uni100"), "--vocab-size", "100"],
            capture_output=True, text=True, timeout=600, env=env, cwd=repo)
        assert proc.returncode == 0, proc.stderr[-2000:]
    for suffix in (".model", "_units.txt"):
        assert ((tmp_path / "syncvsr_tpu_torch" / f"uni100{suffix}").read_bytes()
                == (tmp_path / "syncvsr_tpu" / f"uni100{suffix}").read_bytes())
