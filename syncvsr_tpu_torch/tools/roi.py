"""Lip-ROI geometry and frame bundling for offline preprocessing (the
port's own copy of ``syncvsr_tpu/tools/roi.py``; it imports nothing of
the JAX package).

Reimplements the reference's crop math:
  * LRW: mediapipe FaceMesh lip/oval landmark blend -> fixed 96h x 112w crop
    (LRW/video/src/preprocess_pkl.py:32-181);
  * LRS3/LRS2: face bbox center pushed 0.2h down -> fixed 128x128 crop with
    border clamping (LRS/video/preprocess/prepare_LRS3.py:60-85);
  * Vox2: fixed center crop rows 48..176 (prepare_Vox2.py:17-33).
Detector invocations (mediapipe / YOLOv8) live in the CLI tools and are
import-gated; everything here is pure numpy + cv2.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

# mediapipe FaceMesh indices (preprocess_pkl.py:32-93)
FACEMESH_LIPS = [0, 13, 14, 17, 37, 39, 40, 61, 78, 80, 81, 82, 84, 87, 88,
                 91, 95, 146, 178, 181, 185, 191, 267, 269, 270, 291, 308,
                 310, 311, 312, 314, 317, 318, 321, 324, 375, 402, 405, 409,
                 415]
FACEMESH_OVAL = [58, 172, 136, 150, 149, 176, 148, 152, 377, 400, 378, 379,
                 365, 397, 288]
FACEMESH_ROI = FACEMESH_LIPS + FACEMESH_OVAL


def lip_bbox_from_landmarks(landmarks: np.ndarray, image_width: int = 256,
                            image_height: int = 256) -> List[int]:
    """[478, 3] normalized mediapipe landmarks -> [l, t, r, b] pixel bbox of
    the 96h x 112w mouth crop (median/mean-blended center,
    preprocess_pkl.py:128-146)."""
    x = landmarks[:, 0]
    y = landmarks[:, 1]
    min_x, max_x = float(np.min(x)), float(np.max(x))
    roi_x = x[FACEMESH_ROI]
    roi_y = y[FACEMESH_ROI]
    cx = (np.median(roi_x) + np.mean(roi_x) + min_x + max_x) / 4
    cy = (np.median(roi_y) + np.mean(roi_y)) / 2
    px = math.floor(cx * image_width)
    py = math.floor(cy * image_height)
    return [px - 56, py - 48, px + 56, py + 48]


def clamp_bbox(bbox: Sequence[float], frame_w: int = 256, frame_h: int = 256,
               target_w: float = 112.0, target_h: float = 96.0) -> List[float]:
    """Slide an out-of-bound bbox back inside the frame keeping its size
    (preprocess_pkl.py:158-174)."""
    left, top, right, bottom = [float(v) for v in bbox]
    if left <= 0.0:
        left, right = 0.0, target_w
    if top <= 0.0:
        top, bottom = 0.0, target_h
    if right >= frame_w:
        right, left = float(frame_w), frame_w - target_w
    if bottom >= frame_h:
        bottom, top = float(frame_h), frame_h - target_h
    return [left, top, right, bottom]


def crop_fixed(frame: np.ndarray, bbox: Sequence[float],
               expect: Optional[Tuple[int, int]] = (96, 112)) -> np.ndarray:
    left, top, right, bottom = bbox
    if (left <= 0 or top <= 0 or right >= frame.shape[1]
            or bottom >= frame.shape[0]):
        left, top, right, bottom = clamp_bbox(
            (left, top, right, bottom), frame.shape[1], frame.shape[0])
    out = frame[int(top):int(bottom), int(left):int(right)]
    if expect is not None and out.shape[:2] != expect:
        raise ValueError(f"bad crop shape {out.shape[:2]}, expected {expect}")
    return out


def face_center_crop(frame: np.ndarray, center_x: float, center_y: float,
                     height: float, crop_size: int = 128) -> np.ndarray:
    """LRS3/LRS2 crop: center pushed 0.2*face-height down, clamped, fixed
    square (prepare_LRS3.py:60-85)."""
    border = crop_size // 2
    cy = center_y + 0.2 * height
    cx = min(max(center_x, border), frame.shape[1] - border)
    cy = min(max(cy, border), frame.shape[0] - border)
    return frame[int(cy - border):int(cy + border),
                 int(cx - border):int(cx + border)]


def vox2_center_crop(frame: np.ndarray) -> np.ndarray:
    """Fixed crop rows/cols 48..176 (prepare_Vox2.py:17-33)."""
    return frame[48:176, 48:176]


def encode_jpeg_frames(frames: Sequence[np.ndarray], quality: int = 95
                       ) -> List[bytes]:
    """Per-frame JPEG encode (cv2 in place of TurboJPEG)."""
    import cv2

    out = []
    for f in frames:
        ok, buf = cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise RuntimeError("jpeg encode failed")
        out.append(buf.tobytes())
    return out


def extract_audio(mp4_path: str, sample_rate: int = 16_000):
    """mp4 -> {"array": int16 mono waveform, "sample_rate": sr} via the
    ffmpeg CLI (the reference bundles pydub AudioSegments,
    preprocess_pkl.py:209-225; this emits the numpy contract
    tools/tokenize_audio.to_waveform consumes). Returns None when ffmpeg is
    unavailable or the clip has no audio track."""
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        return None
    cmd = ["ffmpeg", "-v", "error", "-i", mp4_path, "-vn", "-ac", "1",
           "-ar", str(sample_rate), "-f", "s16le", "-"]
    try:
        raw = subprocess.run(cmd, capture_output=True, timeout=120).stdout
    except (subprocess.SubprocessError, OSError):
        return None
    if not raw:
        return None
    wav = np.frombuffer(raw, np.int16)
    return {"array": wav, "sample_rate": sample_rate}


def bundle_pkl(path: str, video_jpegs: List[bytes], audio=None,
               text: Optional[str] = None, extra: Optional[dict] = None):
    """Write the dataset pkl contract ({"video": [...], "audio", "text"},
    preprocess_pkl.py:209-225 / prepare_LRS3.py:90-115)."""
    import os

    import torch

    result = {"video": video_jpegs}
    if audio is not None:
        result["audio"] = audio
    if text is not None:
        result["text"] = text
    if extra:
        result.update(extra)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(result, path)


def pending_files(sources: Sequence[str], src_ext: str, done_dir_map) -> List[str]:
    """Resumable preprocessing: skip sources whose target pkl already exists
    (prepare_LRS3.py:146-166)."""
    import os

    out = []
    for s in sources:
        if not os.path.exists(done_dir_map(s)):
            out.append(s)
    return out
