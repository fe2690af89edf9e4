"""LRW offline preprocessing: mp4 -> landmark npy -> ROI pkl (the port's
own copy of ``syncvsr_tpu/tools/preprocess_lrw.py``).

Port of the reference pipeline (LRW/video/src/preprocess_roi.py:16-49 +
preprocess_pkl.py): stage 1 runs mediapipe FaceMesh per frame and saves
[T, 478, 3] normalized landmarks; stage 2 computes the blended lip-ROI bbox,
crops fixed 96h x 112w windows, JPEG-encodes, and bundles pkls. mediapipe is
an optional dependency (absent in the training image); stage 2 is pure
numpy/cv2, runs anywhere and touches no GPU (mediapipe runs on the host).

Usage:
    python -m syncvsr_tpu_torch.tools.preprocess_lrw landmarks --root ... --out ...
    python -m syncvsr_tpu_torch.tools.preprocess_lrw pkl --root ... --out ...
"""

from __future__ import annotations

import argparse
import glob
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from syncvsr_tpu_torch.tools.roi import (
    bundle_pkl,
    crop_fixed,
    encode_jpeg_frames,
    extract_audio,
    lip_bbox_from_landmarks,
    pending_files,
)


def read_video_frames(path: str):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    while cap.isOpened():
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
    cap.release()
    return frames


def extract_landmarks(mp4_path: str) -> np.ndarray:
    """mediapipe FaceMesh -> [T, 478, 3]; NaN rows when no face found
    (preprocess_roi.py:36-49)."""
    try:
        import mediapipe as mp
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "mediapipe is required for landmark extraction; install it on the "
            "preprocessing host (it is not part of the training image)") from e

    mesh = mp.solutions.face_mesh.FaceMesh(
        static_image_mode=False, refine_landmarks=True, max_num_faces=1)
    import cv2

    out = []
    for frame in read_video_frames(mp4_path):
        res = mesh.process(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if res.multi_face_landmarks:
            lm = res.multi_face_landmarks[0].landmark
            out.append([[p.x, p.y, p.z] for p in lm])
        else:
            out.append(np.full((478, 3), np.nan))
    return np.asarray(out, np.float32)


def process_pkl(mp4_path: str, out_path: str) -> None:
    """Stage 2: landmarks npy (next to the mp4) -> ROI pkl."""
    landmarks = np.load(mp4_path.replace(".mp4", ".npy"))
    frames = read_video_frames(mp4_path)
    h, w = frames[0].shape[:2]
    crops = []
    for i, frame in enumerate(frames):
        bbox = lip_bbox_from_landmarks(landmarks[i], w, h)
        crops.append(crop_fixed(frame, bbox))
    # clip audio rides along for offline tokenization
    # (reference preprocess_pkl.py:209-225 saves pydub audio)
    bundle_pkl(out_path, encode_jpeg_frames(crops),
               audio=extract_audio(mp4_path))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", choices=["landmarks", "pkl"])
    ap.add_argument("--root", required=True, help="LRW lipread_mp4 root")
    ap.add_argument("--out", required=True)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args()

    files = sorted(glob.glob(os.path.join(args.root, "*", "*", "*.mp4")))

    def target(src):
        rel = os.path.relpath(src, args.root)
        ext = ".npy" if args.stage == "landmarks" else ".pkl"
        return os.path.join(args.out, rel.replace(".mp4", ext))

    todo = pending_files(files, ".mp4", target)
    print(f"{len(todo)}/{len(files)} files to process")

    def run(src):
        dst = target(src)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if args.stage == "landmarks":
            np.save(dst, extract_landmarks(src))
        else:
            process_pkl(src, dst)

    with ThreadPoolExecutor(args.workers) as ex:
        list(ex.map(run, todo))


if __name__ == "__main__":
    main()
