"""LRS3/LRS2/Vox2 offline preprocessing: mp4 -> face-crop pkl (the port's
own copy of ``syncvsr_tpu/tools/prepare_lrs.py``).

Port of LRS/video/preprocess/prepare_LRS3.py / prepare_LRS2.py /
prepare_Vox2.py: YOLOv8-face bbox per frame (falling back to the previous
frame's bbox, then to a centered 96x96 box — prepare_LRS3.py:44-56), 128x128
crop centered 0.2*face-height below the face center, JPEG encode, pkl bundles
with transcript text; resumable by diffing existing pkls. YOLO (`ultralytics`)
is an optional dependency gated at call time; Vox2 needs none (fixed crop).
The detector runs on the GPU unless ``--device cpu`` asks for the CPU
(without a card it raises); nothing else here touches a GPU.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from syncvsr_tpu_torch.tools.roi import (
    bundle_pkl,
    extract_audio,
    encode_jpeg_frames,
    face_center_crop,
    pending_files,
    vox2_center_crop,
)
from syncvsr_tpu_torch.tools.preprocess_lrw import read_video_frames
from syncvsr_tpu_torch.utils.device import resolve_device


def load_face_detector(model_path: str = "yolov8n-face.pt"):
    try:
        from ultralytics import YOLO
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("ultralytics (YOLOv8) is required for LRS face "
                           "detection on the preprocessing host") from e
    return YOLO(model_path)


def detect_faces(model, frame, device: str = "cpu") -> np.ndarray:
    res = model.predict(frame, save=False, save_txt=False, verbose=False,
                        imgsz=640, device=device, max_det=1)
    return res[0].boxes.cpu().xywh.numpy()


def extract_face_crops(mp4_path: str, model, device: str = "cpu",
                       crop_size: int = 128):
    crops = []
    past_bbox = None
    for i, frame in enumerate(read_video_frames(mp4_path)):
        boxes = detect_faces(model, frame, device)
        if len(boxes) == 0 and i == 0:
            past_bbox = (frame.shape[1] // 2, frame.shape[0] // 2, 96, 96)
        elif len(boxes) > 0:
            past_bbox = tuple(boxes[0])
        cx, cy, w, h = past_bbox
        crops.append(face_center_crop(frame, cx, cy, h, crop_size))
    return crops


def extract_vox2_crops(mp4_path: str):
    return [vox2_center_crop(f) for f in read_video_frames(mp4_path)]


def read_transcript(mp4_path: str) -> str:
    """LRS transcript .txt next to the mp4: first line 'Text:  ...'."""
    txt = mp4_path.replace(".mp4", ".txt")
    if not os.path.exists(txt):
        return ""
    with open(txt) as f:
        for line in f:
            if line.startswith("Text:"):
                return line.split("Text:", 1)[1].strip()
    return ""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=["lrs3", "lrs2", "vox2"])
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda",
                    help="the face detector's device (cpu: the CPU)")
    ap.add_argument("--yolo", default="yolov8n-face.pt")
    args = ap.parse_args()

    files = sorted(glob.glob(os.path.join(args.root, "**", "*.mp4"),
                             recursive=True))

    def target(src):
        return os.path.join(args.out, os.path.relpath(src, args.root)
                            .replace(".mp4", ".pkl"))

    todo = pending_files(files, ".mp4", target)
    print(f"{len(todo)}/{len(files)} files to process")

    if args.dataset != "vox2":
        resolve_device(args.device)   # a card, or --device cpu
    model = None if args.dataset == "vox2" else load_face_detector(args.yolo)
    for src in todo:
        crops = (extract_vox2_crops(src) if args.dataset == "vox2"
                 else extract_face_crops(src, model, args.device))
        if not crops:
            print(f"SKIP (no frames): {src}")
            continue
        bundle_pkl(target(src), encode_jpeg_frames(crops),
                   audio=extract_audio(src),
                   text=read_transcript(src))


if __name__ == "__main__":
    main()
