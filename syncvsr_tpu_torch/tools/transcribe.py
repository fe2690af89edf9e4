"""Whisper transcription for unlabeled pretraining video (Vox2) (the port's
own copy of ``syncvsr_tpu/tools/transcribe.py``).

Port of LRS/video/preprocess/transcribe_whisper.py:46-60: run whisperX over
each clip's audio and write the transcript next to the pkl. whisperX is an
optional dependency of the preprocessing host (never part of the training
image). The model runs on the GPU unless ``--device cpu`` asks for the CPU
(without a card it raises).
"""

from __future__ import annotations

import argparse
import glob
import os

from syncvsr_tpu_torch.utils.device import resolve_device


def load_whisper(model_name: str = "large-v2", device: str = "cuda"):
    try:
        import whisperx
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("whisperx is required for transcription; install "
                           "it on the preprocessing host") from e
    return whisperx.load_model(model_name, device)


def transcribe_file(model, path: str, language: str = "en") -> str:
    import whisperx

    audio = whisperx.load_audio(path)
    result = model.transcribe(audio, language=language)
    return " ".join(seg["text"].strip() for seg in result["segments"]).strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--model", default="large-v2")
    ap.add_argument("--device", default="cuda", help="cpu: the CPU")
    ap.add_argument("--language", default="en")
    args = ap.parse_args()

    resolve_device(args.device)   # a card, or --device cpu
    model = load_whisper(args.model, args.device)
    files = sorted(glob.glob(os.path.join(args.root, "**", "*.mp4"),
                             recursive=True))
    for f in files:
        txt = f.replace(".mp4", ".txt")
        if os.path.exists(txt):
            continue
        text = transcribe_file(model, f, args.language)
        with open(txt, "w") as fh:
            fh.write(f"Text:  {text.upper()}\n")
        print(f"{f}: {text[:60]}")


if __name__ == "__main__":
    main()
