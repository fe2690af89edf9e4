"""The full-size workloads that ``chip_smoke.py`` and the measurement tools
(``syncvsr_tpu_torch/tools/``) drive: each path's configuration (the JAX
bench's sizes) and its synthetic batch, made from a seed with numpy, and
``tiny``, the toy widths a tool runs at with ``--tiny`` (a CPU smoke of the
tool itself).
"""

from __future__ import annotations

import numpy as np

# every width cut to a toy size, the batch to 2 (the lrs3 model keeps
# encoder and decoder equally wide, so it can decode; the sync head's
# vocabulary a multiple of 8, as K1/K2 take it)
TINY = {
    "model.encoder.layers": 1, "model.encoder.dim": 32, "model.encoder.heads": 2,
    "model.encoder.conv_kernel": 7, "model.decoder.layers": 1, "model.decoder.dim": 32,
    "model.decoder.heads": 2, "model.decoder.hidden": 64, "model.frontend.resnet_width": 8,
    "model.frontend.stem_channels": 8, "model.labels": 33,
    "model.codec.audio_vocab_size": 16, "model.dtype": "float32", "data.batch_size": 2,
    "data.eval_batch_size": 2, "data.crop_size": 16}


def tiny(cfg):
    """``cfg`` at ``TINY``'s widths, keeping the keys it has."""
    flat = cfg.to_dict()

    def has(key):
        node = flat
        for part in key.split("."):
            if not isinstance(node, dict) or part not in node:
                return False
            node = node[part]
        return True

    return cfg.override(**{k: v for k, v in TINY.items() if has(k)})


def lrw_video_cfg():
    from syncvsr_tpu_torch.config import lrw_video_config

    return lrw_video_config()   # bs 96, 29 frames, crop 96, 12 x 512 (+1) encoder, bf16


LRS3_FRAMES, LRS3_LABEL_LEN, LRS3_SOURCE = 160, 48, 128


def lrs3_cfg():
    from syncvsr_tpu_torch.config import lrs3_config

    # the JAX bench's single-chip bucket: bs 8 x 160 frames, 12 x 768 Conformer,
    # 6 x 768 decoder, 5049 labels, bf16
    return lrs3_config().override(**{"data.batch_size": 8})


# the LRS recipe's longest bucket at the JAX package's own single-chip size
# (tools/bench_decode.py::bench_train1800): bs 2 x 1800 frames, 128 labels
LRS3_1800_FRAMES, LRS3_1800_LABEL_LEN = 1800, 128


def lrs3_1800_cfg(remat=True):
    from syncvsr_tpu_torch.config import lrs3_config

    # the full-width lrs3 model (12 x 768 Conformer, 6 x 768 decoder, bf16)
    return lrs3_config().override(**{"data.batch_size": 2, "model.remat": remat})


def lrw_landmark_cfg():
    from syncvsr_tpu_torch.config import lrw_landmark_config

    # bench.py::bench_landmark's workload: bs 1024 x 29 frames of 1434 f32
    # landmark features, 8 x 320 LayerNorm/GELU encoder, 4 heads, bf16
    return lrw_landmark_config()


AUDIO_FRAMES, AUDIO_LABEL_LEN = 160, 48      # 160 x 640 = 102400 samples a clip


def lrs3_audio_cfg():
    from syncvsr_tpu_torch.config import lrs3_audio_config

    # bench.py::bench_audio's workload: bs 32 x 102400 samples of 16 kHz
    # waveform, the Conv1D ResNet-18 frontend, then lrs3's Conformer, decoder
    # and losses, bf16
    return lrs3_audio_config().override(**{"data.batch_size": 32})


def uint8_clips(cfg, seed: int = 0):
    """word_batch with uint8 clips [B, T, crop, crop * 112 / 96, 1], the
    shape of the LRW pipeline's frames."""
    from syncvsr_tpu_torch.data.synthetic import word_batch

    batch = word_batch(cfg, seed=seed)
    b, t, h = cfg.data.batch_size, cfg.data.num_frames, cfg.data.crop_size
    rng = np.random.RandomState(seed + 1)
    batch["inputs"] = rng.randint(0, 256, (b, t, h, h * 112 // 96, 1)).astype(np.uint8)
    return batch


def uint8_sentences(cfg, frames: int, label_len: int, source: int, seed: int = 0):
    """sentence_batch with uint8 clips [B, T, source, source, 1], the face
    crops of the LRS3 preprocessing (RandomResizedCrop to the crop size in
    the step)."""
    from syncvsr_tpu_torch.data.synthetic import sentence_batch

    batch = sentence_batch(cfg, num_frames=frames, label_len=label_len, seed=seed)
    rng = np.random.RandomState(seed + 1)
    batch["videos"] = rng.randint(
        0, 256, (cfg.data.batch_size, frames, source, source, 1)).astype(np.uint8)
    return batch


def landmark_clips(cfg, seed):
    """word_batch (f32 landmark features [B, T, 1434]) with the loader's pad
    sentinel, -100, in the last 3 frames of every 8th clip."""
    from syncvsr_tpu_torch.data.synthetic import word_batch

    batch = word_batch(cfg, seed=seed)
    batch["inputs"][::8, -3:] = -100.0
    return batch
