"""Shared toy sizes of the benchmark's CPU tests, and the ``chip`` marker of
the tests that need the card (they decide inside the test and skip
without one)."""

import pytest

# every width cut to a toy size, f32 (the CPU's bf16 convolution backward
# is not meaningful at toy crops)
TINY = {
    "model.encoder.layers": 1, "model.encoder.dim": 32, "model.encoder.heads": 2,
    "model.encoder.conv_kernel": 7, "model.decoder.layers": 1, "model.decoder.dim": 32,
    "model.decoder.heads": 2, "model.decoder.hidden": 64, "model.frontend.resnet_width": 8,
    "model.frontend.stem_channels": 8, "model.labels": 33,
    "model.codec.audio_vocab_size": 16, "model.dtype": "float32", "data.batch_size": 4,
    "data.eval_batch_size": 4, "data.crop_size": 16}

SIZES = {
    "lrw_video.train": (dict(TINY, **{"data.num_frames": 4}),
                        {"batch_size": 4, "frames": 4, "height": 16, "width": 18, "pool": 3}),
    "lrs3.train_long": (dict(TINY), {"batch_size": 4, "frames": 12, "source": 20,
                                     "lengths": [6, 12], "label_width": 4,
                                     "label_lengths": [2, 3], "pool": 3}),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
