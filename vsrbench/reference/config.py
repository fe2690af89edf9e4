# Frozen copy of syncvsr_tpu_torch/config.py, part of the benchmark's plain reference.
"""Typed configuration tree serving every workload.

The PyTorch port's own copy of ``syncvsr_tpu/config.py``: the schema that
reads a configuration file of ``vsrbench/configs/`` (the presets and the
command-line overrides are not copied).

One config schema replaces the reference's three systems (OmegaConf YAML for the
GPU stacks `LRW/video/src/train.py:51`, `LRS/video/main.py:62`; argparse with
~35 flags for the TPU landmark stack `LRW/landmark/src/main.py:90-139`).
Any leaf is overridable from the CLI with dotted keys (``optim.lr=3e-4``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Tuple


# ---------------------------------------------------------------------------
# Codec constants (reference: LRW/video/src/lightning.py:57-79)
# ---------------------------------------------------------------------------

@dataclass
class CodecConfig:
    """Quantized-audio codec geometry.

    vq-wav2vec: alignment=4, groups=2, vocab=320 — wav2vec2: alignment=2,
    groups=2, vocab=640 (reference LRW/video/src/lightning.py:57-67). Audio
    tokens come pre-tokenized from the released pkls by default; set
    ``in_step`` to quantize raw waveforms on-device inside the compiled step
    (ops/codec.py, vq only).
    """

    name: str = "vq"  # "vq" | "wav2vec2"
    audio_alignment: int = 4
    vq_groups: int = 2
    audio_vocab_size: int = 320
    # in-step tokenization (reference e2e_asr_transformer.py:167-174): the
    # loader emits raw windowed waveforms and the train/eval steps quantize
    # them on-device with the frozen vq-wav2vec at ``ckpt`` (ops/codec.py).
    # Off by default — offline tokens (tools/tokenize_audio.py) are the
    # right call for a fixed dataset.
    in_step: bool = False
    ckpt: str = ""

    @staticmethod
    def vq() -> "CodecConfig":
        return CodecConfig("vq", 4, 2, 320)

    @staticmethod
    def wav2vec2() -> "CodecConfig":
        return CodecConfig("wav2vec2", 2, 2, 640)

    @property
    def tokens_per_frame(self) -> int:
        return self.audio_alignment * self.vq_groups


@dataclass
class FrontendConfig:
    """Video/landmark frontend (reference conv3d stem: LRW/video/src/lightning.py:49-55)."""

    kind: str = "landmark"  # "landmark" | "conv3d_resnet" | "conv1d_resnet"
    input_features: int = 1434      # landmark: 478*3 flattened
    stem_channels: int = 64
    resnet_width: int = 64
    out_dim: int = 512
    relu_type: str = "swish"
    # stem activation: GELU in the LRW stem (lightning.py:52), swish in the
    # LRS espnet frontend (conv3d_extractor.py:36)
    stem_act: str = "gelu"
    # fold [B,T,...] -> [B*T,...] after the stem for clips >= this many
    # frames (see frontend.py). Identical numerics either way; purely an
    # XLA-layout/memory lever — small-batch long-clip workloads benefit from
    # folding earlier, the LRW big-batch short-clip step from not folding.
    fold_threshold: int = 256


@dataclass
class EncoderConfig:
    """Sequence encoder settings shared by transformer/conformer/dense_tcn."""

    kind: str = "transformer"  # "transformer" | "conformer" | "dense_tcn" | "tcn" | "mstcn"
    layers: int = 8
    dim: int = 320
    heads: int = 4
    hidden_ratio: float = 4.0
    hidden: int = 0   # explicit FF width; 0 -> int(hidden_ratio * dim)
    # transformer flavour (x-transformers style in reference: rmsnorm+glu+rope,
    # LRW/video/src/lightning.py:93-105)
    use_rmsnorm: bool = False
    use_glu: bool = False
    rope: bool = True
    rope_dim: int = 0  # partial rotary width; 0 -> full head_dim.
    # x-transformers rotates max(32, head_dim // 2) — set 32 for released-ckpt
    # parity
    emb_dropout: float = 0.1
    msa_dropout: float = 0.1
    mlp_dropout: float = 0.1
    droppath: float = 0.1
    # conformer flavour (LRS/video/config/lrs3.yaml model.visual_backbone)
    macaron: bool = True
    conv_kernel: int = 31
    rel_pos: bool = True
    # dense_tcn flavour
    tcn_kernel_sizes: Tuple[int, ...] = (3, 5, 7)
    tcn_dilations: Tuple[int, ...] = (1, 2, 5)
    tcn_growth_rates: Tuple[int, ...] = (384, 384, 384, 384)
    tcn_blocks: Tuple[int, ...] = (3, 3, 3, 3)
    tcn_reduced_size: int = 512
    tcn_se: bool = True
    # classic / multibranch TCN flavour (kind="tcn" | "mstcn"; reference
    # tcn/model.py tcn_options — the Lipreading wrapper's other back end)
    tcn_channels: Tuple[int, ...] = (768, 768, 768)
    tcn_kernel: int = 3          # single-kernel variant ("tcn")
    tcn_dropout: float = 0.2
    tcn_dwpw: bool = False


@dataclass
class DecoderConfig:
    """Attention decoder (reference: lrs3.yaml ddim=768, dheads=12, dunits=3072, dlayers=6)."""

    layers: int = 6
    dim: int = 768
    heads: int = 12
    hidden: int = 3072
    dropout: float = 0.1


@dataclass
class ModelConfig:
    task: str = "word"  # "word" | "sentence"
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    codec: CodecConfig = field(default_factory=CodecConfig)
    labels: int = 500               # word classes, or token vocab for sentence
    use_word_boundary: bool = False
    # sentence-level loss algebra (e2e_asr_transformer.py:218-221)
    mtlalpha: float = 0.1
    lsm_weight: float = 0.1
    # shared
    label_smoothing: float = 0.0
    sync_lambda: float = 10.0
    dtype: str = "bfloat16"         # compute dtype; params stay float32
    remat: bool = False             # rematerialize encoder blocks (1800-frame clips)


@dataclass
class DataConfig:
    dataset: str = "synthetic"      # "lrw" | "lrw_landmark" | "lrs2" | "lrs3" | "vox2" | "synthetic"
    root: str = "/data"
    # sentence-level input modality (reference datamodule selects per config,
    # LRS/video/datamodule/data_module.py:79-99): "video" feeds JPEG frames to
    # the conv3d frontend, "audio" feeds the bundled 16 kHz waveform to the
    # conv1d frontend
    modality: str = "video"
    # babble-noise waveform (.npy) for the audio AddNoise augmentation
    # (reference transforms.py:67-86); "" disables noise injection
    noise_path: str = ""
    # eval-time SNR in dB (reference decode.snr_target); >= 999999 = clean
    snr_target: float = 999999.0
    split: str = ""                 # eval split; "" -> val in train, test in evaluate
    # released audio-token pkls root, mapped by path convention
    # (reference LRW/video/src/data.py:49-55); "" -> tokens embedded in video pkls
    audio_root: str = ""
    # root holds <split>.{bin,npz} packed by tools/pack_dataset.py instead of
    # a per-clip pkl tree (mmap blob: no unpickle on the loader hot path)
    packed: bool = False
    # path to a video_length.npy-style histogram for long-clip windowing
    # (reference LRS/video/datamodule/av_dataset.py:43-52)
    length_distribution: str = ""
    batch_size: int = 16
    eval_batch_size: int = 16
    num_frames: int = 29            # LRW clips are 29 frames
    crop_size: int = 96
    max_frames: int = 1800          # lrs3.yaml:8
    max_frames_val: int = 500
    max_label_len: int = 128
    mean: float = 0.421             # LRW/video/src/data.py:146
    std: float = 0.165
    # augmentation (train pipeline LRW/video/src/data.py:150-167)
    use_cutmix: bool = True
    cutmix_alpha: float = 1.0
    hflip_prob: float = 0.5
    rrc_scale: Tuple[float, float] = (0.6, 1.0)
    time_mask_window: int = 15      # int(0.6 * 25) frames
    time_mask_stride: int = 1
    adaptive_time_mask: bool = True
    num_workers: int = 0
    # length bucketing for sentence-level (replaces dynamic shapes under XLA)
    length_buckets: Tuple[int, ...] = (160, 320, 640, 1200, 1800)
    # frames budget per batch: long buckets get proportionally smaller
    # batches (per-bucket bs = clamp(max_batch_frames // bucket, 1,
    # batch_size)); 0 disables. Keeps the 1800-frame bucket inside one
    # chip's HBM while short buckets keep the full batch size.
    max_batch_frames: int = 0
    # custom SentencePiece unigram model for sentence datasets: path to a
    # .model file with <stem>_units.txt next to it (reference sp_model_path/
    # dict_path, LRS/video/datamodule/transforms.py:138-151); "" -> bundled
    # LRS unigram-5000 assets
    spm_vocab: str = ""


@dataclass
class OptimConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    weight_decay: float = 0.03
    clip_norm: float = 5.0
    warmup_steps: int = 25_000
    total_steps: int = 500_000
    init_lr: float = 1e-6
    end_lr: float = 1e-5
    accum_steps: int = 1
    skip_nonfinite: bool = False  # drop updates with non-finite grads (long runs)


@dataclass
class MeshConfig:
    """Device mesh. Word/sentence parity needs only a data axis; model axes
    are available for larger configs (tensor-sharded encoder/decoder
    matmuls), and a seq axis shards clip time across chips (sequence
    parallelism for the 1800-frame LRS buckets — frame count must divide
    it; indivisible batches fall back to data-only sharding)."""

    data: int = -1                  # -1: all remaining devices
    model: int = 1
    seq: int = 1
    # ZeRO/FSDP: shard params + Adam moments over ``data`` (largest divisible
    # dim per leaf, >= fsdp_min_size elements); XLA all-gathers weights at
    # use and reduce-scatters grads. For models past one chip's HBM.
    fsdp: bool = False
    fsdp_min_size: int = 32768


@dataclass
class TrainConfig:
    seed: int = 0
    mixup_seed: int = 1
    dropout_seed: int = 2
    epochs: int = 100
    log_every: int = 50
    eval_every: int = 1000
    ckpt_every: int = 1000
    ckpt_dir: str = "ckpt"
    resume: str = ""
    pretrained: str = ""
    wandb: bool = False
    donate: bool = True
    profile_steps: str = ""     # "start:stop" step range to profile with torch.profiler
    profile_dir: str = "trace"  # where the trace is written
    distributed: bool = False   # join the process group (implied under torchrun)
    tabulate: bool = False      # print the model's module tree at init
    # XLA scoped-VMEM ceiling (KiB) read by the JAX package only; kept so
    # both packages serialize the same config tree
    scoped_vmem_kib: int = 0


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    name: str = "run"

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: dict) -> "Config":
        return _build(Config, d)

    def override(self, **dotted: Any) -> "Config":
        """Return a new config with dotted-key overrides applied."""
        d = self.to_dict()
        for key, value in dotted.items():
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = value
        return Config.from_dict(d)


def _build(cls, d: dict):
    known = {f.name for f in fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise KeyError(f"unknown config key(s) for {cls.__name__}: {sorted(unknown)}; "
                       f"valid keys: {sorted(known)}")
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if is_dataclass(f.type) if isinstance(f.type, type) else False:
            kwargs[f.name] = _build(f.type, v)
        elif isinstance(v, dict):
            # typing gives string annotations; resolve known sub-configs
            sub = _SUBCONFIGS.get(f.name)
            kwargs[f.name] = _build(sub, v) if sub else v
        elif isinstance(v, list):
            kwargs[f.name] = tuple(v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_SUBCONFIGS = {
    "model": ModelConfig,
    "data": DataConfig,
    "optim": OptimConfig,
    "mesh": MeshConfig,
    "train": TrainConfig,
    "frontend": FrontendConfig,
    "encoder": EncoderConfig,
    "decoder": DecoderConfig,
    "codec": CodecConfig,
}
