#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``syncvsr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]
    python3 chip_smoke.py --tools-full    # every measurement tool at full size

Run from the root of a checkout. Phases, in order; any failure exits
non-zero before the last line is printed:

1. device: a CUDA card is required (there is no CPU path); prints its name
   and power limit;
2. build: compiles the hand-written kernels (``syncvsr_tpu_torch/csrc``)
   with nvcc for sm_90a, one process per source, and prints ptxas's
   registers / shared memory / spills;
3. kernels: each kernel against its plain PyTorch version at the shapes
   its train steps give it (K1 at ``lrw_video``'s, ``lrw_landmark``'s and
   ``lrw1000``'s sync heads, this one 4 slots of 640 tokens, and at
   ``MONO_CASES``; K2 at ``lrs3``'s, ``lrs3_audio``'s, ``lrw_dctcn``'s,
   ``lrw1000_dctcn``'s, this one 4 slots of 640 tokens in two column
   passes, and ``lrs3_1800``'s [3600, 768], and at ``SPLIT_CASES``; K3/K4 at
   every BatchNorm shape of the steps that have them, ``lrs3_1800``'s
   [8294400, 64] ... [3600, 768] among them, and at ``BN_EXTRA``; each twice,
   bitwise; and K3/K4 at ``BN_PAST_INT32``, 4.25e9 elements, against chunked
   f64 sums), with
   its time (``ms``: CUDA events around 20 warm back-to-back calls of the
   wrapper, host included) beside its bound, the plain version's time and
   one PyTorch library call's, per path; K3/K4 per shape too;
4. reference, for each path: two train steps of a small f32 model on the
   card (through the kernels) against the same steps on the CPU (the plain
   versions): ``lrw_video``, ``lrs3`` (a 768-wide Conformer, so the sync
   head takes K2; one clip shorter than its labels, so the CTC loss's
   recursion for rows with no alignment runs), ``lrw_landmark`` (the pad sentinel in some frames),
   ``lrs3_audio`` (768 wide, 10240 samples a clip), ``lrw1000`` (64 wide,
   4 slots of 640 tokens: K1's two column passes), ``lrw_dctcn`` (a
   one-layer DC-TCN 896 wide, so its head takes K2, twice a step under
   mixup), ``lrw1000_dctcn`` (the same DC-TCN over ``lrw1000``'s data:
   K2 at 4 slots of 640) and ``lrs3_1800`` (``lrs3``'s small model with
   ``model.remat`` and ``optim.accum_steps=2`` at 320 frames: the sync
   head's chunked backward, K3 twice a BatchNorm) and ``lrs3_instep``
   (``lrs3``'s small model whose sync targets the in-step vq-wav2vec codec
   makes from 16 frames of waveform, at its real 512-wide geometry with a
   separated codebook: the same tokens on both sides): the metrics and
   Adam's first moment, less the ReLU units whose input f32 rounding put
   on the other side of 0;
5. train, for each path: the full-width train step (``lrw_video``: batch
   96, 29 uint8 96x112 frames; ``lrs3``: batch 8, 160 uint8 128x128 frames,
   12-layer Conformer + 6-layer decoder; ``lrw_landmark``: batch 1024, 29
   frames of 1434 f32 landmark features, 8 x 320 LayerNorm/GELU encoder;
   ``lrs3_audio``: batch 32, 102400 samples of waveform, ResNet1D then
   ``lrs3``'s Conformer and decoder; ``lrw1000``: batch 96, 40 uint8
   frames, 1000 labels, the wav2vec2 codec's 4 slots of 640; ``lrw_dctcn``:
   batch 96, 29 uint8 frames, the 4 x 3-layer DC-TCN (1664 wide), mixup,
   a ragged attention mask; ``lrw1000_dctcn``: ``lrw1000``'s batch under
   that DC-TCN, K2 at 4 slots of 640; bf16, augmentation and dropout as
   configured), 3 warm-up and two windows of 5 timed steps with the
   kernels' launches counted from 0 and how the steps ran (``graph_steps``:
   a word path's are CUDA-graph replays, ``engine/graph.py``, whose
   wrapper counts are their capture's), then one eval step; the audio stem
   conv timed alone; ``lrs3`` also times 5 steps of a batch whose last
   clip is shorter than its labels (the CTC recursion's cost);
   ``lrs3_1800`` (``train_1800``): the full-width ``lrs3`` model at batch 2
   x 1800 uint8 frames without and with ``model.remat`` (first-step losses
   equal, peak memory, 2 windows of 3 steps; K3 64 and K4 32 launches a
   step with remat, 32 and 32 without); ``lrs3_instep`` (``train_instep``):
   ``lrs3``'s full-width step with ``audio`` [8, 102400] f32 quantized
   inside the step by vq-wav2vec (8 convs 512 wide, G 2, V 320; seeded
   fairseq checkpoints the script writes to a temporary directory and
   loads through ``load_vq_codec``): step ms with the codec and with its
   tokens made once before, the codec's own ms (CUDA events; its device ms
   in phase 8), peak memory, K2/K3/K4 1/32/32 a step, card tokens against
   the CPU's (TF32 on for the process, which the codec overrides);
6. decode: the port's decoding entry points (``syncvsr_tpu_torch/decode``),
   which launch none of K1-K4 (checked): (a) a small f32 ``lrs3`` model
   (encoder and decoder 32 wide, 11 labels, 3 clips of 12, 9 and 6 frames),
   seeded, decoded on the card and on the CPU: the batched beam search
   with a TransformerLM and with an LSTM LM (equal tokens, or a near-tie
   row: scores within 1e-4, at most one such row), the same search on
   clip 0 alone on the card (equal to row 0), greedy CTC and forced
   alignment (equal); (b) the full-width ``lrs3`` model (bf16, random
   weights) on 8 clips of 160 frames (lengths 160, 152, ..., 104): the
   batched beam search at beam 40 with ``lrs3.yaml``'s TransformerLM
   (16 x 512) fused at weight 0.1, the same search on clip 0 alone (row
   0's tokens, or, as bf16 rounds otherwise at B = 1, a score within 2^-9
   of row 0's), greedy CTC and forced alignment (each path must spell its
   labels): ms a batch, utterances/s, steps, host reads, encode against
   search time, peak memory and WER;
7. cli: the entry points a user runs, ``python -m syncvsr_tpu_torch.train``
   and ``.evaluate``, each in its own process, on synthetic data, into a
   temporary directory removed at the end (``cli_phase``): ``lrw_video`` at
   full width and 2 of its 12 encoder layers (the steps above run all of
   them) trains 6 steps with an eval and a save at step 4, resumes to
   step 8, and ``evaluate`` reads its ``best.msgpack``; ``lrw1000`` with the
   DC-TCN at full width trains 4 steps (K2 at V = 640); ``lrs3`` cut to 2 +
   1 layers trains 4 steps, then decodes its ``best.msgpack`` greedily and
   with the batched beam search; beside it, in concurrent chains (each
   process's seconds are then not comparable with the step phase's),
   datasets from files (``cli_files``):
   ``lrs3`` at full width (2 encoder and 1 decoder layer, ``FILES_DEPTH``)
   from a packed synthetic LRS3 tree over all five
   buckets with remat, accumulation and the non-finite guard, and
   ``evaluate`` of its test split; ``lrs3_audio`` over that tree's pkls,
   ``vox2`` windowed by a length histogram, ``lrw_landmark`` from ``.npy``
   clips; then the codecs and reference checkpoints (``cli_codecs``):
   ``lrs3`` with ``model.codec.in_step=true`` from the pkl tree,
   ``tools.tokenize_audio`` on both routes, ``tools.import_checkpoint
   lrs`` of a full-width espnet-layout checkpoint with a greedy
   ``evaluate`` of it, and beam ``evaluate`` with an espnet ``.pth``
   TransformerLM of 16 layers (against the same LM converted to msgpack);
   the kernels' launches a step are read
   from the driver's ``metrics.jsonl``, and its ``step_ms_ema`` is printed
   beside phase 5's step time;
8. parallel (``parallel_phase``): (a) ``python -m torch.distributed.run
   --standalone --nproc-per-node 1 -m syncvsr_tpu_torch.train
   preset=lrw_video`` (an NCCL group of one, 5 steps at full width): its
   losses against the bare step's on the same batches, K1/K3/K4 1/20/20 a
   step from ``metrics.jsonl``, its ``step_ms_ema`` beside phase 5's;
   (b) two processes that share the card (gloo over CUDA tensors: NCCL
   takes one rank a device): ``lrw_video`` at full width on a global
   batch of 96 (48 clips a rank; augmentation and CutMix on, dropout 0)
   against one process on the same 96 clips (bf16, ``BF16_TOL``), the same
   with a 2-layer 64-wide f32 model (``F32_TOL``, ``tests/test_spmd.py``'s),
   then 3 steps with the preset's dropout (the ranks' parameters and
   statistics bitwise equal); (c) ``lrs3`` at full width and 2 + 1 layers
   (``FILES_DEPTH``) on 8 x 160 frames (4 a rank) with FSDP against data parallel (metrics and
   parameters, each rank's resident parameter and moment bytes: half of
   the split leaves'), and FSDP's checkpoint loaded at one process, every
   leaf equal; K1/K3/K4 and K2/K3/K4 counted in each rank; the two-rank
   step times are labelled as correctness, not scaling;
9. tensor (``tensor_phase``): tensor parallel, ``mesh.model=2``, with the
   processes sharing the card over gloo: (a) ``lrs3`` at full width (8 x
   160 frames, bf16) and (b) ``lrw_video`` at full width (96 clips) on
   (data=1, model=2) against world 1 on the same batch (``TP_TOL``), each
   rank's resident parameter and moment bytes against ``TP_HELD`` and the
   specs' prediction, K1 on each rank's 4 of 8 slots (``lrs3``'s local
   head takes K1, not K2) and K3/K4 on the gathered channels, counted in
   each rank; (c) ``python -m torch.distributed.run --nproc-per-node 2 -m
   syncvsr_tpu_torch.train preset=lrs3 mesh.model=2 mesh.fsdp=true`` at
   full width and 2 + 1 layers, 2 steps, a rank's bytes as the specs
   predict, and its checkpoint loaded at one process, every leaf equal; (d)
   four processes as (data=2, model=2) with FSDP on a 2-layer 64-wide f32
   model (the rule at min_dim 16: a leaf on both axes) against world 1
   (``F32_TOL``); the ranks' step times are labelled as correctness, not
   scaling;
10. seq (``seq_phase``): sequence parallel, ``mesh.seq=2``, each rank on
   its half of every clip's frames, the processes sharing the card over
   gloo: (a) ``lrs3_1800`` (2 x 1800 frames, full width and depth, no
   remat) and (b) ``lrs3`` (8 x 160) on (data=1, seq=2) against world 1 on
   the same batch (``TP_TOL`` on the first step, ``BF16_TOL`` on the
   parameters after 2), K2/K3/K4 on a rank's frames counted in each rank,
   a rank's peak device memory beside world 1's; (c) ``python -m
   torch.distributed.run --nproc-per-node 2 -m syncvsr_tpu_torch.train
   preset=lrs3 mesh.seq=2`` at full width and 2 + 1 layers with remat
   over a synthetic LRS3 tree's buckets (160 to 1800 frames), its
   checkpoint loaded at one process, every leaf equal, beside (d) four
   processes: a 2 + 1-layer 64-wide f32 ``lrs3`` model as (data=2, seq=2)
   with FSDP and as (seq=2, model=2), and a 2-layer 64-wide f32
   ``lrw_video`` model at 40 frames and at 29 (indivisible: the seq ranks
   repeat the rows) as (seq=2, model=2), against world 1 (``SEQ_F32_TOL``,
   ``tests/test_spmd.py``'s for its sequence-parallel step); (e)
   ``lrs3_audio`` (32 x 102400 samples, full width and depth) at seq=2,
   each rank on its 51200 samples (ResNet1D's convs with halos), against
   world 1 as (a) and (b) are, a rank's peak below world 1's;
11. tools (``tools_phase``, one more chain of phase 7's, ``tools_chain``):
   each measurement tool of the port (``syncvsr_tpu_torch/tools/``) once
   on the card at toy widths (``TOOL_RUNS``), all in one process: each must
   print its JSON line from the card (its name and power limit), and
   ``bench_aux_workloads``' steps launch each path's kernels (at toy
   widths K1 once a step of each, K3/K4 21 times ``lrs3_audio``'s);
12. profiler windows, after every timing above (a process that torch.profiler
   has traced can pay more host time a launch from then on): each kernel's
   own device time (``device_ms``) over the calls phase 3 timed (K1's with
   its features' pad copy), each held to one kernel of its own a call (K3
   and K4 to one device kernel); each path whose timed steps replayed a
   CUDA graph once more in a fresh state (``replayed_launches``): 6
   replays, 5 of them profiled, every one a replay, K1-K4's launches a
   step read by kernel name from the trace and counted by the wrappers
   from 0, both equal to the path's; with ``--profile DIR``, 3 profiled steps of
   each path (device time by kernel group and the device's idle share), and
   of ``lrs3``'s batch with the infeasible row;
   then K4 at the Conformer's shape timed again, beside its phase-3 time;
   profiled decode calls: the encoder alone and a 16-step beam decode
   (device launches a search step), greedy and align (launches, device
   time, idle share); with ``--profile DIR``, the full beam decode too and
   the tables in ``DIR/profile_decode_<name>.txt``;
13. the ``decode``, ``cli``, ``parallel``, ``tensor``, ``seq`` and ``tools``
    JSON lines, each phase's seconds, the ``kernels`` JSON line (K1 and K2 also
    at a rank's half batch, ``lrw_video_dp2`` and ``lrs3_fsdp2``, K1 at a
    model rank's 4 slots, ``lrs3_tp2`` and ``lrw_video_tp2``, K2 at a seq
    rank's frames, ``lrs3_1800_sp2``, ``lrs3_sp2`` and ``lrs3_audio_sp2``,
    K3/K4 at those
    paths' shapes), the card line and the ``ok`` line.
"""

import json
import math
import subprocess
import sys
import time

WARMUP_STEPS = 3
TIMED_STEPS = 5      # per window; two windows

from syncvsr_tpu_torch.utils.benchmark import (  # noqa: E402
    PEAK_BF16_FLOPS,
    PEAK_BYTES,
    PEAK_F32_FLOPS,
    bound_ms,
    card_line,
    device_ms,
    profile_window,
    resnet1d_bn_shapes,
    time_ms,
    trunk_bn_shapes,
)
from syncvsr_tpu_torch.utils.workloads import (  # noqa: E402
    AUDIO_FRAMES,
    AUDIO_LABEL_LEN,
    LRS3_1800_FRAMES,
    LRS3_1800_LABEL_LEN,
    LRS3_FRAMES,
    LRS3_LABEL_LEN,
    LRS3_SOURCE,
    landmark_clips,
    lrs3_1800_cfg,
    lrs3_audio_cfg,
    lrs3_cfg,
    lrw_landmark_cfg,
    lrw_video_cfg,
    uint8_clips,
    uint8_sentences,
)


CUDA = "cuda"   # the device ``time_ms`` times on


def log(msg):
    print(msg, flush=True)


def library_ms(torch, fn, what):
    """Time of a PyTorch library call used as a yardstick, or None (with the
    reason printed) where this PyTorch build refuses it."""
    try:
        return time_ms(fn, CUDA)
    except (RuntimeError, TypeError, AttributeError) as e:
        log(f"  library yardstick {what} unavailable: {e}")
        return None


# the paths whose step recomputes every BatchNorm's statistics (model.remat):
# K3 runs twice a BatchNorm, K4 once
REMAT_PATHS = ("lrs3_1800",)


def lrw1000_cfg():
    from syncvsr_tpu_torch.config import lrw1000_config

    # bs 96 x 40 frames, crop 96, 12 x 512 encoder over a 512-wide stream (no
    # word boundary), 1000 labels, wav2vec2 codec (2 x 2 slots of 640), bf16
    return lrw1000_config()


def lrw_dctcn_cfg():
    from syncvsr_tpu_torch.config import lrw_dctcn_config

    # bs 96 x 29 frames, crop 96, DenseTCN 4 blocks x 3 layers, growth 384,
    # reduced 512, SE on, dropout 0.2, mixup (alpha 1), 1664-wide sync head, bf16
    return lrw_dctcn_config()


# the DC-TCN on LRW-1000 (both reference recipes): lrw1000's data and codec
LRW1000_DCTCN = {"model.encoder.kind": "dense_tcn"}


def lrw1000_dctcn_cfg():
    # lrw1000's bs 96 x 40 frames, 1000 labels, no word boundary, under
    # lrw_dctcn's DenseTCN: a 1664-wide head over 4 slots of 640 tokens, an
    # 8.5 MB bf16 weight, so K2 with two column passes, bf16
    return lrw1000_cfg().override(**LRW1000_DCTCN)


def bn_shapes():
    """Per path with BatchNorms, (N, C, launches per step) of every
    BatchNorm statistics call (``lrw_landmark`` has none)."""
    lrw, lrs3, audio = lrw_video_cfg(), lrs3_cfg(), lrs3_audio_cfg()
    lrw1000, dctcn, lrw1000_dctcn = lrw1000_cfg(), lrw_dctcn_cfg(), lrw1000_dctcn_cfg()
    long = lrs3_1800_cfg()
    half_lrw = lrw.override(**{"data.batch_size": lrw.data.batch_size // 2})
    # the parallel phase's (c) runs lrs3 at FILES_DEPTH
    half_lrs3 = lrs3.override(**{"data.batch_size": lrs3.data.batch_size // 2, **FILES_LAYERS})

    def conformer(cfg, frames):
        return (cfg.data.batch_size * frames, cfg.model.encoder.dim, cfg.model.encoder.layers)

    return {"lrw_video": trunk_bn_shapes(lrw, lrw.data.num_frames),
            "lrs3": trunk_bn_shapes(lrs3, LRS3_FRAMES) + [conformer(lrs3, LRS3_FRAMES)],
            "lrs3_audio": (resnet1d_bn_shapes(audio, AUDIO_FRAMES)
                           + [conformer(audio, AUDIO_FRAMES)]),
            "lrw1000": trunk_bn_shapes(lrw1000, lrw1000.data.num_frames),
            "lrw_dctcn": trunk_bn_shapes(dctcn, dctcn.data.num_frames),
            "lrw1000_dctcn": trunk_bn_shapes(lrw1000_dctcn, lrw1000_dctcn.data.num_frames),
            "lrs3_1800": (trunk_bn_shapes(long, LRS3_1800_FRAMES)
                          + [conformer(long, LRS3_1800_FRAMES)]),
            # lrs3's model and batch; the codec launches none of K1-K4
            "lrs3_instep": trunk_bn_shapes(lrs3, LRS3_FRAMES) + [conformer(lrs3, LRS3_FRAMES)],
            # a rank's half of lrw_video's and lrs3's batch at two processes
            "lrw_video_dp2": trunk_bn_shapes(half_lrw, lrw.data.num_frames),
            "lrs3_fsdp2": (trunk_bn_shapes(half_lrs3, LRS3_FRAMES)
                           + [conformer(half_lrs3, LRS3_FRAMES)]),
            # mesh.model=2: each rank's BatchNorms run on the gathered
            # channels of the whole batch, world 1's shapes
            "lrw_video_tp2": trunk_bn_shapes(lrw, lrw.data.num_frames),
            "lrs3_tp2": trunk_bn_shapes(lrs3, LRS3_FRAMES) + [conformer(lrs3, LRS3_FRAMES)],
            # mesh.seq=2: each rank's BatchNorms on its half of every clip's
            # frames (lrs3_1800 without remat)
            "lrs3_1800_sp2": (trunk_bn_shapes(long, LRS3_1800_FRAMES // 2)
                              + [conformer(long, LRS3_1800_FRAMES // 2)]),
            "lrs3_sp2": (trunk_bn_shapes(lrs3, LRS3_FRAMES // 2)
                         + [conformer(lrs3, LRS3_FRAMES // 2)]),
            # a seq rank's 80 frames (51200 samples) of lrs3_audio's clips
            "lrs3_audio_sp2": (resnet1d_bn_shapes(audio, AUDIO_FRAMES // 2)
                               + [conformer(audio, AUDIO_FRAMES // 2)])}


# K1's cases (N, D, V, every token ignored, the features' dtype, slots):
# lrw_video's, lrw_landmark's and lrw1000's shapes first (timed; the
# landmark and lrw1000 heads' features reach the wrapper in f32, as in
# their steps), then ragged row counts, D = 512 and 640 (bf16 rows TMA reads
# as they lie) and 520 (no copy, a ragged last stage), vocabularies below
# the 320 columns a block holds, no valid token; at V = 640 (two column
# passes) ragged rows, D = 513 and 520, a second pass of 80 columns (V =
# 400), and no valid token
MONO_CASES = [(29 * 96, 513, 320, False, "bfloat16", 8),
              (29 * 1024, 320, 320, False, "float32", 8),
              (40 * 96, 512, 640, False, "float32", 4),
              (1000, 513, 320, False, "bfloat16", 8), (33, 513, 320, False, "bfloat16", 8),
              (1, 513, 320, False, "bfloat16", 8), (1000, 320, 320, False, "float32", 8),
              (33, 320, 320, False, "float32", 8), (29 * 96, 512, 320, False, "bfloat16", 8),
              (29 * 96, 520, 320, False, "bfloat16", 8),
              (29 * 96, 640, 320, False, "bfloat16", 8),
              (29 * 96, 513, 256, False, "bfloat16", 8),
              (29 * 1024, 320, 256, False, "float32", 8),
              (29 * 96, 513, 320, True, "bfloat16", 8),
              (1000, 512, 640, False, "float32", 4), (33, 512, 640, False, "float32", 4),
              (1, 512, 640, False, "float32", 4), (40 * 96, 513, 640, False, "bfloat16", 4),
              (40 * 96, 520, 640, False, "bfloat16", 4),
              (1000, 512, 400, False, "bfloat16", 4), (40 * 96, 512, 640, True, "float32", 4),
              (29 * 48, 513, 320, False, "bfloat16", 8),
              # a model rank's 4 of 8 slots (mesh.model=2): lrs3's head at D = 768
              # (2.36 MiB, K1 by the 4 MiB rule) and lrw_video's
              (8 * 160, 768, 320, False, "bfloat16", 4),
              (29 * 96, 513, 320, False, "bfloat16", 4)]
# K2's cases: lrs3's, lrs3_audio's, lrw_dctcn's, lrw1000_dctcn's and
# lrs3_1800's shapes first (timed; the audio and DC-TCN heads' features in
# f32, as in their steps; lrw1000_dctcn's 4 slots of 640 in two column
# passes; lrs3_1800's 3600 rows of the 1800-frame bucket), then ragged
# row counts, a D that is no multiple of the 64-deep stage, a vocabulary
# below the 320 columns a block holds, and no valid token; at V = 640
# ragged rows, a D past the last full stage, a second pass of 80 columns
# (V = 400), and no valid token
SPLIT_CASES = [(8 * 160, 768, 320, False, "bfloat16", 8),
               (32 * 160, 768, 320, False, "float32", 8),
               (29 * 96, 1664, 320, False, "float32", 8),
               (40 * 96, 1664, 640, False, "float32", 4),
               (2 * 1800, 768, 320, False, "bfloat16", 8),
               (1000, 768, 320, False, "bfloat16", 8), (33, 768, 320, False, "bfloat16", 8),
               (1, 768, 320, False, "bfloat16", 8), (8 * 160, 776, 320, False, "bfloat16", 8),
               (8 * 160, 768, 256, False, "bfloat16", 8),
               (8 * 160, 768, 320, True, "bfloat16", 8),
               (1000, 1664, 640, False, "float32", 4), (33, 1664, 640, False, "bfloat16", 4),
               (1, 1664, 640, False, "float32", 4), (40 * 96, 1672, 640, False, "float32", 4),
               (40 * 96, 1664, 400, False, "float32", 4),
               (40 * 96, 1664, 640, True, "float32", 4),
               (4 * 160, 768, 320, False, "bfloat16", 8),
               # a seq rank's frames (mesh.seq=2) of lrs3_audio's 32 clips
               (32 * 80, 768, 320, False, "float32", 8),
               # and of lrs3_1800's 2 clips
               (2 * 900, 768, 320, False, "bfloat16", 8)]
# the case of each path's sync head, timed: the entry's own numbers are its
# first path's
SYNC_PATHS = {"sync_ce_fwd": {"lrw_video": MONO_CASES[0], "lrw_landmark": MONO_CASES[1],
                              "lrw1000": MONO_CASES[2], "lrw_video_dp2": MONO_CASES[-3],
                              "lrs3_tp2": MONO_CASES[-2], "lrw_video_tp2": MONO_CASES[-1]},
              "sync_ce_split_fwd": {"lrs3": SPLIT_CASES[0], "lrs3_audio": SPLIT_CASES[1],
                                    "lrw_dctcn": SPLIT_CASES[2],
                                    "lrw1000_dctcn": SPLIT_CASES[3],
                                    "lrs3_1800": SPLIT_CASES[4],
                                    "lrs3_fsdp2": SPLIT_CASES[-3],
                                    "lrs3_audio_sp2": SPLIT_CASES[-2],
                                    "lrs3_1800_sp2": SPLIT_CASES[-1]}}
# paths whose sync head has another path's shape: the same row (a seq
# rank's 8 x 80 frames of lrs3 are lrs3_fsdp2's 4 x 160 rows)
SYNC_SAME = {"lrs3_instep": "lrs3", "lrs3_sp2": "lrs3_fsdp2"}


def check_sync(torch, dev, kind, later):
    """K1 (``kind`` "mono", at ``MONO_CASES``) or K2 ("split", at
    ``SPLIT_CASES``) against their plain version, and twice on the same
    inputs, bitwise; each path's case of ``SYNC_PATHS`` timed. Appends to
    ``later`` the profiler windows that fill each path's ``device_ms`` (K1's
    with its features' pad copy, K2's with their cast)."""
    from syncvsr_tpu_torch.ops import cuda_sync

    if kind == "mono":
        name, fn, own = "K1 sync_ce_fwd", cuda_sync.sync_ce_mono_partials, "sync_ce_kernel"
        cases = MONO_CASES
    else:
        name, fn, own = ("K2 sync_ce_split_fwd", cuda_sync.sync_ce_split_partials,
                         "sync_ce_split_kernel")
        cases = SPLIT_CASES
    key = name.split()[1]
    timed = {case: path for path, case in SYNC_PATHS[key].items()}
    # every K1 case is K1's by the dispatch rule; K2's are its by the call
    # (the rule gives V = 256 at D = 768 to K1)
    for _, d0, v0, _, _, s0 in (cases if kind == "mono" else timed):
        if cuda_sync.uses_split_kernel(d0, s0, v0) != (kind == "split"):
            raise AssertionError(f"{name}: the dispatch rule does not pick it at D={d0}, "
                                 f"V={v0}")
    g = torch.Generator(device=dev).manual_seed(0)
    worst, paths = 0.0, {}
    for case in cases:
        n, d, v, ignored, dtype, s = case
        w = torch.randn(d, s * v, device=dev, generator=g) * 0.05
        b = torch.randn(s * v, device=dev, generator=g) * 0.1
        x = torch.randn(n, d, device=dev, generator=g).to(getattr(torch, dtype))
        tok = torch.randint(0, v, (n, s), device=dev, generator=g, dtype=torch.int32)
        tok[torch.rand(n, s, device=dev, generator=g) < 0.1] = -1
        if ignored:
            tok.fill_(-1)
        wb = w.to(torch.bfloat16)                  # the kernel's weight type
        ce, cnt = fn(x, wb, b, tok)
        ce_p, cnt_p = cuda_sync.sync_ce_partials_plain(x, wb, b, tok)
        torch.cuda.synchronize()
        err = abs(float(ce) - float(ce_p))
        worst = max(worst, err)
        # same bf16 operands, f32 accumulation in other orders: ~1e-8
        # relative expected on sums of ~1e4 terms; 1e-5 leaves room (1e-6
        # absolute where the sum is 0)
        tol = 1e-5 * abs(float(ce_p)) if float(ce_p) else 1e-6
        log(f"{name} [{n}, {d}] {dtype} x [{d}, {s}x{v}]{' all ignored' if ignored else ''}: "
            f"ce_sum {float(ce):.6f} vs plain {float(ce_p):.6f}, |err| {err:.3e} (tol "
            f"{tol:.3e}); count {float(cnt):.0f} vs {float(cnt_p):.0f}")
        if not (err <= tol and float(cnt) == float(cnt_p) == float((tok >= 0).sum())):
            raise AssertionError(f"{name} disagrees with its plain version at N={n}, D={d}, "
                                 f"V={v}")
        again = fn(x, wb, b, tok)
        if not (torch.equal(again[0], ce) and torch.equal(again[1], cnt)):
            raise AssertionError(f"{name}: two calls on the same inputs differ at N={n}, "
                                 f"D={d}, V={v}")
        if case not in timed:
            continue
        args = (x, wb, b, tok)
        ms = time_ms(lambda: fn(*args), CUDA)
        plain = time_ms(lambda: cuda_sync.sync_ce_partials_plain(*args), CUDA)
        b16, tok_l = b.to(torch.bfloat16), tok.reshape(-1).long()
        lib = library_ms(torch, lambda: torch.nn.functional.cross_entropy(
            torch.addmm(b16, x.to(torch.bfloat16), wb).reshape(n * s, v).float(), tok_l,
            ignore_index=-1, reduction="sum"), "cross_entropy(addmm)")
        parts = -(-n // 32) * s if kind == "mono" else -(-n // 64) * s
        nbytes = (n * d * x.element_size() + d * s * v * 2 + s * v * 4 + n * s * 4
                  + parts * 2 * 4)
        bound, by = bound_ms(2 * n * d * s * v, PEAK_BF16_FLOPS, nbytes)
        log(f"  {timed[case]}: kernel_ms {ms:.5f}  plain_ms {plain:.5f}  library_ms {lib}  "
            f"bound_ms {bound:.5f} ({by})")
        row = paths[timed[case]] = {"n": n, "d": d, "slots": s, "vocab": v,
                                    "features": dtype, "ms": ms,
                                    "device_ms": None, "plain_ms": plain, "bound_ms": bound,
                                    "bound_by": by, "library_ms": lib}

        def profiled(n=n, d=d, args=args, row=row):
            own_ms, own_calls, dev_calls, src, all_ms = device_ms(lambda: fn(*args),
                                                                  (own,))
            log(f"{name} [{n}, {d}]: device_ms {all_ms:.5f}, its own kernel {own_ms:.5f} "
                f"({src}; {own_calls} own and {dev_calls} device kernels a call)")
            if own_calls not in (None, 1):
                raise AssertionError(f"{name}: {own_calls} kernel launches a call, expected 1")
            row["device_ms"] = all_ms
            if row is main:
                entry["device_ms"] = all_ms

        later.append(profiled)
    for path, same in SYNC_SAME.items():
        if same in paths:
            paths[path] = paths[same]
    main = paths[next(iter(SYNC_PATHS[key]))]
    src, line = (("sync_ce.cu", 36) if kind == "mono" else ("sync_ce_split.cu", 66))
    entry = {"name": key, "route": "cuda", "source": f"syncvsr_tpu_torch/csrc/{src}",
             "replaces": f"syncvsr_tpu/ops/pallas_sync.py:{line}", "launches": 0,
             "max_abs_err": worst,
             **{k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
             "paths": paths}
    return entry


# K3's and K4's extra cases beside the paths' shapes: a ragged N, a
# one-strip call (its one group's fold writes the result), and the stem's
# shape on 2880 strips (5.5 waves of the last-block fold)
BN_EXTRA = [(1283, 768, None), (1, 768, None), (2949120, 64, 2880)]


def bn_inputs(torch, dev, n, c):
    """(x, g, mean, inv) of a BatchNorm at [n, c]: bf16 x and g from a seed
    of the shape, x's f32 batch mean and inverse standard deviation."""
    gen = torch.Generator(device=dev).manual_seed(1000 * n + c)
    x = (torch.randn(n, c, device=dev, generator=gen) * 2 + 0.5).to(torch.bfloat16)
    gy = torch.randn(n, c, device=dev, generator=gen).to(torch.bfloat16)
    x32 = x.float()
    return x, gy, x32.mean(0), torch.rsqrt(x32.var(0, unbiased=False) + 1e-5)


def check_bn(torch, dev, later):
    """K3 and K4 at every BatchNorm shape of the train steps that have
    them (``bn_shapes()``) and at ``BN_EXTRA``, in bf16; each twice on the
    same inputs, bitwise. Each entry's own times are per step of the lrs3
    step (the per-shape times weighted by the launches per step); ``paths``
    has every step's sums and their per-shape rows. Appends to ``later`` the profiler windows of every
    timed shape, then the job that fills the entries' ``device_ms``.
    Returns (the two entries, a function that times K4 at the Conformer's
    shape again)."""
    from syncvsr_tpu_torch.ops import cuda_bn

    paths = bn_shapes()
    path_shapes = {(n, c) for shapes in paths.values() for n, c, _ in shapes}
    cases = sorted((n, c, None) for n, c in path_shapes) + BN_EXTRA
    conformer = paths["lrs3"][-1][:2]
    measured = {}                                # (kind, n, c) -> per-shape numbers
    for n, c, strips in cases:
        timed = (n, c) in path_shapes and strips is None
        x, gy, mean, inv = bn_inputs(torch, dev, n, c)
        x32 = x.float()
        xhat_abs = ((x32 - mean) * inv).abs()
        fwd, bwd = ((lambda *a: cuda_bn.bn_stats(*a, strips=strips),
                     lambda *a: cuda_bn.bn_bwd_stats(*a, strips=strips)) if strips
                    else (cuda_bn.bn_stats, cuda_bn.bn_bwd_stats))
        # f32 sums of n values in other orders: the error is a small share
        # of the sum of magnitudes; 1e-5 of it leaves a 10x margin
        for kind, kern, plain, args, mags in (
                ("fwd", fwd, cuda_bn.bn_stats_plain, (x,),
                 (x32.abs().sum(0), (x32 * x32).sum(0))),
                ("bwd", bwd, cuda_bn.bn_bwd_stats_plain, (gy, x, mean, inv),
                 (gy.float().abs().sum(0), (gy.float().abs() * xhat_abs).sum(0)))):
            got = kern(*args)
            want = plain(*args)
            err = max(float((a - e).abs().max()) for a, e in zip(got, want))
            ratio = max(float(((a - e).abs() / (1e-5 * m + 1e-6)).max())
                        for a, e, m in zip(got, want, mags))
            name = "K3 bn_stats_fwd" if kind == "fwd" else "K4 bn_stats_bwd"
            how = f", {strips} strips" if strips else ""
            log(f"{name} [{n}, {c}] bf16{how}: max |err| {err:.3e}, worst err/tol {ratio:.3f}")
            if not ratio <= 1.0:
                raise AssertionError(f"{name} disagrees with its plain version at [{n}, {c}]")
            again = kern(*args)
            if not all(torch.equal(a, b) for a, b in zip(again, got)):
                raise AssertionError(f"{name}: two calls on the same inputs differ at "
                                     f"[{n}, {c}]")
            if not timed:
                measured[kind, n, c, strips] = {"max_abs_err": err}
                continue
            ms = time_ms(lambda: kern(*args), CUDA)
            plain_t = time_ms(lambda: plain(*args), CUDA)
            if kind == "fwd":
                lib = library_ms(torch, lambda: torch.batch_norm_stats(x, 1e-5),
                                 "batch_norm_stats")
                nbytes, flops = n * c * 2 + 2 * c * 4, 3 * n * c
            else:
                lib = library_ms(torch, lambda: torch.batch_norm_backward_reduce(
                    gy, x, mean, inv, None, True, False, False), "batch_norm_backward_reduce")
                nbytes, flops = 2 * n * c * 2 + 4 * c * 4, 5 * n * c
                if (n, c) == conformer:
                    retime = (lambda kern=kern, args=args:
                              time_ms(lambda: kern(*args), CUDA))
            bound, by = bound_ms(flops, PEAK_F32_FLOPS, nbytes)
            log(f"  kernel_ms {ms:.5f}  plain_ms {plain_t:.5f}  library_ms {lib}  "
                f"bound_ms {bound:.5f} ({by})")
            row = measured[kind, n, c, None] = {
                "max_abs_err": err, "ms": ms, "device_ms": None, "plain_ms": plain_t,
                "library_ms": lib, "bound_ms": bound, "bound_by": by}
            # the window makes its inputs again, so that none is held meanwhile
            later.append(lambda name=name, n=n, c=c, kind=kind, kern=kern, row=row:
                         profile_bn(torch, dev, name, n, c, kind, kern, row))
        del x, gy, mean, inv, x32, xhat_abs, args, mags, got, want
        torch.cuda.empty_cache()

    def per_step(kind, shapes, remat):
        # under model.remat K3 runs again in each BatchNorm's recompute
        twice = 2 if remat and kind == "fwd" else 1
        rows = [dict(measured[kind, n, c, None], n=n, c=c, launches_per_step=k * twice)
                for n, c, k in shapes]

        def total(key):
            if any(r[key] is None for r in rows):
                return None
            return sum(r["launches_per_step"] * r[key] for r in rows)

        return {"launches_per_step": sum(r["launches_per_step"] for r in rows),
                "bound_by": rows[0]["bound_by"], "ms": total("ms"),
                "device_ms": total("device_ms"), "plain_ms": total("plain_ms"),
                "bound_ms": total("bound_ms"), "library_ms": total("library_ms"),
                "shapes": [{k: r[k] for k in ("n", "c", "launches_per_step", "ms",
                                              "device_ms", "bound_ms", "library_ms")}
                           for r in rows]}

    def entry(name, src_line, kind):
        errs = [m["max_abs_err"] for (k, *_), m in measured.items() if k == kind]
        by_path = {p: per_step(kind, shapes, p in REMAT_PATHS) for p, shapes in paths.items()}
        main = by_path["lrs3"]
        return {"name": name, "route": "cuda", "source": "syncvsr_tpu_torch/csrc/bn_stats.cu",
                "replaces": f"syncvsr_tpu/ops/pallas_bn.py:{src_line}", "launches": 0,
                "max_abs_err": max(errs), "ms": main["ms"], "device_ms": main["device_ms"],
                "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"],
                "paths": by_path}

    entries = [{"name": "bn_stats_fwd"}, {"name": "bn_stats_bwd"}]

    def fill():
        entries[0].update(entry("bn_stats_fwd", 47, "fwd"))
        entries[1].update(entry("bn_stats_bwd", 68, "bwd"))

    later.append(fill)
    return entries, retime


# the stem BatchNorm of the lrs3 preset's own batch (16) at the 1800-frame
# bucket: 4.25e9 elements, past 2^31 (the kernels index in 64 bits)
BN_PAST_INT32 = (16 * LRS3_1800_FRAMES * 48 * 48, 64)


def check_bn_past_int32(torch, dev):
    """K3 and K4 at ``BN_PAST_INT32`` in bf16 against f64 sums taken in
    chunks of rows (the plain versions' f32 copies of 8.5 GB inputs would
    not fit beside them), each twice, bitwise; with their time a call.
    Returns the numbers."""
    from syncvsr_tpu_torch.ops import cuda_bn

    n, c = BN_PAST_INT32
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.empty(n, c, device=dev, dtype=torch.bfloat16)
    gy = torch.empty_like(x)
    chunk = 1 << 22
    for i in range(0, n, chunk):
        rows = min(chunk, n - i)
        x[i:i + rows] = (torch.randn(rows, c, device=dev, generator=gen) * 2 + 0.5)
        gy[i:i + rows] = torch.randn(rows, c, device=dev, generator=gen)

    def sums(fn):
        out = None
        for i in range(0, n, chunk):
            part = [t.double().sum(0) for t in fn(slice(i, i + chunk))]
            out = part if out is None else [a + b for a, b in zip(out, part)]
        return out

    s1, s2 = sums(lambda r: (x[r].float(), x[r].float() ** 2))
    mean = (s1 / n).float()
    inv = torch.rsqrt((s2 / n - (s1 / n) ** 2).float() + 1e-5)
    out = {"n": n, "c": c, "elements": n * c}
    for kind, kern, args, want, mags in (
            ("fwd", cuda_bn.bn_stats, (x,), [s1, s2],
             sums(lambda r: (x[r].float().abs(), x[r].float() ** 2))),
            ("bwd", cuda_bn.bn_bwd_stats, (gy, x, mean, inv),
             sums(lambda r: (gy[r].float(), gy[r].float() * (x[r].float() - mean) * inv)),
             sums(lambda r: (gy[r].float().abs(),
                             (gy[r].float() * (x[r].float() - mean) * inv).abs())))):
        got = [t.double() for t in kern(*args)]
        ratio = max(float(((a - e).abs() / (1e-5 * m + 1e-6)).max())
                    for a, e, m in zip(got, want, mags))
        again = kern(*args)
        same = all(torch.equal(a.double(), b) for a, b in zip(again, got))
        ms = time_ms(lambda: kern(*args), CUDA, iters=5, warmup=1)
        # as check_bn counts them: each input read once, the sums written once
        bound, by = (bound_ms(3 * n * c, PEAK_F32_FLOPS, n * c * 2 + 2 * c * 4) if kind == "fwd"
                     else bound_ms(5 * n * c, PEAK_F32_FLOPS, 2 * n * c * 2 + 4 * c * 4))
        name = "K3 bn_stats_fwd" if kind == "fwd" else "K4 bn_stats_bwd"
        log(f"{name} [{n}, {c}] bf16 ({n * c} elements, past 2^31): worst err/tol "
            f"{ratio:.3f} against chunked f64 sums; second call bitwise equal: {same}; "
            f"kernel_ms {ms:.5f}  bound_ms {bound:.5f} ({by})")
        if not (ratio <= 1.0 and same):
            raise AssertionError(f"{name} at [{n}, {c}]: err/tol {ratio}, bitwise {same}")
        out[kind] = {"worst_err_over_tol": ratio, "ms": ms, "bound_ms": bound, "bound_by": by}
    del x, gy
    torch.cuda.empty_cache()
    return out


def profile_bn(torch, dev, name, n, c, kind, kern, row):
    """K3's or K4's device time at [n, c] (``bn_inputs``) into ``row``; each
    must be one device kernel a call."""
    x, gy, mean, inv = bn_inputs(torch, dev, n, c)
    args = (x,) if kind == "fwd" else (gy, x, mean, inv)
    # the kernels' names, and those of K3's first two-kernel version, which
    # tools/bn_shapes.py --root may time in an older tree
    own = (("stats_fwd_fused", "stats_fwd_partial", "sum_strips") if kind == "fwd"
           else ("stats_bwd_fused",))
    dev_ms, own_calls, dev_calls, src, _ = device_ms(lambda: kern(*args), own)
    log(f"{name} [{n}, {c}]: device_ms {dev_ms:.5f} ({src}; {own_calls} own and {dev_calls} "
        "device kernels a call)")
    if dev_calls not in (None, 1):
        raise AssertionError(f"{name} [{n}, {c}]: {dev_calls} device kernels a call, expected 1")
    row["device_ms"] = dev_ms


def counters():
    """The kernels' wrappers by name (imported here: the script must run
    without the package to fail there)."""
    from syncvsr_tpu_torch.ops import kernel_wrappers

    return kernel_wrappers()


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    from syncvsr_tpu_torch.ops import launch_counts

    return launch_counts()


def relu_layers(model):
    """name -> the first layer of each ReLU feed-forward (the Conformer's
    and the decoder's): its output is the ReLU's input."""
    from syncvsr_tpu_torch.models.conformer import ConformerFeedForward
    from syncvsr_tpu_torch.models.decoder import FF
    from syncvsr_tpu_torch.models.layers import SELayer1D

    layers = {f"{n}.w1": m.w1 for n, m in model.named_modules()
              if isinstance(m, (ConformerFeedForward, FF))}
    # the DC-TCN's squeeze-excitation: ReLU after Dense_0
    layers.update({f"{n}.Dense_0": m.Dense_0 for n, m in model.named_modules()
                   if isinstance(m, SELayer1D)})
    return layers


def zero_gradient_leaves(model):
    """Leaves whose true gradient is 0: the key bias of attention without
    RoPE (the softmax cancels a per-query constant), and the bias of a conv
    that a train-mode BatchNorm follows (it subtracts the mean): the
    Conformer's depthwise conv, the DC-TCN's branch convs."""
    from syncvsr_tpu_torch.models.conformer import ConvModule, RelPositionAttention
    from syncvsr_tpu_torch.models.decoder import MHA
    from syncvsr_tpu_torch.models.dense_tcn import TemporalConvLayer

    return ({f"{n}.wk.bias" for n, m in model.named_modules()
             if isinstance(m, (RelPositionAttention, MHA))}
            | {f"{n}.dw.bias" for n, m in model.named_modules() if isinstance(m, ConvModule)}
            | {f"{n}.conv.bias" for n, m in model.named_modules()
               if isinstance(m, TemporalConvLayer)})


def run_steps(torch, cfg, batch_np, device, n_steps, aug_fn):
    """Build the model on ``device`` (the same seeded weights on every
    device; the DC-TCN's dropout, fixed at 0.2, set to 0) and run
    ``n_steps`` train steps; returns (state, metrics of each step, {ReLU
    layer: its output in each step, on the CPU})."""
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.models.dense_tcn import MultiKernelLayer

    model = build_model(cfg, device=device)
    for m in model.modules():
        if isinstance(m, MultiKernelLayer):
            m.rate = 0.0
    relu_in = {}
    for name, layer in relu_layers(model).items():
        layer.register_forward_hook(lambda m, i, o, name=name: relu_in.setdefault(
            name, []).append(o.detach().cpu()))
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch_np.items()}
    state = create_train_state(cfg, model, batch, device=device)
    step = build_train_step(aug_fn=aug_fn)
    out = []
    for _ in range(n_steps):
        state, m = step(state, batch)
        out.append({k: float(v) for k, v in m.items()})
    return state, out, relu_in


def relu_flips(cpu_in, gpu_in):
    """Where f32 rounding leaves a ReLU's input on the other side of 0 on
    the card than on the CPU, that unit's row of the first layer's gradient
    (and its bias entry) differs by a whole term. Returns ({leaf: units to
    leave out of the gradient comparison}, the number of flips, the largest
    |input| that flipped as a share of its layer's largest, the number of
    inputs compared)."""
    skip, flips, worst, seen = {}, 0, 0.0, 0
    for name, steps in cpu_in.items():
        for hc, hg in zip(steps, gpu_in[name]):
            seen += hc.numel()
            flip = (hc > 0) != (hg > 0)
            if not bool(flip.any()):
                continue
            flips += int(flip.sum())
            worst = max(worst, float(hc[flip].abs().max()) / float(hc.abs().max()))
            units = flip.reshape(-1, flip.shape[-1]).any(0).nonzero()[:, 0].tolist()
            for leaf in (f"{name}.weight", f"{name}.bias"):
                skip.setdefault(leaf, set()).update(units)
    return skip, flips, worst, seen


def with_infeasible_row(batch):
    """The sentence batch with its last clip cut to one frame fewer than its
    labels: a row with no CTC alignment, whose loss is optax's log-epsilon
    one (~1e5), computed by the port's recursion (``ops/ctc.py``)."""
    lengths = batch["lengths"].copy()
    lengths[-1] = int((batch["labels"][-1] != -1).sum()) - 1
    return dict(batch, lengths=lengths)


def with_attention_mask(np, batch, seed):
    """The batch with the LRW loader's ``attention_mask``: every 5th clip
    padded over its last 1-4 frames (a clip shorter than the preset)."""
    b, t = batch["inputs"].shape[:2]
    am = np.ones((b, t), np.float32)
    rng = np.random.RandomState(seed + 2)
    for i in range(0, b, 5):
        am[i, t - rng.randint(1, 5):] = 0.0
    return dict(batch, attention_mask=am)


# the paths, in the order the phases run them, and the kernels each runs
# (the others must not launch there)
PATH_KERNELS = {"lrw_video": {"sync_ce_fwd", "bn_stats_fwd", "bn_stats_bwd"},
                "lrs3": {"sync_ce_split_fwd", "bn_stats_fwd", "bn_stats_bwd"},
                "lrw_landmark": {"sync_ce_fwd"},
                "lrs3_audio": {"sync_ce_split_fwd", "bn_stats_fwd", "bn_stats_bwd"},
                "lrw1000": {"sync_ce_fwd", "bn_stats_fwd", "bn_stats_bwd"},
                "lrw_dctcn": {"sync_ce_split_fwd", "bn_stats_fwd", "bn_stats_bwd"},
                "lrw1000_dctcn": {"sync_ce_split_fwd", "bn_stats_fwd", "bn_stats_bwd"},
                "lrs3_1800": {"sync_ce_split_fwd", "bn_stats_fwd", "bn_stats_bwd"},
                "lrs3_instep": {"sync_ce_split_fwd", "bn_stats_fwd", "bn_stats_bwd"}}


def f32_sentence_aug(torch, d):
    """``build_sentence_aug``'s recipe with f32 clips out: over 320 frames a
    few of the bf16 clips' pixels round to the other side of a tie on the
    card than on the CPU (the resize's sums differ in the last bit), and
    each moves the ReLU inputs downstream by ~1e-4 of their scale."""
    from syncvsr_tpu_torch.ops.image import TrainAug, build_sentence_aug, fused_train_aug_apply

    def apply(batch, drawn):
        return dict(batch, videos=fused_train_aug_apply(batch["videos"], drawn, d.crop_size,
                                                        d.mean, d.std, torch.float32))

    return TrainAug(build_sentence_aug(d).draw, apply)


def check_reference(torch, np, path):
    """Two f32 train steps of a small model through the kernels on the card
    against the same steps through the plain versions on the CPU. The
    augmentation (and CutMix) draw from the same CPU generator on both
    sides; dropout is off."""
    from syncvsr_tpu_torch import config
    from syncvsr_tpu_torch.data.synthetic import sentence_batch
    from syncvsr_tpu_torch.ops.image import build_sentence_aug, build_word_aug

    common = {"model.dtype": "float32", "model.encoder.msa_dropout": 0.0,
              "model.encoder.mlp_dropout": 0.0, "data.crop_size": 32,
              "optim.total_steps": 10, "optim.warmup_steps": 2}
    word_keys = ("loss", "loss_word", "loss_audio", "grad_norm", "learning_rate")
    sentence_keys = ("loss", "loss_ctc", "loss_att", "loss_audio", "grad_norm",
                     "learning_rate")
    word = {"model.encoder.layers": 2, "model.encoder.dim": 64, "model.encoder.heads": 2,
            "model.encoder.emb_dropout": 0.0, "data.batch_size": 4, "data.num_frames": 8}
    # small but for the Conformer's width, 768, which keeps the sync head on
    # K2; the 64-wide decoder takes proj_decoder
    sentence = {"model.encoder.layers": 2, "model.encoder.dim": 768,
                "model.encoder.heads": 12, "model.frontend.resnet_width": 16,
                "model.decoder.layers": 1, "model.decoder.dim": 64, "model.decoder.heads": 4,
                "model.decoder.hidden": 128, "model.decoder.dropout": 0.0,
                "model.labels": 101, "data.batch_size": 4}
    aug = None
    if path == "lrw_video":
        cfg = config.lrw_video_config().override(
            **common, **word, **{"model.frontend.resnet_width": 16})
        batch = uint8_clips(cfg, seed=3)
        aug = build_word_aug(cfg.data)
        keys = word_keys
    elif path == "lrw_landmark":
        # 1434 landmark features, the -100 pad sentinel in two clips' last
        # frames; CutMix on, drop-path off
        cfg = config.lrw_landmark_config().override(
            **common, **word, **{"model.encoder.droppath": 0.0})
        batch = landmark_clips(cfg, seed=3)
        keys = word_keys
    elif path == "lrw1000":
        # the wav2vec2 codec's 2 x 2 slots of 640 over a 64-wide stream: K1
        # (two column passes); no word boundary
        cfg = config.lrw1000_config().override(
            **common, **word, **{"model.frontend.resnet_width": 16})
        batch = uint8_clips(cfg, seed=3)
        aug = build_word_aug(cfg.data)
        keys = word_keys
    elif path == "lrw_dctcn":
        # one dense layer (growth 384) over the 512-wide transition: an
        # 896-wide head, over the 4 MiB rule, so K2, twice a step under mixup
        cfg = config.lrw_dctcn_config().override(
            **common, **{"model.encoder.tcn_blocks": (1,),
                         "model.encoder.tcn_growth_rates": (384,),
                         "model.frontend.resnet_width": 16, "data.batch_size": 4,
                         "data.num_frames": 8})
        batch = with_attention_mask(np, uint8_clips(cfg, seed=3), 3)
        aug = build_word_aug(cfg.data)
        keys = word_keys
    elif path == "lrw1000_dctcn":
        # the same one-layer DC-TCN over lrw1000's data: an 896-wide head
        # over 4 slots of 640 (4.6 MB of bf16 weight), so K2's two column
        # passes, twice a step under mixup
        cfg = config.lrw1000_config().override(
            **common, **LRW1000_DCTCN, **{"model.encoder.tcn_blocks": (1,),
                                          "model.encoder.tcn_growth_rates": (384,),
                                          "model.frontend.resnet_width": 16,
                                          "data.batch_size": 4, "data.num_frames": 8})
        batch = with_attention_mask(np, uint8_clips(cfg, seed=3), 3)
        aug = build_word_aug(cfg.data)
        keys = word_keys
    elif path == "lrs3":
        cfg = config.lrs3_config().override(**common, **sentence)
        # 16 frames, clips of >= 8 and labels of <= 4, but the last clip is
        # cut below its label count: the CTC recursion of infeasible rows
        # runs on the card and on the CPU
        batch = with_infeasible_row(uint8_sentences(cfg, 16, 4, 40, seed=3))
        aug = build_sentence_aug(cfg.data)
        keys = sentence_keys
    elif path == "lrs3_1800":
        # lrs3_1800's options on lrs3's small model: model.remat and
        # optim.accum_steps=2 (two mini-steps of one batch, one update), at
        # a 320-frame bucket, so the sync head's backward runs in chunks of
        # 128 frames (T > 256)
        cfg = config.lrs3_config().override(
            **common, **sentence, **{"model.remat": True, "optim.accum_steps": 2})
        batch = uint8_sentences(cfg, 320, 48, 40, seed=3)
        aug = f32_sentence_aug(torch, cfg.data)
        keys = sentence_keys
    elif path == "lrs3_instep":
        # lrs3's reference (its batch, the infeasible row included) with the
        # sync targets the separated codec (vq-wav2vec's geometry, 320 codes)
        # makes inside the step from 16 frames of 640 samples a clip: the
        # same tokens on both sides
        cfg = config.lrs3_config().override(**common, **sentence, **{
            "model.codec.in_step": True, "model.codec.ckpt": CODECS["separated"]})
        batch = instep_batch(np, with_infeasible_row(uint8_sentences(cfg, 16, 4, 40,
                                                                     seed=3)), seed=3)
        aug = instep_aug(cfg, build_sentence_aug(cfg.data))
        keys = sentence_keys
    else:
        # 16 frames of 640 samples, clips of >= 8 frames, as lrs3's
        cfg = config.lrs3_audio_config().override(**common, **sentence)
        batch = sentence_batch(cfg, num_frames=16, label_len=4, seed=3)
        keys = sentence_keys
    cpu_state, cpu_m, cpu_relu = run_steps(torch, cfg, batch, "cpu", 2, aug)
    before = read_counts()
    gpu_state, gpu_m, gpu_relu = run_steps(torch, cfg, batch, "cuda", 2, aug)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in read_counts().items()}
    log(f"reference {path}: 2 f32 steps of a small model, card vs CPU; launches {launched}"
        + (f"; updates applied {gpu_state.count} (card), {cpu_state.count} (CPU)"
           if cfg.optim.accum_steps > 1 else ""))
    if cfg.optim.accum_steps > 1 and not gpu_state.count == cpu_state.count == 1:
        raise AssertionError(f"{path}: 2 mini-steps at accum_steps 2 applied "
                             f"{gpu_state.count} updates")
    log(f"  card step 1: {gpu_m[0]}")
    log(f"  cpu  step 1: {cpu_m[0]}")
    if path == "lrs3" and not min(m["loss_ctc"] for m in cpu_m + gpu_m) > 1e4:
        raise AssertionError("lrs3: the infeasible row's log-epsilon loss is missing")
    for k, n in launched.items():
        if (n > 0) != (k in PATH_KERNELS[path]):
            raise AssertionError(f"reference {path}: launches {launched}, expected exactly "
                                 f"{sorted(PATH_KERNELS[path])}")
    if path in REMAT_PATHS and launched["bn_stats_fwd"] != 2 * launched["bn_stats_bwd"]:
        raise AssertionError(f"reference {path}: under remat K3 runs twice a BatchNorm: "
                             f"{launched}")
    # f32 on both sides with TF32 off. K1/K2 round the sync head's operands
    # to bf16 where the CPU head stays f32 (as on the TPU and CPU in the JAX
    # package), which moves loss_audio by ~1e-4 relative; the rest are f32
    # sums in other orders
    worst = 0.0
    for i, (a, e) in enumerate(zip(gpu_m, cpu_m)):
        for k in keys:
            rel = abs(a[k] - e[k]) / max(abs(e[k]), 1e-12)
            worst = max(worst, rel)
            if not (math.isfinite(a[k]) and rel <= 2e-3):
                raise AssertionError(f"{path} step {i + 1} {k}: card {a[k]} vs CPU {e[k]}")
    # Adam's first moment holds every (clipped) gradient of both steps; the
    # backward is f32 on both sides, so it agrees to f32 noise, held at
    # 2e-3 of each leaf's largest element. Two kinds of entries are held
    # apart: the ReLU units whose input flipped sign (relu_flips: only
    # inputs within rounding of 0 may flip, and only a few), and the leaves
    # whose true gradient is 0, which must hold rounding noise on both sides
    skip, flips, flip_size, seen = relu_flips(cpu_relu, gpu_relu)
    log(f"  ReLU inputs that changed sign: {flips} of {seen}, the largest {flip_size:.2e} of its "
        f"layer's largest; rows left out: { {k: sorted(v) for k, v in skip.items()} }")
    # a few (4, or 2 in a million of the inputs where there are millions:
    # lrs3_1800's 320-frame batch, with its recomputes, has ~6e7)
    if flips > max(4, 2e-6 * seen) or flip_size > 1e-5:
        raise AssertionError(f"{path}: {flips} ReLU inputs changed sign, up to {flip_size} "
                             "of their layer's largest: more than f32 rounding")
    zero = zero_gradient_leaves(cpu_state.model)
    top = max(float(c_mu.abs().max()) for c_mu in cpu_state.mu)
    ratios, noise = [], 0.0
    for name, g_mu, c_mu in zip(cpu_state.names, gpu_state.mu, cpu_state.mu):
        g_mu = g_mu.cpu()
        if name in zero:
            noise = max(noise, float(g_mu.abs().max()) / top, float(c_mu.abs().max()) / top)
            continue
        keep = torch.ones(c_mu.shape[0], dtype=torch.bool)
        keep[sorted(skip.get(name, ()))] = False
        sc = float(c_mu[keep].abs().max())
        if sc > 0:
            ratios.append((float((g_mu - c_mu)[keep].abs().max()) / sc, name, sc))
    ratios.sort(reverse=True)
    mu_ratio = ratios[0][0]
    log(f"  worst metric rel err {worst:.3e}; worst Adam mu err / leaf scale {mu_ratio:.3e}; "
        "worst leaves " + ", ".join(f"{n} {r:.2e} (scale {sc:.2e})" for r, n, sc in ratios[:4])
        + f"; {len(zero)} zero-gradient leaves hold up to {noise:.2e} of the largest leaf")
    if not mu_ratio <= 2e-3:
        raise AssertionError(f"{path}: gradients disagree: mu err / scale {mu_ratio}")
    if not noise <= 1e-6:
        raise AssertionError(f"{path}: a leaf whose true gradient is 0 holds {noise} of the "
                             "largest leaf's Adam moment")


def train_full_width(torch, np, path, profile_dir=None):
    """The full-width train step of ``path``; returns (launches in the timed
    steps, summary, the window to run after every timing, or None: where
    the timed steps replayed a CUDA graph, ``replayed_launches``; with
    ``profile_dir``, the profiled steps)."""
    from syncvsr_tpu_torch.data.synthetic import sentence_batch
    from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops import image
    from syncvsr_tpu_torch.utils.profiling import graph_counts

    aug = transform = None
    near_ln = {}
    if path == "lrw_video":
        cfg = lrw_video_cfg()
        batch_np = uint8_clips(cfg, seed=0)
        frames, video = cfg.data.num_frames, "inputs"
        aug, transform = image.build_word_aug(cfg.data), image.build_eval_transform(cfg.data)
        near_ln["loss_word"] = cfg.model.labels
        per_step = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0,
                    "bn_stats_fwd": 20, "bn_stats_bwd": 20}
    elif path == "lrs3":
        cfg = lrs3_cfg()
        batch_np = uint8_sentences(cfg, LRS3_FRAMES, LRS3_LABEL_LEN, LRS3_SOURCE, seed=0)
        frames, video = LRS3_FRAMES, "videos"
        aug = image.build_sentence_aug(cfg.data)
        transform = image.build_sentence_eval_transform(cfg.data)
        # 20 in the frontend's trunk, 12 in the Conformer's conv modules
        per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1,
                    "bn_stats_fwd": 32, "bn_stats_bwd": 32}
    elif path == "lrw1000":
        cfg = lrw1000_cfg()
        batch_np = uint8_clips(cfg, seed=0)
        frames, video = cfg.data.num_frames, "inputs"
        aug, transform = image.build_word_aug(cfg.data), image.build_eval_transform(cfg.data)
        near_ln["loss_word"] = cfg.model.labels
        per_step = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0,
                    "bn_stats_fwd": 20, "bn_stats_bwd": 20}
    elif path == "lrw_dctcn":
        cfg = lrw_dctcn_cfg()
        batch_np = with_attention_mask(np, uint8_clips(cfg, seed=0), 0)
        frames, video = cfg.data.num_frames, "inputs"
        aug, transform = image.build_word_aug(cfg.data), image.build_eval_transform(cfg.data)
        near_ln["loss_word"] = cfg.model.labels
        # mixup lerps the sync loss between own and rolled tokens: K2 twice
        per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 2,
                    "bn_stats_fwd": 20, "bn_stats_bwd": 20}
    elif path == "lrw1000_dctcn":
        cfg = lrw1000_dctcn_cfg()
        batch_np = with_attention_mask(np, uint8_clips(cfg, seed=0), 0)
        frames, video = cfg.data.num_frames, "inputs"
        aug, transform = image.build_word_aug(cfg.data), image.build_eval_transform(cfg.data)
        near_ln["loss_word"] = cfg.model.labels
        # K2 at V = 640, twice a step under mixup
        per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 2,
                    "bn_stats_fwd": 20, "bn_stats_bwd": 20}
    elif path == "lrw_landmark":
        # no augmentation function (bench.py::bench_landmark); CutMix,
        # dropout and drop-path as configured
        cfg = lrw_landmark_cfg()
        batch_np = landmark_clips(cfg, seed=0)
        frames, video = cfg.data.num_frames, "inputs"
        near_ln["loss_word"] = cfg.model.labels
        per_step = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0,
                    "bn_stats_fwd": 0, "bn_stats_bwd": 0}
    else:
        # no augmentation function (bench.py::bench_audio); lengths in samples
        cfg = lrs3_audio_cfg()
        batch_np = sentence_batch(cfg, num_frames=AUDIO_FRAMES, label_len=AUDIO_LABEL_LEN,
                                  seed=0)
        frames, video = AUDIO_FRAMES, "videos"
        # 20 in ResNet1D, 12 in the Conformer's conv modules
        per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1,
                    "bn_stats_fwd": 32, "bn_stats_bwd": 32}
    near_ln["loss_audio"] = cfg.model.codec.audio_vocab_size
    dev = torch.device("cuda")
    # what the process holds before this path (the other path's state, kept
    # for its profiled window) is left out of this path's peak
    held = torch.cuda.memory_allocated()
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    b = cfg.data.batch_size
    enc = cfg.model.encoder
    trunk = (f"{enc.kind} {enc.layers} layers, dim {enc.dim}" if enc.kind != "dense_tcn" else
             f"dense_tcn blocks {enc.tcn_blocks}, growth {enc.tcn_growth_rates}, reduced "
             f"{enc.tcn_reduced_size}")
    log(f"train: {path}, {video} {tuple(batch[video].shape)} {batch[video].dtype}, "
        f"{trunk}, dtype {cfg.model.dtype}, "
        f"sync head {cfg.model.codec.audio_alignment * cfg.model.codec.vq_groups} slots of "
        f"{cfg.model.codec.audio_vocab_size}")
    model = build_model(cfg)
    n_params = sum(p.numel() for p in model.parameters())
    state = create_train_state(cfg, model, batch)
    step = build_train_step(aug_fn=aug)
    first = None
    for i in range(WARMUP_STEPS):
        state, m = step(state, batch)
        if first is None:
            first = {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    log(f"  {n_params} parameters; first step {first}")
    # random init: the heads start near ln(classes)
    for k, classes in near_ln.items():
        if not abs(first[k] - math.log(classes)) < 1.0:
            raise AssertionError(f"first-step {k} {first[k]} is far from "
                                 f"ln {classes} = {math.log(classes):.3f}")
    if not all(math.isfinite(v) for v in first.values()):
        raise AssertionError(f"non-finite first-step metrics: {first}")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    graphs0 = graph_counts()
    windows = []
    for _ in range(2):
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, m = step(state, batch)
        torch.cuda.synchronize()
        windows.append((time.perf_counter() - t0) / TIMED_STEPS)
    dt = sum(windows) / len(windows)
    launches = read_counts()
    graphs = graph_counts_since(graphs0)
    last = {k: float(v) for k, v in m.items()}
    peak = torch.cuda.max_memory_allocated() - held
    if not all(math.isfinite(v) for v in last.values()):
        raise AssertionError(f"non-finite metrics: {last}")
    want = {k: n * TIMED_STEPS * len(windows) for k, n in per_step.items()}
    log(f"  {TIMED_STEPS * len(windows)} timed steps: {dt * 1e3:.2f} ms/step (windows of "
        f"{TIMED_STEPS}: {', '.join(f'{w * 1e3:.2f}' for w in windows)} ms/step), "
        f"{b * frames / dt:.1f} frames/s, peak memory {peak / 2**30:.2f} GiB (above "
        f"{held / 2**30:.2f} GiB held before the path); last step {last}")
    log(f"  launches {launches} (expected {want}); the timed steps ran {graphs}")
    if launches != want:
        raise AssertionError(f"{path}: launches {launches} != {want}")
    before = read_counts()
    ev = build_eval_step()(state, transform(batch) if transform else batch)
    ev = {k: float(v) for k, v in ev.items()}
    torch.cuda.synchronize()
    log(f"  eval step: {ev}")
    if not all(math.isfinite(v) for v in ev.values()):
        raise AssertionError(f"non-finite eval metrics: {ev}")
    sync = next(k for k, n in per_step.items() if k.startswith("sync") and n)
    got = {k: v - before[k] for k, v in read_counts().items() if k.startswith("sync")}
    if got != {k: int(k == sync) for k in got}:
        raise AssertionError(f"the {path} eval step launched {got}, expected one {sync}")
    summary = {"step_ms": dt * 1e3, "frames_per_s": b * frames / dt, "peak_bytes": peak,
               "launches_per_step": per_step, "graph_steps": graphs}
    if cfg.model.frontend.kind == "conv1d_resnet":
        summary["stem_conv"] = time_stem_conv(torch, state.model, batch[video])
    bad = None
    if path == "lrs3":
        # a batch with one infeasible row: the CTC recursion's cost on a step
        bad = {k: torch.from_numpy(v).to(dev) for k, v in with_infeasible_row(batch_np).items()}
        state, m = step(state, bad)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            state, m = step(state, bad)
        torch.cuda.synchronize()
        bad_s = (time.perf_counter() - t0) / TIMED_STEPS
        m = {k: float(v) for k, v in m.items()}
        log(f"  {TIMED_STEPS} steps with one infeasible CTC row: {bad_s * 1e3:.2f} ms/step; "
            f"last step {m}")
        if not (all(math.isfinite(v) for v in m.values()) and m["loss_ctc"] > 1e3):
            raise AssertionError(f"lrs3 with an infeasible row: {m}")
        summary["infeasible_row_step_ms"] = bad_s * 1e3
    jobs = []
    if graphs["replays"]:
        # a replay's counts above are its capture's (engine/graph.py): read
        # what ran from a trace, in a fresh state once every timing is done
        jobs.append(lambda: summary.update(replayed=replayed_launches(
            torch, cfg, batch_np, aug, per_step, path)))
    if profile_dir:
        def profiled():
            profile_steps(torch, state, step, batch, profile_dir, path, dt)
            if bad is not None:
                profile_steps(torch, state, step, bad, profile_dir, path + "_infeasible",
                              bad_s)
        jobs.append(profiled)
    window = None
    if jobs:
        def window():
            for job in jobs:
                job()
    return launches, summary, window


def graph_counts_since(before):
    """The train steps since ``before`` (``graph_counts()``) by how they ran."""
    from syncvsr_tpu_torch.utils.profiling import graph_counts

    now = graph_counts()
    eager = {k: n - before["eager"].get(k, 0) for k, n in now["eager"].items()}
    return {"captures": now["captures"] - before["captures"],
            "replays": now["replays"] - before["replays"],
            "eager": {k: n for k, n in eager.items() if n}}


def replayed_launches(torch, cfg, batch_np, aug, per_step, path, n=TIMED_STEPS):
    """``path``'s train step replayed as a CUDA graph, in a fresh state of
    ``cfg``: a warm-up and a capture step, then ``n`` replays under
    torch.profiler after one unprofiled replay (``profile_window``), the
    kernels' counts set to 0 just before. The hand-written kernels'
    launches a step, read by kernel name from the trace
    (``ops.traced_launches``) and counted by their wrappers, must both be
    ``per_step``, and every step a replay."""
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops import traced_launches
    from syncvsr_tpu_torch.utils.benchmark import profile_window
    from syncvsr_tpu_torch.utils.profiling import graph_counts

    dev = torch.device("cuda")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    state = create_train_state(cfg, build_model(cfg), batch)
    step = build_train_step(aug_fn=aug)
    for _ in range(2):
        step(state, batch)
    torch.cuda.synchronize()
    reset_counts()
    before = graph_counts()
    window = profile_window(lambda: step(state, batch), dev, n)
    graphs = graph_counts_since(before)
    counted = {k: v / (n + 1) for k, v in read_counts().items()}
    traced = traced_launches((name, calls) for name, _, calls in window["kernels"])
    log(f"replayed {path}: {graphs}; launches a step traced {traced}, counted {counted} "
        f"(expected {per_step}); {window['launches']:.0f} device kernels a step")
    del state, step
    torch.cuda.empty_cache()
    if graphs != {"captures": 0, "replays": n + 1, "eager": {}}:
        raise AssertionError(f"replayed {path}: the steps ran {graphs}")
    if traced != per_step or counted != per_step:
        raise AssertionError(f"replayed {path}: launches a step traced {traced}, counted "
                             f"{counted}, expected {per_step}")
    return {"traced_per_step": traced, "counted_per_step": counted,
            "device_kernels_per_step": window["launches"]}


def train_1800(torch, np, path, profile_dir=None):
    """The full-width lrs3 step at the 1800-frame bucket (batch 2 x 1800 uint8
    128x128 frames, 128 labels; augmentation and dropout as configured),
    first without model.remat, then with it, each in a fresh model from the
    same seeds: the first step's losses equal (a deterministic first step
    on both: the forward is the same computation, only the backward
    recomputes), then warm-up and two timed windows with the kernels'
    launches counted from 0 and the peak memory; one eval step. Returns
    (launches in the timed steps of both runs, summary, profiled window)."""
    from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops import image

    windows, steps = 2, 3
    batch_np = uint8_sentences(lrs3_1800_cfg(), LRS3_1800_FRAMES, LRS3_1800_LABEL_LEN,
                               LRS3_SOURCE, seed=0)
    dev = torch.device("cuda")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    log(f"train: {path}, videos {tuple(batch['videos'].shape)} uint8, conformer 12 layers, "
        "dim 768, decoder 6 layers, dtype bfloat16, sync head 8 slots of 320")
    summary, total, firsts, window = {}, None, {}, None
    for remat in (False, True):
        cfg = lrs3_1800_cfg(remat)
        aug = image.build_sentence_aug(cfg.data)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg)
        state = create_train_state(cfg, model, batch)
        step = build_train_step(aug_fn=aug)
        bench, det = torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
        try:
            state, m = step(state, batch)
            firsts[remat] = {k: float(v) for k, v in m.items()}
        finally:
            torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = bench, det
        state, m = step(state, batch)
        torch.cuda.synchronize()
        reset_counts()
        times = []
        for _ in range(windows):
            t0 = time.perf_counter()
            for _ in range(steps):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) / steps)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() - held
        last = {k: float(v) for k, v in m.items()}
        dt = sum(times) / len(times)
        per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1,
                    "bn_stats_fwd": 64 if remat else 32, "bn_stats_bwd": 32}
        want = {k: n * steps * windows for k, n in per_step.items()}
        name = "remat" if remat else "plain"
        log(f"  {name}: {dt * 1e3:.2f} ms/step (windows of {steps}: "
            f"{', '.join(f'{w * 1e3:.2f}' for w in times)} ms/step), "
            f"{2 * LRS3_1800_FRAMES / dt:.1f} frames/s, peak memory {peak / 2**30:.2f} GiB "
            f"(above {held / 2**30:.2f} GiB held); first step {firsts[remat]}; last step "
            f"{last}; launches {launches} (expected {want})")
        if not all(math.isfinite(v) for v in list(firsts[remat].values())
                   + list(last.values())):
            raise AssertionError(f"{path} {name}: non-finite metrics")
        if launches != want:
            raise AssertionError(f"{path} {name}: launches {launches} != {want}")
        summary[name] = {"step_ms": dt * 1e3, "frames_per_s": 2 * LRS3_1800_FRAMES / dt,
                         "peak_bytes": peak, "launches_per_step": per_step,
                         "first_step": firsts[remat]}
        total = launches if total is None else {k: total[k] + launches[k] for k in total}
        if remat:
            before = read_counts()
            ev = build_eval_step()(state, image.build_sentence_eval_transform(cfg.data)(batch))
            ev = {k: float(v) for k, v in ev.items()}
            got = {k: v - before[k] for k, v in read_counts().items()}
            log(f"  eval step: {ev}; launches {got}")
            if not (all(math.isfinite(v) for v in ev.values())
                    and got == {k: int(k == "sync_ce_split_fwd") for k in got}):
                raise AssertionError(f"{path} eval step: {ev}, launches {got}")
            if profile_dir:
                def window(state=state, step=step, dt=dt):
                    profile_steps(torch, state, step, batch, profile_dir, path, dt)
        else:
            del state, model, step
            torch.cuda.empty_cache()
    for k in ("loss", "loss_ctc", "loss_att", "loss_audio"):
        if firsts[True][k] != firsts[False][k]:
            raise AssertionError(f"{path} first step {k}: {firsts[True][k]} with remat, "
                                 f"{firsts[False][k]} without")
    if not summary["remat"]["peak_bytes"] < summary["plain"]["peak_bytes"]:
        raise AssertionError(f"{path}: remat did not lower the peak memory")
    log(f"  first-step losses equal with and without remat; peak memory "
        f"{summary['remat']['peak_bytes'] / 2**30:.2f} GiB with remat against "
        f"{summary['plain']['peak_bytes'] / 2**30:.2f} GiB without")
    summary.update(step_ms=summary["remat"]["step_ms"],
                   frames_per_s=summary["remat"]["frames_per_s"],
                   peak_bytes=summary["remat"]["peak_bytes"],
                   launches_per_step=summary["remat"]["launches_per_step"])
    return total, summary, window


# ---- the in-step codec (lrs3_instep): vq-wav2vec quantizes the batch's
# waveforms inside the step (syncvsr_tpu_torch/ops/codec.py) ----------------

# the fairseq checkpoints the codec loads, written by write_codecs into a
# temporary directory: vq-wav2vec's geometry (8 convs 512 wide, G = 2, V =
# 320), seeded; "separated" draws its codebook at 3x scale, so no argmin is
# within f32 rounding of a tie (tests/test_codec_instep.py's rule)
CODECS = {}
INSTEP_SAMPLES = LRS3_FRAMES * 640          # 102400 samples a clip


def write_codecs(tmp):
    import os

    from syncvsr_tpu_torch.data.synthetic_ckpt import write_fairseq_vq

    for name, seed, separation in (("random", 0, 1.0), ("separated", 1, 3.0)):
        CODECS[name] = os.path.join(tmp, f"vq_{name}.pt")
        write_fairseq_vq(CODECS[name], seed=seed, separation=separation)


def instep_batch(np, batch, seed):
    """The sentence batch with waveforms (f32 [B, frames * 640], seeded) in
    place of its offline audio tokens."""
    b, t = batch["videos"].shape[:2]
    out = {k: v for k, v in batch.items() if k != "audio_tokens"}
    out["audio"] = (np.random.RandomState(seed + 7).randn(b, t * 640) * 0.1).astype(np.float32)
    return out


def instep_aug(cfg, base):
    """``base`` after the in-step tokenizer of ``cfg`` on the batch's device
    (``train.py``'s composition; the codec is built once a device)."""
    from syncvsr_tpu_torch.train import instep_tokenizer

    return base.after(lambda batch: instep_tokenizer(cfg, batch["audio"].device)(batch))


def codec_flops(b, samples):
    """(FLOPs of one codec call on [b, samples] waveforms, the feature
    frames of each layer): the 8 VALID convs, the grouped projection and
    the codebook product (vq-wav2vec's geometry)."""
    from syncvsr_tpu_torch.ops.codec import VQ_CONV_LAYERS

    flops, t, cin, frames = 0, samples, 1, []
    for cout, k, stride in VQ_CONV_LAYERS:
        t = (t - k) // stride + 1
        frames.append(t)
        flops += 2 * b * t * cout * cin * k
        cin = cout
    flops += 2 * b * t * cin * cin // 2          # grouped 1x1 projection, G = 2
    flops += 2 * b * t * cin * 320               # G x [d, V] codebook products
    return flops, frames


def check_codec_tokens(torch, np, audio):
    """Card tokens against the CPU's on the same waveforms (two clips of
    ``audio`` with the hook's 0.5 s pad) and weights, both in f32 (TF32
    allowed for the process, which the codec overrides): equal
    on the separated codebook; at the random one, the agreement rate (an
    argmin may flip where two codes are within rounding of a tie; at least
    99% must agree). Returns the rates."""
    from syncvsr_tpu_torch.ops.codec import SAMPLE_RATE, load_vq_codec, vq_tokens

    wav = torch.nn.functional.pad(audio[:2].float(), (0, SAMPLE_RATE // 2))
    rates = {}
    for name in ("separated", "random"):
        toks = {}
        for dev in ("cuda", "cpu"):
            params, geom = load_vq_codec(CODECS[name], dev)
            # TF32 on for the process, as PyTorch has it for convolutions
            # by default: the codec must turn it off for its own calls
            conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            try:
                toks[dev] = vq_tokens(params, wav.to(dev), strides=geom["strides"],
                                      **geom["features"]).cpu()
            finally:
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm
        rate = float((toks["cuda"] == toks["cpu"]).float().mean())
        rates[name] = rate
        log(f"  codec tokens, card vs CPU, {name} codebook: {tuple(toks['cuda'].shape)}, "
            f"{rate:.6f} equal, {len(torch.unique(toks['cuda']))} distinct codes")
        if not (rate == 1.0 if name == "separated" else rate >= 0.99):
            raise AssertionError(f"codec tokens card vs CPU ({name}): {rate} equal")
    return rates


def codec_kernels(torch, fn, n=5, top=8):
    """The device kernels of ``n`` codec calls under torch.profiler, the
    longest first, in ms a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    key = ("self_device_time_total" if avgs and hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    rows = sorted(((getattr(e, key) / 1e3 / n, e.count / n, e.key) for e in avgs
                   if e.device_type == DeviceType.CUDA and getattr(e, key) > 0), reverse=True)
    for ms, calls, name in rows[:top]:
        log(f"    {ms:8.3f} ms  x{calls:<4g} {name[:110]}")


def train_instep(torch, np, path, profile_dir=None):
    """The full-width lrs3 step (bs 8 x 160 uint8 frames) whose sync targets
    the codec makes inside the step from ``audio`` [8, 102400] f32 (the
    random codec, through ``load_vq_codec`` and ``train.py``'s
    ``instep_tokenizer``): warm-up and two timed windows with the kernels'
    launches counted from 0 and the peak memory; then the same step on
    the codec's tokens made once before (the step without the codec); the
    codec alone (CUDA events); one eval step on a tokenized batch; card
    tokens against the CPU's. Returns (launches in the timed steps with
    the codec, summary, the window that fills the codec's device ms and,
    with ``profile_dir``, profiles 3 steps)."""
    from syncvsr_tpu_torch.engine import build_eval_step, build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops import image
    from syncvsr_tpu_torch.train import instep_tokenizer

    cfg = lrs3_cfg().override(**{"model.codec.in_step": True,
                                 "model.codec.ckpt": CODECS["random"]})
    dev = torch.device("cuda")
    held = torch.cuda.memory_allocated()
    batch_np = instep_batch(np, uint8_sentences(cfg, LRS3_FRAMES, LRS3_LABEL_LEN,
                                                LRS3_SOURCE, seed=0), seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
    tokenize = instep_tokenizer(cfg, dev)
    aug = image.build_sentence_aug(cfg.data)
    b = cfg.data.batch_size
    flops, frames = codec_flops(b, INSTEP_SAMPLES + 8000)
    log(f"train: {path}, videos {tuple(batch['videos'].shape)} uint8, audio "
        f"{tuple(batch['audio'].shape)} f32 through vq-wav2vec (8 convs 512 wide, G 2, V 320; "
        f"frames a layer {frames}; {flops / 1e9:.1f} GFLOP a call, f32 bound "
        f"{flops / PEAK_F32_FLOPS * 1e3:.3f} ms), conformer 12 layers, dim 768, decoder 6 "
        "layers, dtype bfloat16")
    model = build_model(cfg)
    state = create_train_state(cfg, model, batch)
    step = build_train_step(aug_fn=aug.after(tokenize))
    first = None
    for _ in range(WARMUP_STEPS):
        state, m = step(state, batch)
        first = first or {k: float(v) for k, v in m.items()}
    torch.cuda.synchronize()
    log(f"  first step {first}")
    if not (all(math.isfinite(v) for v in first.values())
            and abs(first["loss_audio"] - math.log(320)) < 1.0):
        raise AssertionError(f"{path} first step: {first}")

    def timed(step, batch):
        nonlocal state
        windows = []
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(TIMED_STEPS):
                state, m = step(state, batch)
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) / TIMED_STEPS)
        return sum(windows) / len(windows), windows, {k: float(v) for k, v in m.items()}

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    dt, windows, last = timed(step, batch)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() - held
    per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1, "bn_stats_fwd": 32, "bn_stats_bwd": 32}
    want = {k: n * TIMED_STEPS * 2 for k, n in per_step.items()}
    log(f"  with the codec: {dt * 1e3:.2f} ms/step (windows of {TIMED_STEPS}: "
        f"{', '.join(f'{w * 1e3:.2f}' for w in windows)}), {b * LRS3_FRAMES / dt:.1f} frames/s, "
        f"peak memory {peak / 2**30:.2f} GiB (above {held / 2**30:.2f} GiB held); last step "
        f"{last}; launches {launches} (expected {want})")
    if not all(math.isfinite(v) for v in last.values()):
        raise AssertionError(f"{path}: non-finite metrics {last}")
    if launches != want:
        raise AssertionError(f"{path}: launches {launches} != {want}")
    # the step without the codec: the same batch with the tokens it makes
    tokens = tokenize(batch)
    plain_step = build_train_step(aug_fn=aug)
    state, _ = plain_step(state, tokens)
    torch.cuda.synchronize()
    dt_plain, windows_plain, _ = timed(plain_step, tokens)
    codec = time_ms(lambda: tokenize(batch), CUDA, iters=10)
    log(f"  without the codec (its tokens made once before): {dt_plain * 1e3:.2f} ms/step "
        f"(windows {', '.join(f'{w * 1e3:.2f}' for w in windows_plain)}); the codec alone "
        f"{codec:.3f} ms a call (CUDA events, 10 calls), the step's difference "
        f"{(dt - dt_plain) * 1e3:.2f} ms")
    before = read_counts()
    ev = build_eval_step()(state, image.build_sentence_eval_transform(cfg.data)(tokens))
    ev = {k: float(v) for k, v in ev.items()}
    got = {k: v - before[k] for k, v in read_counts().items()}
    log(f"  eval step: {ev}; launches {got}")
    if not (all(math.isfinite(v) for v in ev.values())
            and got == {k: int(k == "sync_ce_split_fwd") for k in got}):
        raise AssertionError(f"{path} eval step: {ev}, launches {got}")
    rates = check_codec_tokens(torch, np, batch["audio"])
    summary = {"step_ms": dt * 1e3, "frames_per_s": b * LRS3_FRAMES / dt, "peak_bytes": peak,
               "launches_per_step": per_step, "step_without_codec_ms": dt_plain * 1e3,
               "codec_ms": codec, "codec_device_ms": None, "codec_gflop": flops / 1e9,
               "codec_bound_ms": flops / PEAK_F32_FLOPS * 1e3, "token_agreement": rates}

    def window():
        conv_ms, _, calls, src, all_ms = device_ms(lambda: tokenize(batch), ("conv",),
                                                   iters=10)
        summary["codec_device_ms"] = all_ms
        log(f"{path}: the codec's device time {all_ms:.3f} ms a call ({src}; {calls} device "
            f"kernels a call, convolution kernels {conv_ms:.3f} ms), {codec:.3f} ms with the host")
        codec_kernels(torch, lambda: tokenize(batch))
        if profile_dir:
            profile_steps(torch, state, step, batch, profile_dir, path, dt)

    return launches, summary, window


def time_stem_conv(torch, model, audio):
    """The ResNet1D stem conv alone (C_in 1, k 80, stride 4) on the path's
    waveform, in CUDA events: its forward, and its forward with the weight
    gradient (the waveform needs none), beside the forward's bound."""
    stem = model.frontend.resnet1d.stem_conv
    x = audio[..., None].to(stem.dtype)
    y = stem(x)
    gy = torch.randn_like(y)
    fwd = time_ms(lambda: stem(x), CUDA)
    fwd_wgrad = time_ms(lambda: torch.autograd.grad(stem(x), stem.weight, gy), CUDA)
    c_out, _, k = stem.weight.shape
    bound, by = bound_ms(2 * y.numel() * k, PEAK_BF16_FLOPS,
                         (x.numel() + y.numel()) * x.element_size())
    log(f"  stem conv {tuple(x.shape)} -> {tuple(y.shape)} (k {k}, stride 4, C_in 1, "
        f"{x.dtype}): forward {fwd:.5f} ms (bound {bound:.5f}, {by}), forward + weight "
        f"gradient {fwd_wgrad:.5f} ms")
    return {"forward_ms": fwd, "forward_weight_grad_ms": fwd_wgrad, "forward_bound_ms": bound}


def profile_steps(torch, state, step, batch, out_dir, path, step_s, n=3):
    """``n`` train steps under torch.profiler (``benchmark.profile_window``):
    device time by kernel group and the top kernels, beside the unprofiled
    step time ``step_s`` (the device's idle share is 1 - device time / step
    time). The full table goes to ``out_dir/profile_<path>.txt``."""
    import os

    prof = profile_window(lambda: step(state, batch), torch.device("cuda"), n,
                          os.path.join(out_dir, f"profile_{path}.txt"))
    total = prof["ms"]
    if not prof["kernels"]:
        log(f"profile {path}: no device time was traced")
        return
    log(f"profile {path} ({n} steps): device time {total:.2f} ms/step in "
        f"{prof['launches']:.0f} launches/step; unprofiled step "
        f"{step_s * 1e3:.2f} ms, so the device idles {1 - total / (step_s * 1e3):.1%} of it")
    for g, (ms, calls) in sorted(prof["groups"].items(), key=lambda kv: -kv[1][0]):
        log(f"  {g:<14} {ms:9.3f} ms/step {ms / total:6.1%}  {calls:.0f} launches/step")
    for name, ms, calls in prof["kernels"][:25]:
        log(f"  {ms:9.3f} ms/step  x{calls:<4.0f} {name[:110]}")


# ---- decoding (no kernel of K1-K4 runs here: eval BatchNorms use their
# running statistics and the sync head is dropped) --------------------------

DECODE_FRAMES, DECODE_LABEL_LEN, DECODE_BEAM, DECODE_LM_WEIGHT = 160, 48, 40, 0.1
# the small f32 reference: the lrs3 model at toy widths with equal encoder
# and decoder widths (tests/torch_parity.py's SENTENCE_DECODE), three clips
SMALL_DECODE = {
    "model.encoder.layers": 2, "model.encoder.dim": 32, "model.encoder.heads": 2,
    "model.decoder.layers": 2, "model.decoder.dim": 32, "model.decoder.heads": 2,
    "model.decoder.hidden": 24, "model.frontend.resnet_width": 8, "model.labels": 11,
    "model.codec.audio_vocab_size": 13, "model.dtype": "float32",
    "model.encoder.mlp_dropout": 0.0, "model.encoder.msa_dropout": 0.0,
    "model.decoder.dropout": 0.0, "data.batch_size": 3, "data.crop_size": 16}
SMALL_FRAMES = 12


def seeded_lm(torch, kind, vocab, seed, **shape):
    """A language model with weights drawn from ``seed`` on the CPU."""
    from syncvsr_tpu_torch.models.lm import RNNLM, TransformerLM

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return (RNNLM if kind == "rnn" else TransformerLM)(vocab, **shape)


def count_decode(torch, model, fn):
    """Runs ``fn`` once with the decoder's steps counted (a wrapper on the
    model's ``decoder.step``) and torch's synchronizing calls recorded (sync
    debug mode: one warning per host read of a device value). Returns
    (fn's result, decode steps, host reads)."""
    import warnings

    decoder, calls = model.decoder, [0]
    step = decoder.step

    def counted(*args, **kwargs):
        calls[0] += 1
        return step(*args, **kwargs)

    decoder.step = counted
    torch.cuda.synchronize()
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        del decoder.step
    torch.cuda.synchronize()
    reads = sum("synchroniz" in str(w.message) for w in seen)
    return out, calls[0], reads


def ctc_collapse(seq):
    """A frame-level path without blanks and merged repeats."""
    out, prev = [], None
    for tok in seq:
        if tok != 0 and tok != prev:
            out.append(tok)
        prev = tok
    return out


def check_decode_reference(torch, np):
    """The small f32 model, seeded, decoded on the card and on the CPU
    through the same entry points: the batched beam search with each LM
    (tokens equal; a row whose tokens differ must be a near-tie, its two
    hypotheses' scores within 1e-4, and at most one row may flip), greedy
    CTC and forced alignment (equal); on the card, the single-utterance
    decoder on clip 0 against the batched row 0 (equal tokens, scores to
    1e-6). A length bonus of 5 a token (``penalty``; it also turns early
    exit off) keeps the random model's hypotheses from ending at once: each
    of their tokens is a ranking that must agree."""
    from syncvsr_tpu_torch.config import lrs3_config
    from syncvsr_tpu_torch.data.synthetic import sentence_batch
    from syncvsr_tpu_torch.decode import BeamSearchConfig
    from syncvsr_tpu_torch.decode.api import (
        make_batched_beam_decoder,
        make_beam_decoder,
        make_forced_aligner,
        make_greedy_ctc_decoder,
    )
    from syncvsr_tpu_torch.models import build_model

    cfg = lrs3_config().override(**SMALL_DECODE)
    v = cfg.model.labels
    models = {"cpu": build_model(cfg, device="cpu")}
    models["cuda"] = build_model(cfg)
    models["cuda"].load_state_dict(models["cpu"].state_dict())
    raw = sentence_batch(cfg, num_frames=SMALL_FRAMES, label_len=5, seed=4)
    raw["lengths"] = np.array([SMALL_FRAMES, 9, 6], np.int32)
    lm_shapes = {"transformer": dict(layers=2, dim=16, heads=2, hidden=32, embed_dim=8),
                 "rnn": dict(layers=2, dim=16, embed_dim=8)}
    flips, worst = 0, 0.0
    before = read_counts()
    for kind, shape in lm_shapes.items():
        lm_cpu = seeded_lm(torch, kind, v, 9, **shape)
        lm_gpu = seeded_lm(torch, kind, v, 9, **shape).cuda()
        cfg_b = BeamSearchConfig(beam_size=5, ctc_weight=0.1, lm_weight=0.3, penalty=5.0)
        got = {}
        for side, lm in (("cpu", lm_cpu), ("cuda", lm_gpu)):
            dec = make_batched_beam_decoder(models[side], cfg_b, SMALL_FRAMES, lm=lm)
            got[side] = [t.cpu() for t in dec(torch.from_numpy(raw["videos"]),
                                              torch.from_numpy(raw["lengths"]))]
        (t_c, n_c, s_c), (t_g, n_g, s_g) = got["cpu"], got["cuda"]
        one = make_beam_decoder(models["cuda"], cfg_b, SMALL_FRAMES, lm=lm_gpu)(
            torch.from_numpy(raw["videos"][:1]), int(raw["lengths"][0]))
        if not (torch.equal(one[0].cpu(), t_g[0]) and int(one[1]) == int(n_g[0])
                and abs(float(one[2]) - float(s_g[0])) <= 1e-6 * abs(float(s_g[0]))):
            raise AssertionError(f"decode reference {kind} LM: clip 0 alone {one} vs "
                                 f"batched row 0 {t_g[0]} ({float(s_g[0])})")
        for i in range(t_c.shape[0]):
            gap = abs(float(s_g[i]) - float(s_c[i])) / max(abs(float(s_c[i])), 1.0)
            worst = max(worst, gap)
            same = bool(torch.equal(t_c[i], t_g[i])) and int(n_c[i]) == int(n_g[i])
            if not same:
                flips += 1
                log(f"  decode reference {kind} LM row {i}: card {t_g[i, :int(n_g[i])].tolist()} "
                    f"({float(s_g[i])}) vs CPU {t_c[i, :int(n_c[i])].tolist()} "
                    f"({float(s_c[i])})")
            if gap > 1e-4:
                raise AssertionError(f"decode reference {kind} LM row {i}: scores "
                                     f"{float(s_g[i])} (card) vs {float(s_c[i])} (CPU)")
        log(f"decode reference, {kind} LM: card {n_g.tolist()} tokens, scores {s_g.tolist()}; "
            f"CPU {n_c.tolist()}, {s_c.tolist()}")
    if flips > 1:
        raise AssertionError(f"decode reference: {flips} rows flipped between card and CPU")
    videos, lengths = torch.from_numpy(raw["videos"]), torch.from_numpy(raw["lengths"])
    labels = torch.from_numpy(raw["labels"])
    for name, run in (("greedy", lambda m: make_greedy_ctc_decoder(m)(videos, lengths)),
                      ("align", lambda m: (make_forced_aligner(m)(videos, lengths, labels),))):
        a, b = ([t.cpu() for t in run(models[side])] for side in ("cpu", "cuda"))
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"decode reference {name}: card {b} vs CPU {a}")
    launched = {k: val - before[k] for k, val in read_counts().items()}
    if any(launched.values()):
        raise AssertionError(f"decode reference launched port kernels: {launched}")
    log(f"decode reference: card vs CPU, beam (2 LMs), greedy and align; {flips} near-tie "
        f"rows flipped, worst score gap {worst:.3e} (relative); launches {launched}")
    return {"rows_flipped": flips, "worst_score_gap": worst}


def time_call(torch, fn, n=2):
    """(mean seconds a call over ``n`` calls, the last result), each call
    synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n, out


# the CLI phase: the entry points a user runs, each in its own process
CLI_TIMEOUT = 300     # seconds a command may take


def run_cli(module, args, cwd, what):
    """``python -m syncvsr_tpu_torch.<module> <args>`` in ``cwd`` (the
    repository on the path); returns (its standard output, seconds), or
    raises with the end of its output if it fails."""
    import os

    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", f"syncvsr_tpu_torch.{module}", *args],
                         cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=CLI_TIMEOUT)
    dt = time.perf_counter() - t0
    tail = "\n".join((out.stdout + out.stderr).strip().splitlines()[-12:])
    log(f"cli {what}: python -m syncvsr_tpu_torch.{module} {' '.join(args)} -> exit "
        f"{out.returncode} in {dt:.1f} s\n{tail}")
    if out.returncode != 0:
        raise AssertionError(f"cli {what} failed (exit {out.returncode})")
    return out.stdout, dt


def train_records(ckpt_dir):
    """The per-step records of ``metrics.jsonl`` (one each ``log_every``
    steps, with the kernels' launches; the train metrics in them lag one
    step, so the first has none)."""
    import os

    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train/launches/sync_ce_fwd" in r]


def losses(records, what):
    """The records' train losses, each finite."""
    got = [r["train/loss"] for r in records if "train/loss" in r]
    if not (got and all(math.isfinite(v) for v in got)):
        raise AssertionError(f"cli {what}: train losses {got}")
    return got


def check_launches(records, per_step, what):
    """Every train record's kernel launches a step equal ``per_step``."""
    for r in records:
        got = {k: r[f"train/launches/{k}"] for k in per_step}
        if got != {k: float(n) for k, n in per_step.items()}:
            raise AssertionError(f"cli {what} step {r['step']}: launches a step {got}, "
                                 f"expected {per_step}")


def last_json(stdout, what):
    line = stdout.strip().splitlines()[-1]
    try:
        return json.loads(line)
    except json.JSONDecodeError:
        raise AssertionError(f"cli {what}: the last line is no JSON object: {line}") from None


def cli_phase(steps):
    """The train and evaluate CLIs (``python -m syncvsr_tpu_torch.train`` /
    ``.evaluate``) on synthetic data, into a temporary directory removed at
    the end: (a) ``lrw_video`` at full width and 2 encoder layers, 6 steps
    with an eval and a
    ``ckpt_every`` save at step 4, then ``resume=auto`` to step 8; (b)
    ``evaluate`` of its ``best.msgpack``; (c) ``lrw1000`` with the DC-TCN
    at full width, 4 steps (K2 at V = 640); (d) ``lrs3`` cut to 2 encoder
    layers and 1 decoder layer, 4 steps with an eval at step 2, then
    ``evaluate`` of its ``best.msgpack`` with ``decode=greedy`` and with
    ``decode=beam_batched decode_pad=bucket`` (``cli_sentence``), beside the
    runs from files (``cli_files``), in concurrent chains. The kernels'
    launches a step come from the driver's ``metrics.jsonl``; ``steps``
    (the step phase's summaries) gives the bare step's ms beside the
    driver's ``step_ms_ema`` of (a) and (c), which run alone. Returns the
    phase's summary."""
    import os
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="syncvsr_cli_")
    summary = {}
    try:
        # (a) lrw_video at full width, 2 of its 12 encoder layers (the step
        # phase runs all 12): train, eval at 4, save at 4, end at 6; resume to 8
        video = os.path.join(tmp, "lrw_video")
        lrw = ["preset=lrw_video", "model.encoder.layers=2"]
        common = ["data.dataset=synthetic", "train.log_every=1", f"train.ckpt_dir={video}"]
        out, dt = run_cli("train", [*lrw, *common, "optim.total_steps=6",
                                    "train.eval_every=4", "train.ckpt_every=4"], tmp,
                          "(a) lrw_video train")
        first = train_records(video)
        losses(first, "(a)")
        names = sorted(os.listdir(video))
        log(f"  files: {names}")
        for f in ("metrics.jsonl", "best.msgpack", "step_4.msgpack", "step_6.msgpack"):
            if f not in names:
                raise AssertionError(f"cli (a): {f} missing from {names}")
        if [r["step"] for r in first] != list(range(1, 7)):
            raise AssertionError(f"cli (a): train records at steps {[r['step'] for r in first]}")
        out, dt2 = run_cli("train", [*lrw, *common, "optim.total_steps=8",
                                     "train.eval_every=4", "train.ckpt_every=4",
                                     "train.resume=auto"], tmp, "(a) lrw_video resume")
        if f"resumed from {os.path.join(video, 'step_6.msgpack')} @ step 6" not in out:
            raise AssertionError("cli (a): the second run did not resume from step 6")
        resumed = train_records(video)[len(first):]
        if [r["step"] for r in resumed] != [7, 8] or \
                "step_8.msgpack" not in os.listdir(video):
            raise AssertionError(f"cli (a): resumed records at "
                                 f"{[r['step'] for r in resumed]}")
        per_step = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0, "bn_stats_fwd": 20,
                    "bn_stats_bwd": 20}
        check_launches(first + resumed, per_step, "(a)")
        summary["lrw_video"] = {"seconds": [dt, dt2],
                                "step_ms_ema": first[-1]["train/step_ms_ema"],
                                "step_phase_ms": steps["lrw_video"]["step_ms"],
                                "launches_per_step": per_step}
        # (b) evaluate the best checkpoint
        out, dt = run_cli("evaluate", [*lrw, "data.dataset=synthetic",
                                       f"ckpt={os.path.join(video, 'best.msgpack')}"],
                          tmp, "(b) lrw_video evaluate")
        res = last_json(out, "(b)")
        if not all(math.isfinite(res.get(f"test/{k}", math.nan)) for k in ("acc1", "acc5")):
            raise AssertionError(f"cli (b): {res}")
        summary["lrw_video"]["evaluate"] = res
        # (c) lrw1000 with the DC-TCN: K2 at V = 640
        tcn = os.path.join(tmp, "lrw1000_dctcn")
        run_cli("train", ["preset=lrw1000", "model.encoder.kind=dense_tcn",
                          "data.dataset=synthetic", "optim.total_steps=4", "train.log_every=1",
                          "train.eval_every=100", "train.ckpt_every=100",
                          f"train.ckpt_dir={tcn}"], tmp, "(c) lrw1000 dense_tcn train")
        rec = train_records(tcn)
        per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 2, "bn_stats_fwd": 20,
                    "bn_stats_bwd": 20}
        check_launches(rec, per_step, "(c)")
        summary["lrw1000_dctcn"] = {"step_ms_ema": rec[-1]["train/step_ms_ema"],
                                    "step_phase_ms": steps["lrw1000_dctcn"]["step_ms"],
                                    "launches_per_step": per_step,
                                    "train_loss": losses(rec, "(c)")}
        # (d) onwards run in concurrent chains (cli_files), the tools in one more
        summary.update(cli_files(tmp, cli_sentence, tools_chain))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for path in ("lrw_video", "lrw1000_dctcn"):
        s = summary[path]
        log(f"cli {path}: the driver's step_ms_ema {s['step_ms_ema']:.2f} ms against "
            f"{s['step_phase_ms']:.2f} ms a bare step (step phase)")
    return summary


# the synthetic LRS3 tree of the CLI runs from files: clip lengths (frames)
# that fill each bucket of lrs3's (160, 320, 640, 1200, 1800) at
# data.max_batch_frames=3600 (batches of 16, 11, 5, 3 and 2 clips), the
# last twice, one of its clips past 1800 frames (windowed to 1800): six
# batches an epoch
FILES_TRAIN = ([100 + 3 * i for i in range(16)] + [200 + 10 * i for i in range(11)]
               + [400 + 40 * i for i in range(5)] + [700, 900, 1100]
               + [1300, 1700, 1500] + [2100])
FILES_VAL, FILES_TEST = [120, 260], [90, 150, 300, 420]
FILES_MBF = 3600
# (e) and (i) run lrs3's widths at this depth (the step phase runs its full depth)
FILES_DEPTH = ["model.encoder.layers=2", "model.decoder.layers=1"]
FILES_LAYERS = {a.split("=")[0]: int(a.split("=")[1]) for a in FILES_DEPTH}   # as overrides
# vox2's tree: long clips windowed by a length histogram
FILES_VOX2, FILES_VOX2_HIST = [300, 700, 1000, 1900, 2400, 600], [150, 400, 800]


def files_schedule(root, dataset, epoch, **over):
    """The buckets of the port's LRSBucketLoader schedule for ``epoch`` of
    the train split under lrs3's preset (read from the length index: no
    sample is decoded)."""
    from syncvsr_tpu_torch.config import lrs3_config
    from syncvsr_tpu_torch.data.factory import LRSBucketLoader
    from syncvsr_tpu_torch.data.lrs import BucketBatcher

    cfg = lrs3_config().override(**{"data.dataset": dataset, "data.root": root,
                                    "data.max_batch_frames": FILES_MBF, **over})
    loader = LRSBucketLoader(cfg, "train", True)
    loader.ds.window_seed = cfg.train.seed + epoch
    d, codec = cfg.data, cfg.model.codec
    batcher = BucketBatcher(d.length_buckets, d.batch_size, d.max_label_len, codec.vq_groups,
                            codec.audio_alignment, max_batch_frames=FILES_MBF)
    return [(b, len(rows)) for b, rows, _ in loader._schedule(batcher, 1, epoch)]


def cli_sentence(tmp):
    """(d) of ``cli_phase``: ``lrs3`` cut to 2 encoder layers and 1 decoder
    layer, 4 steps with an eval at step 2, then ``evaluate`` of its
    ``best.msgpack`` with ``decode=greedy`` and with ``decode=beam_batched
    decode_pad=bucket``, in a working directory of its own (``evaluate``
    writes ``hypotheses.jsonl`` there). Returns its summary."""
    import os

    cwd = os.path.join(tmp, "cwd_sentence")
    os.makedirs(cwd)
    sent = os.path.join(tmp, "lrs3")
    cut = ["preset=lrs3", "model.encoder.layers=2", "model.decoder.layers=1",
           "data.dataset=synthetic"]
    run_cli("train", [*cut, "optim.total_steps=4", "train.log_every=1",
                      "train.eval_every=2", "train.ckpt_every=100",
                      f"train.ckpt_dir={sent}"], cwd, "(d) lrs3 train")
    rec = train_records(sent)
    per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1, "bn_stats_fwd": 22,
                "bn_stats_bwd": 22}
    check_launches(rec, per_step, "(d)")
    losses(rec, "(d)")
    if "best.msgpack" not in os.listdir(sent):
        raise AssertionError("cli (d): no best.msgpack")
    out = {"step_ms_ema": rec[-1]["train/step_ms_ema"], "launches_per_step": per_step}
    for mode in (["decode=greedy"], ["decode=beam_batched", "decode_pad=bucket"]):
        res_out, dt = run_cli("evaluate", [*cut, f"ckpt={os.path.join(sent, 'best.msgpack')}",
                                           *mode], cwd, f"(d) lrs3 evaluate {mode[0]}")
        res = last_json(res_out, "(d)")
        hyps = open(os.path.join(cwd, "hypotheses.jsonl")).read().splitlines()
        if not (math.isfinite(res.get("test/wer", math.nan)) and len(hyps) == 4 * 16):
            raise AssertionError(f"cli (d) {mode[0]}: {res}, {len(hyps)} hypotheses")
        out[mode[0].split("=")[1]] = dict(res, seconds=dt)
    return {"lrs3": out}


def cli_files(tmp, *more):
    """The CLIs reading datasets from files (``syncvsr_tpu_torch/data/
    synthetic_tree.py`` writes them): (e) ``lrs3`` at full width and
    ``FILES_DEPTH`` from a packed LRS3 tree (``tools/pack_dataset.py --task sentence``) with
    ``data.max_batch_frames=3600 model.remat=true optim.accum_steps=2
    optim.skip_nonfinite=true`` for one epoch over all five buckets, then
    ``evaluate data.split=test decode=greedy`` of its last checkpoint; (f)
    ``lrs3_audio`` over the same tree's pkls (waveforms); (g) ``vox2`` with
    a length-distribution file; (h) ``lrw_landmark`` at full width from
    ``.npy`` clips with ``durations.csv``. (f) and (g) run 2 encoder and 1
    decoder layers. Each run's kernels' launches a step come from its
    ``metrics.jsonl``. Four chains run concurrently, each in a working
    directory of its own: each of ``more(tmp)`` (``cli_sentence``) from the
    start, and once the trees are written (e) then (i); (f), (g), (h);
    (ii), (iii), (iv) (``cli_codecs``). They share the card and the host,
    so their seconds and ``step_ms_ema`` are not the step phase's. Returns
    the runs' summaries."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from syncvsr_tpu_torch.data.synthetic_tree import write_landmark_tree, write_lrs_tree

    with ThreadPoolExecutor(3 + len(more)) as pool:
        futures = [pool.submit(fn, tmp) for fn in more]   # these read no tree
        t0 = time.perf_counter()
        root = os.path.join(tmp, "files")
        write_lrs_tree(root, "LRS3", {"train": FILES_TRAIN, "val": FILES_VAL,
                                      "test": FILES_TEST}, seed=5)
        write_lrs_tree(root, "VOX2", {"train": FILES_VOX2, "val": FILES_VAL}, seed=6)
        np.save(os.path.join(root, "vox2_length.npy"), np.asarray(FILES_VOX2_HIST, np.int64))
        packed = os.path.join(tmp, "files_packed")
        run_cli("tools.pack_dataset", [root, packed, "--task", "sentence", "--dataset",
                                       "LRS3", "--splits", "train", "val", "test"], tmp,
                "(e) pack")
        lrw = write_landmark_tree(os.path.join(tmp, "files_lrw"), ("ABOUT", "WORLD"),
                                  ("train", "val"), n=40, seed=7)
        log(f"cli files: wrote the LRS3, VOX2 and LRW landmark trees and packed LRS3 in "
            f"{time.perf_counter() - t0:.1f} s")
        sched = files_schedule(packed, "lrs3", 1, **{"data.packed": True})
        buckets = sorted({b for b, _ in sched})
        log(f"cli (e): the epoch's schedule (bucket, clips): {sched}")
        if buckets != [160, 320, 640, 1200, 1800]:
            raise AssertionError(f"cli (e): the schedule's buckets are {buckets}")
        futures += [pool.submit(cli_packed, tmp, root, packed, sched),
                    pool.submit(cli_trees, tmp, root, lrw), pool.submit(cli_codecs, tmp, packed)]
        out = {}
        for f in futures:
            out.update(f.result())
    return out


def cli_packed(tmp, root, packed, sched):
    """(e) of ``cli_files``, then (i) of the codecs (which holds its
    checkpoint's tree to (e)'s), in a working directory of their own."""
    import os

    cwd = os.path.join(tmp, "cwd_packed")
    os.makedirs(cwd)
    out = {}
    # (e) lrs3 at full width from the packed tree through every bucket, 2 of
    # its 12 encoder layers and 1 of its 6 decoder layers (the step phase
    # runs all of them)
    ck = os.path.join(tmp, "files_lrs3")
    lrs3 = ["preset=lrs3", *FILES_DEPTH, "data.dataset=lrs3", "data.packed=true",
            f"data.root={packed}", f"data.max_batch_frames={FILES_MBF}", "model.remat=true"]
    _, dt = run_cli("train", [*lrs3, "optim.accum_steps=2", "optim.skip_nonfinite=true",
                              "train.epochs=1", "optim.total_steps=0", "train.log_every=1",
                              "train.eval_every=1000", "train.ckpt_every=1000",
                              f"train.ckpt_dir={ck}"], cwd, "(e) lrs3 train from files")
    rec = train_records(ck)
    per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1, "bn_stats_fwd": 44,
                "bn_stats_bwd": 22}
    check_launches(rec, per_step, "(e)")
    if [r["step"] for r in rec] != list(range(1, len(sched) + 1)):
        raise AssertionError(f"cli (e): {len(rec)} steps, the schedule has {len(sched)}")
    last = f"step_{len(sched)}.msgpack"
    if last not in os.listdir(ck):
        raise AssertionError(f"cli (e): no {last}")
    res_out, dt_eval = run_cli("evaluate", [*lrs3, "data.split=test", "decode=greedy",
                                            f"ckpt={os.path.join(ck, last)}"], cwd,
                               "(e) lrs3 evaluate greedy")
    res = last_json(res_out, "(e)")
    if not (math.isfinite(res.get("test/wer", math.nan)) and res.get("test/words", 0) > 0):
        raise AssertionError(f"cli (e) evaluate: {res}")
    out["lrs3_files"] = {"seconds": dt, "evaluate_seconds": dt_eval, "schedule": sched,
                         "launches_per_step": per_step, "train_loss": losses(rec, "(e)"),
                         "step_ms_ema": rec[-1]["train/step_ms_ema"], "evaluate": res}
    out.update(cli_instep(tmp, root, os.path.join(ck, last), cwd))
    return out


def cli_trees(tmp, root, lrw):
    """(f), (g) and (h) of ``cli_files``, in a working directory of their
    own."""
    import os

    cwd = os.path.join(tmp, "cwd_trees")
    os.makedirs(cwd)
    out = {}
    # (f) lrs3_audio over the pkl tree; (g) vox2 windowed by a histogram
    cut = ["model.encoder.layers=2", "model.decoder.layers=1", f"data.root={root}",
           f"data.max_batch_frames={FILES_MBF}", "train.log_every=1", "train.eval_every=1000",
           "train.ckpt_every=1000"]
    for key, what, args, per_step in (
            ("lrs3_audio_files", "(f) lrs3_audio train from pkls",
             ["preset=lrs3_audio", "data.dataset=lrs3", "train.epochs=1",
              "optim.total_steps=0"],
             {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1, "bn_stats_fwd": 22,
              "bn_stats_bwd": 22}),
            ("vox2_files", "(g) vox2 train with a length distribution",
             ["preset=vox2", "data.length_distribution=vox2_length.npy", "train.epochs=2",
              "optim.total_steps=0"],
             {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1, "bn_stats_fwd": 22,
              "bn_stats_bwd": 22})):
        ck = os.path.join(tmp, key)
        _, dt = run_cli("train", [*args, *cut, f"train.ckpt_dir={ck}"], cwd, what)
        rec = train_records(ck)
        check_launches(rec, per_step, what)
        out[key] = {"seconds": dt, "steps": len(rec), "launches_per_step": per_step,
                    "train_loss": losses(rec, what)}
    # (h) lrw_landmark at full width from .npy clips (batch 32: 80 clips)
    ck = os.path.join(tmp, "lrw_landmark_files")
    what = "(h) lrw_landmark train from .npy files"
    _, dt = run_cli("train", ["preset=lrw_landmark", "data.dataset=lrw_landmark",
                              f"data.root={lrw}", "data.batch_size=32", "train.epochs=1",
                              "optim.total_steps=0", "train.log_every=1",
                              "train.eval_every=1000", "train.ckpt_every=1000",
                              f"train.ckpt_dir={ck}"], cwd, what)
    rec = train_records(ck)
    per_step = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0, "bn_stats_fwd": 0, "bn_stats_bwd": 0}
    check_launches(rec, per_step, what)
    out["lrw_landmark_files"] = {"seconds": dt, "steps": len(rec),
                                 "launches_per_step": per_step, "train_loss": losses(rec, what)}
    return out


def tree_shapes(path):
    """{key: shape} of a checkpoint's params, batch_stats and opt_state."""
    from syncvsr_tpu_torch.utils import checkpoint as ckpt

    return {k: tuple(getattr(v, "shape", ())) for k, v in
            ckpt.flatten(ckpt.load_msgpack(path)).items()
            if k.startswith(("params.", "batch_stats.", "opt_state."))}


def cli_instep(tmp, root, files_ckpt, cwd):
    """(i) of the codec entry points: ``train model.codec.in_step=true`` at
    full width and ``FILES_DEPTH`` from the LRS3 pkl tree (its waveforms;
    the random codec) with (e)'s options (remat, accumulation, the guard),
    3 steps and the final eval (tokenized too), its checkpoint tree equal
    to (e)'s (``files_ckpt``, the same run without the codec): no codec
    leaf. Returns its summary."""
    import os

    out = {}
    # (i) the in-step codec through the train CLI
    ck = os.path.join(tmp, "files_instep")
    what = "(i) lrs3 train with model.codec.in_step from pkls"
    _, dt = run_cli("train", ["preset=lrs3", *FILES_DEPTH, "data.dataset=lrs3",
                              f"data.root={root}", f"data.max_batch_frames={FILES_MBF}",
                              "model.remat=true", "model.codec.in_step=true",
                              f"model.codec.ckpt={CODECS['random']}",
                              "optim.accum_steps=2", "optim.skip_nonfinite=true",
                              "optim.total_steps=3", "train.log_every=1",
                              "train.eval_every=1000", "train.ckpt_every=1000",
                              f"train.ckpt_dir={ck}"], cwd, what)
    rec = train_records(ck)
    per_step = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1, "bn_stats_fwd": 44,
                "bn_stats_bwd": 22}
    check_launches(rec, per_step, what)
    mine, theirs = tree_shapes(os.path.join(ck, "step_3.msgpack")), tree_shapes(files_ckpt)
    if mine != theirs:
        raise AssertionError(f"cli (i): the checkpoint's tree differs from (e)'s: "
                             f"{sorted(set(mine) ^ set(theirs))[:8]}")
    log(f"cli (i): the in-step run's checkpoint has (e)'s tree ({len(mine)} leaves)")
    out["lrs3_instep_files"] = {"seconds": dt, "steps": len(rec), "launches_per_step": per_step,
                                "train_loss": losses(rec, what)}
    return out


def cli_codecs(tmp, packed):
    """The codec and reference-checkpoint tools: (ii)
    ``tools.tokenize_audio`` on both routes over a small tree of wavs and a
    pkl (the random codec; an HF wav2vec2 directory at
    wav2vec2-large-xlsr-53's geometry the script writes), each file's tokens
    against the CPU's; (iii) ``tools.import_checkpoint lrs`` of a full-width
    synthetic ``Vox+LRS2+LRS3.ckpt`` (espnet layout), then greedy
    ``evaluate`` of the test split from the imported file (every leaf
    loaded); (iv) ``evaluate`` of the val split (windowed to 160 frames)
    with the batched beam search and an espnet TransformerLM ``.pth`` at
    lrs3.yaml's 16 layers, converted on load, against the same LM through
    ``import_checkpoint lm`` (equal hypotheses); in a working directory of
    their own. Returns the runs' summaries."""
    import os

    cwd = os.path.join(tmp, "cwd_codecs")
    os.makedirs(cwd)
    return {"codec_tools": dict(cli_tokenize(tmp, cwd), **cli_import(tmp, packed, cwd))}


def cli_tokenize(tmp, cwd):
    """(ii) of ``cli_codecs``: ``tools.tokenize_audio`` on the card, both
    routes, over three wavs and a pkl of int16 audio; each file's tokens
    against ``tokenize_tree``'s on the CPU."""
    import os

    import numpy as np
    import torch
    from scipy.io import wavfile

    from syncvsr_tpu_torch.data.synthetic_ckpt import write_hf_wav2vec2
    from syncvsr_tpu_torch.tools.tokenize_audio import tokenize_tree

    src = os.path.join(tmp, "tok_src")
    os.makedirs(os.path.join(src, "spk0"))
    rng = np.random.RandomState(11)
    for i, sec in enumerate((1.0, 2.3, 3.7)):
        wav = (np.sin(np.linspace(0, 900 * sec, int(16000 * sec))) * 6000
               + rng.randn(int(16000 * sec)) * 2000).astype(np.int16)
        wavfile.write(os.path.join(src, "spk0", f"clip{i}.wav"), 16000, wav)
    torch.save({"video": [b""] * 40, "audio": (rng.randn(40 * 640) * 3000).astype(np.int16)},
               os.path.join(src, "spk0", "clip3.pkl"))
    w2v2 = os.path.join(tmp, "wav2vec2")
    write_hf_wav2vec2(w2v2, seed=0)
    tools = {}
    for codec, model, align in (("vq", CODECS["random"], 4), ("wav2vec2", w2v2, 2)):
        dst = os.path.join(tmp, f"tok_{codec}")
        what = f"(ii) tokenize_audio --codec {codec}"
        _, dt = run_cli("tools.tokenize_audio", ["--src", src, "--dst", dst, "--codec", codec,
                                                 "--model", model], cwd, what)
        cpu = os.path.join(tmp, f"tok_{codec}_cpu")
        want = tokenize_tree(src, cpu, codec, model, device="cpu")
        same, total = 0, 0
        for w in want:
            g = torch.load(os.path.join(dst, os.path.relpath(w, cpu)), weights_only=False)
            g, w = g[f"{codec}_tokens"], torch.load(w, weights_only=False)[f"{codec}_tokens"]
            if g.shape != w.shape or g.shape[1] != 2 or g.max() >= 320 or g.min() < -1:
                raise AssertionError(f"cli {what}: tokens {g.shape}, range {g.min()}..{g.max()}")
            same, total = same + int((g == w).sum()), total + g.size
        frames = [int(round(sec * 25)) * align for sec in (1.0, 2.3, 3.7)] + [40 * align]
        log(f"cli {what}: {len(want)} token pkls ({frames} rows), card vs CPU "
            f"{same / total:.6f} equal")
        if len(want) != 4 or same / total < 0.99:
            raise AssertionError(f"cli {what}: {len(want)} files, {same / total} equal")
        tools[f"tokenize_{codec}"] = {"seconds": dt, "files": len(want),
                                      "card_vs_cpu_equal": same / total}
    return tools


def cli_import(tmp, packed, cwd):
    """(iii) and (iv) of ``cli_codecs``: a full-width ``Vox+LRS2+LRS3.ckpt``
    (espnet layout) through ``tools.import_checkpoint lrs`` and a greedy
    ``evaluate`` of the packed tree's test split; beam ``evaluate`` of the
    val split (160 frames) with an espnet TransformerLM ``.pth`` (16 layers) and with the
    same LM through ``import_checkpoint lm``: equal hypotheses."""
    import os
    import re

    import torch

    from syncvsr_tpu_torch.config import lrs3_config
    from syncvsr_tpu_torch.data.synthetic_ckpt import (
        espnet_e2e_state_dict,
        espnet_transformer_lm_state_dict,
    )

    tools = {}
    # (iii) a full-width Vox+LRS2+LRS3.ckpt (espnet layout) imported, then evaluated
    src_ckpt = os.path.join(tmp, "Vox+LRS2+LRS3.ckpt")
    torch.save({"state_dict": espnet_e2e_state_dict(lrs3_config(), seed=7), "epoch": 0},
               src_ckpt)
    imported = os.path.join(tmp, "lrs3_imported.msgpack")
    _, dt = run_cli("tools.import_checkpoint", ["lrs", src_ckpt, imported], cwd,
                    "(iii) import_checkpoint lrs")
    lrs3 = ["preset=lrs3", "data.dataset=lrs3", "data.packed=true", f"data.root={packed}",
            f"ckpt={imported}"]
    res_out, dt_eval = run_cli("evaluate", [*lrs3, "data.split=test", "decode=greedy"], cwd,
                               "(iii) evaluate greedy of the imported checkpoint")
    loaded = re.search(r"loaded (\d+)/(\d+) params", res_out)
    res = last_json(res_out, "(iii)")
    if not (loaded and loaded.group(1) == loaded.group(2)
            and math.isfinite(res.get("test/wer", math.nan))):
        raise AssertionError(f"cli (iii): {loaded and loaded.group(0)}, {res}")
    tools["import_lrs"] = {"seconds": dt, "evaluate_seconds": dt_eval,
                           "params_loaded": int(loaded.group(1)), "evaluate": res}
    # (iv) an espnet TransformerLM .pth at lrs3.yaml's shape, fused in the beam search
    lm = os.path.join(tmp, "lm.pth")
    torch.save(espnet_transformer_lm_state_dict(5049, 16, 512, 2048, 128, seed=8), lm)
    run_cli("tools.import_checkpoint", ["lm", lm, os.path.join(tmp, "lm.msgpack"),
                                        "kind=transformer", "dim=512", "heads=8", "layers=16"],
            cwd, "(iv) import_checkpoint lm")
    hyps = {}
    for name in ("lm.pth", "lm.msgpack"):
        # the val clips (120 and 260 frames) windowed to the 160-frame bucket:
        # one 160-step search
        res_out, dt = run_cli("evaluate", [*lrs3, "data.split=val", "data.max_frames_val=160",
                                           "decode=beam_batched", "decode_pad=bucket",
                                           f"lm_ckpt={tmp}/{name}", "lm_weight=0.1"], cwd,
                              f"(iv) evaluate beam {name}")
        with open(os.path.join(cwd, "hypotheses.jsonl")) as f:
            hyps[name] = [json.loads(line) for line in f]
        tools[f"beam_{name}"] = dict(last_json(res_out, "(iv)"), seconds=dt)
    if not (len(hyps["lm.pth"]) == 2 and hyps["lm.pth"] == hyps["lm.msgpack"]):
        raise AssertionError("cli (iv): the .pth LM's hypotheses differ from the converted "
                             f"LM's: {hyps}")
    log("cli (iv): the .pth LM's hypotheses and scores equal the converted msgpack's")
    return tools


def decode_full_width(torch, np, card, profile_dir=None):
    """The lrs3 model (bf16, random weights) decoding 8 clips of 160 frames
    padded (lengths 160, 152, ..., 104): the batched beam search at beam 40
    with TransformerLM fusion at lrs3.yaml's LM shape, one clip alone
    through the single-utterance decoder, greedy CTC and forced alignment
    of the batch's labels. A random model never emits eos, so every row
    runs all 160 steps. Returns (summary, the profiled window to run after
    every timing)."""
    from syncvsr_tpu_torch.data.tokenizer import TextTransform
    from syncvsr_tpu_torch.decode import BeamSearchConfig
    from syncvsr_tpu_torch.decode.api import (
        make_batched_beam_decoder,
        make_beam_decoder,
        make_forced_aligner,
        make_greedy_ctc_decoder,
    )
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops.image import build_sentence_eval_transform
    from syncvsr_tpu_torch.utils.text import WordErrorRate

    cfg = lrs3_cfg()
    b, dev = cfg.data.batch_size, torch.device("cuda")
    held = torch.cuda.memory_allocated()
    raw = uint8_sentences(cfg, DECODE_FRAMES, DECODE_LABEL_LEN, LRS3_SOURCE, seed=0)
    raw["lengths"] = (DECODE_FRAMES - 8 * np.arange(b)).astype(np.int32)
    batch = build_sentence_eval_transform(cfg.data)(
        {k: torch.from_numpy(val).to(dev) for k, val in raw.items()})
    videos, lengths, labels = batch["videos"], batch["lengths"], batch["labels"]
    model = build_model(cfg)
    # lrs3.yaml's language model (the JAX package's evaluate.py LM shape),
    # in the model's dtype
    lm = seeded_lm(torch, "transformer", cfg.model.labels, cfg.train.seed + 1, layers=16,
                   dim=512, heads=8, hidden=2048, embed_dim=128, pos_enc="none",
                   dtype=torch.bfloat16).to(dev)
    bcfg = BeamSearchConfig(beam_size=DECODE_BEAM, ctc_weight=cfg.model.mtlalpha,
                            lm_weight=DECODE_LM_WEIGHT)
    log(f"decode: lrs3 {tuple(videos.shape)} {videos.dtype}, lengths {lengths.tolist()}, "
        f"bf16, beam {bcfg.beam_size} (pre-beam {bcfg.pre_beam_size}), ctc_weight "
        f"{bcfg.ctc_weight}, TransformerLM 16 x 512 at lm_weight {bcfg.lm_weight}, max_len "
        f"{DECODE_FRAMES}")
    beam = make_batched_beam_decoder(model, bcfg, DECODE_FRAMES, lm=lm)
    greedy = make_greedy_ctc_decoder(model)
    align = make_forced_aligner(model)

    def encode():
        with torch.inference_mode():
            enc = model.encode(videos, lengths, det=True)
            return model.ctc_log_probs(enc), model.decoder_precompute_memory(enc)

    reset_counts()
    _, steps, reads = count_decode(torch, model, lambda: beam(videos, lengths))
    _, _, g_reads = count_decode(torch, model, lambda: greedy(videos, lengths))
    _, _, a_reads = count_decode(torch, model, lambda: align(videos, lengths, labels))
    launched = read_counts()
    if any(launched.values()):
        raise AssertionError(f"decode launched port kernels: {launched}")
    encode()
    torch.cuda.reset_peak_memory_stats()
    beam_s, (toks, n, score) = time_call(torch, lambda: beam(videos, lengths))
    beam_peak = torch.cuda.max_memory_allocated() - held
    enc_s, _ = time_call(torch, encode, 3)
    torch.cuda.reset_peak_memory_stats()
    greedy_s, (g_toks, g_n) = time_call(torch, lambda: greedy(videos, lengths), 5)
    greedy_peak = torch.cuda.max_memory_allocated() - held
    torch.cuda.reset_peak_memory_stats()
    align_s, al = time_call(torch, lambda: align(videos, lengths, labels), 5)
    align_peak = torch.cuda.max_memory_allocated() - held
    one_s, (t1, n1, s1) = time_call(
        torch, lambda: make_beam_decoder(model, bcfg, DECODE_FRAMES, lm=lm)(videos[:1],
                                                                           lengths[0]), 1)

    n_cpu, toks_cpu, score_cpu = n.cpu(), toks.cpu(), score.cpu()
    log(f"  beam: {beam_s * 1e3:.2f} ms a batch ({b / beam_s:.3f} utterances/s), {steps} "
        f"steps ({(beam_s - enc_s) * 1e3 / steps:.3f} ms a step of search), {reads} host "
        f"reads, encode {enc_s * 1e3:.2f} ms, peak {beam_peak} B above {held} B held; tokens "
        f"{n_cpu.tolist()}, scores {score_cpu.tolist()}")
    if not (bool(torch.isfinite(score_cpu).all()) and 0 < steps <= DECODE_FRAMES
            and bool(((n_cpu >= 0) & (n_cpu < DECODE_FRAMES)).all())):
        raise AssertionError(f"beam: {steps} steps, counts {n_cpu.tolist()}, scores "
                             f"{score_cpu.tolist()}")
    # bf16 at B = 1 and B = 8 rounds differently (other conv algorithms and
    # GEMM tiles), so over 160 steps the best hypothesis may change; its
    # score must then stay within half of bf16's relative spacing (2^-9).
    # The f32 reference above holds the same comparison to 1e-6.
    same = torch.equal(t1.cpu(), toks_cpu[0]) and int(n1) == int(n_cpu[0])
    gap = abs(float(s1) - float(score_cpu[0])) / abs(float(score_cpu[0]))
    differ = int((t1.cpu() != toks_cpu[0]).sum())
    log(f"  one clip alone: {one_s * 1e3:.2f} ms, {int(n1)} tokens, score {float(s1)} "
        f"(batched row 0: {float(score_cpu[0])}, relative gap {gap:.3e}); tokens equal: "
        f"{same} ({differ} positions differ)")
    if not (same or gap <= 2.0 ** -9):
        raise AssertionError("make_beam_decoder on clip 0: neither row 0's tokens nor a "
                             "score within 2^-9 of row 0's")
    al_cpu, lab_cpu, len_cpu = al.cpu(), labels.cpu(), lengths.cpu()
    for i in range(b):
        path = al_cpu[i, :int(len_cpu[i])].tolist()
        want = [t for t in lab_cpu[i].tolist() if t >= 0]
        if ctc_collapse(path) != want or not (al_cpu[i, int(len_cpu[i]):] == -1).all():
            raise AssertionError(f"align row {i}: its path does not spell its labels")
    log(f"  greedy: {greedy_s * 1e3:.3f} ms a batch, tokens {g_n.tolist()}; align: "
        f"{align_s * 1e3:.3f} ms a batch, every path spells its labels")

    text = TextTransform()

    def wer(hyps, counts):
        meter = WordErrorRate()
        for i in range(b):
            meter.update(text.post_process(lab_cpu[i].numpy()),
                         text.post_process(hyps[i, :int(counts[i])].cpu().numpy()))
        return meter.wer

    summary = {
        "card": card,
        "beam_lm": {"ms_per_batch": beam_s * 1e3, "utterances_per_s": b / beam_s,
                    "steps": steps, "ms_per_step": (beam_s - enc_s) * 1e3 / steps,
                    "host_reads_per_batch": reads, "encode_ms": enc_s * 1e3,
                    "search_ms": (beam_s - enc_s) * 1e3, "peak_bytes": beam_peak,
                    "wer": wer(toks, n_cpu), "one_clip_ms": one_s * 1e3,
                    "one_clip_tokens_equal": same, "one_clip_score_gap": gap},
        "greedy": {"ms_per_batch": greedy_s * 1e3, "utterances_per_s": b / greedy_s,
                   "host_reads_per_batch": g_reads, "peak_bytes": greedy_peak,
                   "wer": wer(g_toks, g_n.cpu())},
        "align": {"ms_per_batch": align_s * 1e3, "utterances_per_s": b / align_s,
                  "frames": DECODE_FRAMES, "host_reads_per_batch": a_reads,
                  "peak_bytes": align_peak},
    }

    # launches a step from a 16-step decode of the same batch (one stage,
    # the same operations a step): a profiled 160-step decode traces ~2e5
    # launches and takes minutes, so it runs only with --profile
    short = make_batched_beam_decoder(model, bcfg, 16, lm=lm)

    def window():
        profile_decode(torch, model, summary, profile_dir, encode,
                       (("beam_lm", lambda: beam(videos, lengths), beam_s),
                        ("greedy", lambda: greedy(videos, lengths), greedy_s),
                        ("align", lambda: align(videos, lengths, labels), align_s)),
                       lambda: short(videos, lengths))
    return summary, window


def profile_decode(torch, model, summary, out_dir, encode, runs, short_beam):
    """Profiled calls: the encoder alone and a short beam decode (device
    kernel launches a search step), greedy and align (launches a batch,
    device time, idle share); with ``out_dir``, the full beam decode too,
    and the tables in ``out_dir/profile_decode_<name>.txt``."""
    import os
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def traced(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, steps, _ = count_decode(torch, model, fn)
        avgs = prof.key_averages()
        key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
               else "self_cuda_time_total")
        kern = [e for e in avgs if e.device_type == DeviceType.CUDA and getattr(e, key) > 0]
        return (avgs, key, steps, sum(e.count for e in kern),
                sum(getattr(e, key) for e in kern) / 1e3)

    enc_launches = traced(encode)[3]
    _, _, steps, launches, _ = traced(short_beam)
    beam = summary["beam_lm"]
    beam["encode_launches"] = enc_launches
    beam["launches_per_step"] = (launches - enc_launches) / steps
    log(f"profile decode: encode {enc_launches} launches; a {steps}-step beam decode "
        f"{launches}, so {beam['launches_per_step']:.1f} a step")
    for name, fn, wall_s in runs:
        if name == "beam_lm" and not out_dir:
            continue
        avgs, key, _, launches, device_ms = traced(fn)
        entry = summary[name]
        entry["launches_per_batch"] = launches
        entry["device_ms"] = device_ms
        entry["idle_share"] = 1 - device_ms / (wall_s * 1e3)
        log(f"profile decode {name}: {launches} launches, device {device_ms:.3f} ms of "
            f"{wall_s * 1e3:.3f} ms unprofiled (idle {entry['idle_share']:.1%})")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, f"profile_decode_{name}.txt"), "w") as f:
                f.write(avgs.table(sort_by=key, row_limit=60, max_name_column_width=90))
                f.write("\nby host time:\n")
                f.write(avgs.table(sort_by="self_cpu_time_total", row_limit=40,
                                   max_name_column_width=90))


# the parallel phase: data-parallel and FSDP training over a process group
PARALLEL_TIMEOUT = 420    # seconds the two processes of (b) and (c) may take
# tolerances of the world-2 runs against world 1 on the same global batch:
# bf16 (a 48-clip batch takes other cuDNN algorithms than a 96-clip one, and
# bf16 rounds each op to 2^-9): first-step metrics 1e-2 relative, the grad
# norm 2e-2, and each parameter within twice the summed learning rates of
# the rate (Adam's update of a gradient that rounding flips in sign) plus
# 1e-3 of its leaf's scale; f32 (TF32 off, deterministic cuDNN):
# tests/test_spmd.py's, metrics rtol 1e-5 and params (and the BatchNorm
# statistics) rtol 1e-4 / atol 1e-6
BF16_TOL = {"metric": 1e-2, "grad_norm": 2e-2, "param_scale": 1e-3}
F32_TOL = {"metric": 1e-5, "param_rtol": 1e-4, "param_atol": 1e-6}


def parallel_world1(torch, np, summary):
    """(a): ``python -m torch.distributed.run --standalone --nproc-per-node 1
    -m syncvsr_tpu_torch.train preset=lrw_video`` on synthetic data, 5
    steps at full width in an NCCL group of one: its first 3 losses
    against the bare step's on the same batches in this process (no group;
    the same seeds), K1/K3/K4 at 1/20/20 a step from ``metrics.jsonl``,
    and the driver's ``step_ms_ema`` (steps 3 and 4: it skips 2 and reads
    one step late) beside the bare step's time (phase 5)."""
    import os
    import shutil
    import tempfile

    from syncvsr_tpu_torch.data.synthetic import word_batch
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops import image

    tmp = tempfile.mkdtemp(prefix="syncvsr_parallel_")
    try:
        ck = os.path.join(tmp, "ck")
        env = dict(os.environ)
        root = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "1", "-m", "syncvsr_tpu_torch.train", "preset=lrw_video",
               "data.dataset=synthetic", "optim.total_steps=5", "train.log_every=1",
               "train.eval_every=1000", "train.ckpt_every=1000", f"train.ckpt_dir={ck}"]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                             timeout=CLI_TIMEOUT)
        dt = time.perf_counter() - t0
        tail = "\n".join((out.stdout + out.stderr).strip().splitlines()[-10:])
        log(f"parallel (a): {' '.join(cmd[1:])} -> exit {out.returncode} in {dt:.1f} s\n{tail}")
        if out.returncode != 0:
            raise AssertionError(f"parallel (a) failed (exit {out.returncode})")
        if "processes: 1 (nccl)" not in out.stdout:
            raise AssertionError("parallel (a): the driver did not join an NCCL group of one")
        with open(os.path.join(ck, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = [r for r in records if "train/launches/sync_ce_fwd" in r]
    per_step = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0, "bn_stats_fwd": 20,
                "bn_stats_bwd": 20}
    check_launches(steps, per_step, "parallel (a)")
    # the train losses lag one record: step 1's is in step 2's record
    got = [r["train/loss"] for r in records if "train/loss" in r][:3]
    cfg = lrw_video_cfg()
    dev = torch.device("cuda")
    model = build_model(cfg, device=dev)
    eval_t, aug = image.build_eval_transform(cfg.data), image.build_word_aug(cfg.data)

    def batch(i):
        return {k: torch.from_numpy(v).to(dev) for k, v in word_batch(cfg, seed=i).items()}

    state = create_train_state(cfg, model, eval_t(batch(0)), device=dev)
    step = build_train_step(aug_fn=aug)
    want = []
    for i in range(3):
        state, m = step(state, batch(i))
        want.append(float(m["loss"]))
    del state, model, step
    torch.cuda.empty_cache()
    worst = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    log(f"parallel (a): losses {got} against the bare step's {want}: worst {worst:.3e} "
        f"relative (tol {BF16_TOL['metric']}); step_ms_ema {steps[-1]['train/step_ms_ema']:.2f} "
        f"ms against {summary['lrw_video']['step_ms']:.2f} ms a bare step (phase 5)")
    if not (len(got) == 3 and worst <= BF16_TOL["metric"]):
        raise AssertionError("parallel (a): the driver's losses are not the bare step's")
    return {"seconds": dt, "losses": got, "bare_losses": want, "worst_rel": worst,
            "step_ms_ema": steps[-1]["train/step_ms_ema"],
            "bare_step_ms": summary["lrw_video"]["step_ms"],
            "launches_per_step": per_step}


def _flat(torch, state, moments=True):
    """Every parameter, Adam moment (unless not ``moments``) and BatchNorm
    statistic of a state, as CPU f32 copies by name (whole tensors:
    gathered from a split state, a collective)."""
    from syncvsr_tpu_torch.utils import checkpoint as ckpt

    if moments:
        whole = ckpt.gather_for_save(state)
        lists = (("param", whole.params), ("mu", whole.mu), ("nu", whole.nu))
    else:
        params = [p.data for p in state.params]
        for layout in (state.fsdp, state.tp):
            if layout is not None:
                params = layout.full(params)
        lists = (("param", params),)
    out = {}
    for what, ts in lists:
        out.update((f"{what}:{n}", t.detach().float().cpu().clone())
                   for n, t in zip(state.names, ts))
    out.update((f"stat:{n}", b.detach().float().cpu().clone())
               for n, b in state.model.named_buffers())
    return out


def _steps(torch, state, step, batch, n):
    """``n`` train steps, the kernels' counts set to 0 just before and read
    just after; (metrics of each, launches a step, ms a step after the
    first). A step replayed as a CUDA graph (a world-1 word step from its
    second on) counts its capture's launches; ``replayed_launches`` reads
    what such steps run from a trace."""
    def sync():
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()

    reset_counts()
    metrics = []
    for i in range(n):
        if i == 1:
            sync()
            t0 = time.perf_counter()
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    sync()
    ms = (time.perf_counter() - t0) * 1e3 / (n - 1)
    counts = read_counts()
    return metrics, {k: v / n for k, v in counts.items()}, ms


def _compare_flat(got, want, tol, lr_sum=0.0, zero=()):
    """(worst excess over the tolerance, its leaf) of two ``_flat`` dicts'
    parameters and BatchNorm statistics: f32 ``tol`` (rtol, atol)
    elementwise (a parameter of ``zero``, whose true gradient is 0, within
    twice ``lr_sum``: Adam turns its rounding noise into an update of
    either sign up to the rate), or bf16 each parameter within twice
    ``lr_sum`` plus ``param_scale`` of its leaf's largest; <= 0 passes."""
    worst, where = -math.inf, None
    for k, w in want.items():
        if not (k.startswith("param:") or ("param_rtol" in tol and k.startswith("stat:"))):
            continue
        g = got[k]
        if "param_rtol" in tol and k[len("param:"):] in zero:
            allowed = 2 * lr_sum + 1e-12
        elif "param_rtol" in tol:
            allowed = tol["param_atol"] + tol["param_rtol"] * w.abs()
        else:
            allowed = 2 * lr_sum + tol["param_scale"] * float(w.abs().max()) + 1e-12
        excess = float(((g - w).abs() - allowed).max())
        if excess > worst:
            worst, where = excess, k
    return worst, where


def _metrics_close(got, want, keys, rtol, norm_rtol=None):
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            tol = norm_rtol if (k == "grad_norm" and norm_rtol) else rtol
            if not abs(g[k] - w[k]) <= tol * abs(w[k]) + 1e-7:
                bad.append((i + 1, k, g[k], w[k]))
    return bad


def parallel_worker(rank, world, port, out_path, ckpt_path, device="cuda"):
    """One of the two processes of (b) and (c), both on cuda:0 in a gloo
    group (NCCL takes one rank a device); rank 0 also runs the world-1
    references (no group) on the global batches. Writes its results to
    ``out_path.<rank>``. (``device="cpu"`` rehearses it without a card.)"""
    import numpy as np
    import torch
    import torch.distributed as dist

    from syncvsr_tpu_torch.data.synthetic import sentence_batch
    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops import image
    from syncvsr_tpu_torch.parallel import create_mesh, resident_bytes, shard_batch, shard_state
    from syncvsr_tpu_torch.parallel.mesh import seed_dropout
    from syncvsr_tpu_torch.utils import checkpoint as ckpt
    from syncvsr_tpu_torch.utils import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        kernels.library()                       # built by the parent
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = create_mesh(device=dev)
    res, mark = {"seconds": {}}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res["seconds"][name] = round(now - mark[0], 1)
        mark[0] = now

    def on_dev(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()}

    def make(cfg, batch, meshed, fsdp=False):
        model = build_model(cfg, device=dev)
        state = create_train_state(cfg, model, batch, device=dev)
        if meshed:
            seed_dropout(state, mesh)
            if fsdp:
                state = shard_state(mesh, state, fsdp=True,
                                    fsdp_min_size=cfg.mesh.fsdp_min_size)
        return state

    def word_run(cfg, n, name, tol):
        """world 2 on each rank's rows, then (rank 0) world 1 on the whole."""
        whole = uint8_clips(cfg, seed=0)
        aug = image.build_word_aug(cfg.data)
        batch = shard_batch(mesh, whole)
        state = make(cfg, batch, True)
        got, launches, ms = _steps(torch, state, build_train_step(aug, mesh), batch, n)
        flat = _flat(torch, state)
        del state
        out = {"metrics": got, "launches_per_step": launches, "step_ms_two_ranks_one_card": ms}
        if rank == 0:
            state = make(cfg, on_dev(whole), False)
            want, _, ms1 = _steps(torch, state, build_train_step(aug), on_dev(whole), n)
            ref = _flat(torch, state)
            del state
            lr_sum = sum(m["learning_rate"] for m in want)
            keys = ("loss", "loss_word", "loss_audio", "acc1", "grad_norm")
            if "param_rtol" in tol:
                bad = _metrics_close(got, want, keys, tol["metric"])
            else:   # bf16: the first step (same params) at the stated tolerance
                bad = _metrics_close(got[:1], want[:1], keys, tol["metric"], tol["grad_norm"])
            excess, leaf = _compare_flat(flat, ref, tol, lr_sum)
            out.update(world1_metrics=want, world1_step_ms=ms1, bad_metrics=bad,
                       param_excess=excess, param_worst_leaf=leaf)
        torch.cuda.empty_cache()
        dist.barrier()
        res[name] = out

    # (b) lrw_video at full width, dropout 0, augmentation and CutMix on
    no_dropout = {"model.encoder.emb_dropout": 0.0, "model.encoder.msa_dropout": 0.0,
                  "model.encoder.mlp_dropout": 0.0, "model.encoder.droppath": 0.0}
    full = lrw_video_cfg()
    word_run(full.override(**no_dropout), 2, "lrw_video_bf16", BF16_TOL)
    lap("lrw_video_bf16")
    # the same at f32, 2 layers 64 wide, 3 steps
    small = full.override(**no_dropout, **{
        "model.encoder.layers": 2, "model.encoder.dim": 64, "model.encoder.heads": 2,
        "model.frontend.resnet_width": 16, "model.dtype": "float32", "data.batch_size": 8})
    # deterministic cuDNN: the C_in = 1 stem's f32 weight gradient otherwise
    # sums in another order from run to run, past test_spmd's atol
    torch.backends.cudnn.deterministic = True
    word_run(small, 3, "lrw_video_f32", F32_TOL)
    torch.backends.cudnn.deterministic = False
    lap("lrw_video_f32")
    # the preset's dropout: each rank its own masks, the state bitwise alike
    whole = uint8_clips(full, seed=1)
    batch = shard_batch(mesh, whole)
    state = make(full, batch, True)
    probe = state.dropout_gen.get_state()
    draw = torch.rand(4, generator=state.dropout_gen, device=dev)
    state.dropout_gen.set_state(probe)
    _steps(torch, state, build_train_step(image.build_word_aug(full.data), mesh), batch, 3)
    mine = torch.cat([t.reshape(-1) for t in _flat(torch, state).values()] + [draw.cpu()])
    both = torch.empty(world * mine.numel(), dtype=mine.dtype)
    dist.all_gather_into_tensor(both, mine)
    both = both.view(world, -1)
    res["lrw_video_dropout"] = {
        "state_bitwise_equal": bool(torch.equal(both[0, :-4], both[1, :-4])),
        "dropout_draws_differ": not torch.equal(both[0, -4:], both[1, -4:]),
        "elements": int(mine.numel() - 4)}
    del state, batch, mine, both
    torch.cuda.empty_cache()
    lap("lrw_video_dropout")

    # (c) lrs3 at full width and FILES_DEPTH, FSDP against data parallel, 2
    # steps each
    cfg = lrs3_cfg().override(**{"model.encoder.mlp_dropout": 0.0,
                                 "model.encoder.msa_dropout": 0.0,
                                 "model.decoder.dropout": 0.0, **FILES_LAYERS})
    whole = uint8_sentences(cfg, LRS3_FRAMES, LRS3_LABEL_LEN, LRS3_SOURCE, seed=0)
    batch = shard_batch(mesh, whole)
    aug = image.build_sentence_aug(cfg.data)
    runs = {}
    for kind in ("fsdp", "dp"):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        state = make(cfg, batch, True, fsdp=kind == "fsdp")
        before = resident_bytes(state)
        got, launches, ms = _steps(torch, state, build_train_step(aug, mesh), batch, 2)
        runs[kind] = {"metrics": got, "launches_per_step": launches,
                      "step_ms_two_ranks_one_card": ms, "resident_bytes": before,
                      "peak_bytes": (torch.cuda.max_memory_allocated()
                                     if dev.type == "cuda" else None)}
        if kind == "fsdp":
            layout = state.fsdp          # the split leaves' whole shapes
            runs[kind]["eligible_bytes"] = 4 * sum(
                int(np.prod(layout.full_shapes[i])) for i in layout.split)
            gathered = ckpt.gather_for_save(state)
            if rank == 0:
                ckpt.save_train_state(ckpt_path, gathered, state.step)
            del gathered
        runs[kind]["flat"] = _flat(torch, state)
        del state
        torch.cuda.empty_cache()
        lap(f"lrs3_{kind}")
    if rank == 0:
        keys = ("loss", "loss_ctc", "loss_att", "loss_audio", "grad_norm")
        runs["bad_metrics"] = _metrics_close(runs["fsdp"]["metrics"], runs["dp"]["metrics"],
                                             keys, F32_TOL["metric"])
        excess, leaf = _compare_flat(runs["fsdp"]["flat"], runs["dp"]["flat"], F32_TOL)
        runs.update(param_excess=excess, param_worst_leaf=leaf)
        # the FSDP checkpoint at one process: every leaf equal
        model = build_model(cfg, device=dev)
        state = create_train_state(cfg, model, on_dev(whole), device=dev)
        ckpt.restore_train_state(ckpt.latest_checkpoint(ckpt_path), state)
        loaded = _flat(torch, state)
        saved = runs["fsdp"]["flat"]
        runs["checkpoint_leaves"] = len(saved)
        runs["checkpoint_unequal"] = [k for k, v in saved.items() if not torch.equal(v, loaded[k])]
        del state, model
        lap("lrs3_checkpoint_load")
    for kind in ("fsdp", "dp"):
        del runs[kind]["flat"]
    res["lrs3_fsdp"] = runs
    dist.barrier()
    dist.destroy_process_group()
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(res, f)


def parallel_phase(torch, np, summary):
    """The ``parallel`` phase: (a) the train driver in an NCCL group of one
    (``parallel_world1``); (b) and (c) in two processes that share the card
    (gloo over CUDA tensors): ``lrw_video`` at full width on a global batch
    of 96 (48 clips a rank) against world 1 (bf16), the same at f32 on a
    2-layer 64-wide model against world 1 (f32 tolerances), 3 steps with
    the preset's dropout (the ranks' states bitwise equal, their dropout
    draws not); ``lrs3`` at full width and ``FILES_DEPTH`` on 8 x 160
    frames (4 a rank) with FSDP against data parallel: metrics and parameters, each rank's
    resident bytes, and FSDP's checkpoint at one process. Two ranks on one
    card check correctness and per-rank memory; their step times are not
    scaling. Returns the phase's summary."""
    import os
    import shutil
    import tempfile

    out = {"a_nccl_world1": parallel_world1(torch, np, summary)}
    tmp = tempfile.mkdtemp(prefix="syncvsr_parallel_")
    try:
        ranks, out["bc_seconds"] = run_workers(torch, parallel_worker, 2,
                                               os.path.join(tmp, "ck"), PARALLEL_TIMEOUT)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(check_parallel(*ranks))
    return out


def check_parallel(r0, r1):
    """The checks of (b) and (c) on the two ranks' results; the summary
    of both, with the launches of their counted steps."""
    out = {}
    word_steps = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0, "bn_stats_fwd": 20,
                  "bn_stats_bwd": 20}
    # the small f32 model's trunk (width 16 after the stem's 64 channels)
    # has a downsample BatchNorm in layer1 too: 21
    small_steps = dict(word_steps, bn_stats_fwd=21, bn_stats_bwd=21)
    for name, want_steps in (("lrw_video_bf16", word_steps), ("lrw_video_f32", small_steps)):
        got = r0[name]
        log(f"parallel (b) {name}: two ranks {got['metrics']} against world 1 "
            f"{got['world1_metrics']}; worst parameter excess over the tolerance "
            f"{got['param_excess']:.3e} ({got['param_worst_leaf']}); launches a step "
            f"{got['launches_per_step']}; {got['step_ms_two_ranks_one_card']:.2f} ms a step "
            f"(two ranks sharing one card, gloo: correctness, not scaling), world 1 "
            f"{got['world1_step_ms']:.2f} ms")
        if got["bad_metrics"] or got["param_excess"] > 0:
            raise AssertionError(f"parallel (b) {name}: world 2 is not world 1: "
                                 f"{got['bad_metrics']}, {got['param_worst_leaf']}")
        for r in (r0, r1):
            if r[name]["launches_per_step"] != {k: float(v) for k, v in want_steps.items()}:
                raise AssertionError(f"parallel (b) {name}: launches a step "
                                     f"{r[name]['launches_per_step']}")
        if r0[name]["metrics"] != r1[name]["metrics"]:
            raise AssertionError(f"parallel (b) {name}: the ranks' metrics differ")
    drop = r0["lrw_video_dropout"]
    log(f"parallel (b) dropout: {drop}")
    if not (drop["state_bitwise_equal"] and drop["dropout_draws_differ"]):
        raise AssertionError(f"parallel (b): under dropout {drop}")
    c = r0["lrs3_fsdp"]
    bn = float(sum(k for _, _, k in bn_shapes()["lrs3_fsdp2"]))   # 20 + a layer's
    sent_steps = {"sync_ce_fwd": 0.0, "sync_ce_split_fwd": 1.0, "bn_stats_fwd": bn,
                  "bn_stats_bwd": bn}
    for r in (r0, r1):
        for kind in ("fsdp", "dp"):
            if r["lrs3_fsdp"][kind]["launches_per_step"] != sent_steps:
                raise AssertionError(f"parallel (c) {kind}: launches a step "
                                     f"{r['lrs3_fsdp'][kind]['launches_per_step']}")
    fs, dp = c["fsdp"], c["dp"]
    held = {k: fs["resident_bytes"][k] / dp["resident_bytes"][k] for k in dp["resident_bytes"]}
    saved = dp["resident_bytes"]["params"] - fs["resident_bytes"]["params"]
    log(f"parallel (c) lrs3 FSDP: resident bytes a rank {fs['resident_bytes']} against data "
        f"parallel's {dp['resident_bytes']} (x{held['params']:.3f} params, "
        f"x{held['moments']:.3f} moments); the split leaves hold {fs['eligible_bytes']} bytes, "
        f"of which a rank keeps {fs['eligible_bytes'] - saved}; metrics {fs['metrics']} "
        f"against {dp['metrics']}; worst parameter excess {c['param_excess']:.3e} "
        f"({c['param_worst_leaf']}); checkpoint {c['checkpoint_leaves']} leaves, unequal "
        f"{c['checkpoint_unequal']}; peak device memory a rank {fs['peak_bytes']} FSDP, "
        f"{dp['peak_bytes']} data parallel; {fs['step_ms_two_ranks_one_card']:.2f} ms a step FSDP, "
        f"{dp['step_ms_two_ranks_one_card']:.2f} data parallel (two ranks sharing one card, "
        f"gloo: correctness, not scaling)")
    if c["bad_metrics"] or c["param_excess"] > 0:
        raise AssertionError(f"parallel (c): FSDP is not data parallel: {c['bad_metrics']}")
    moments = dp["resident_bytes"]["moments"] - fs["resident_bytes"]["moments"]
    if not (saved * 2 == fs["eligible_bytes"] and moments == fs["eligible_bytes"]):
        raise AssertionError("parallel (c): a rank does not hold half of the split leaves "
                             "and of their moments")
    if c["checkpoint_unequal"] or not c["checkpoint_leaves"]:
        raise AssertionError("parallel (c): the FSDP checkpoint does not load whole")
    log(f"parallel (b), (c): seconds {r0['seconds']}")
    out.update(b=r0, c_rank1_resident=r1["lrs3_fsdp"]["fsdp"]["resident_bytes"])
    # the kernels' launches in the two processes' counted steps
    runs = {"lrw_video_dp2": (("lrw_video_bf16", 2), ("lrw_video_f32", 3)),
            "lrs3_fsdp2": (("fsdp", 2), ("dp", 2))}
    out["per_step"] = {"lrw_video_dp2": r0["lrw_video_bf16"]["launches_per_step"],
                       "lrs3_fsdp2": c["fsdp"]["launches_per_step"]}
    out["launches"] = {k: 0 for k in word_steps}
    for r in (r0, r1):
        for path, parts in runs.items():
            for name, n in parts:
                got = r[name] if path == "lrw_video_dp2" else r["lrs3_fsdp"][name]
                for k, v in got["launches_per_step"].items():
                    out["launches"][k] += int(round(v * n))
    return out


# the tensor phase: tensor parallel (mesh.model) over processes sharing the card
TENSOR_TIMEOUT = 300     # seconds the processes of (a)+(b), and of (d), may take
# the model=2 runs against world 1 on the same batch, bf16: the first
# step's loss within 2e-3 relative and its grad norm within 1e-2 (the
# split products and the slot-split sync loss sum in other orders; bf16
# rounds each op to 2^-9), the parameters as BF16_TOL's
TP_TOL = {"loss": 2e-3, "grad_norm": 1e-2}
# a rank's resident parameter (and moment) bytes over world 1's, as the
# rule's split shares at model=2 predict (0.760 and 0.552 of the
# parameters split in two: tests/test_torch_tensor_parallel.py)
TP_HELD = {"lrs3": 0.620, "lrw_video": 0.724}
TP_MIN_DIM_SMALL = 16    # (d)'s small model: the rule at test_spmd.py's min_dim
TP_MIN_SIZE_SMALL = 256  # and its fsdp_min_size


def tensor_worker(rank, world, port, out_path, job, device="cuda"):
    """One of the processes of the tensor phase, all on cuda:0 in a gloo
    group. ``job`` "ab": world 2 as (data=1, model=2), (a) ``lrs3`` and
    (b) ``lrw_video`` at full width in bf16, 2 steps each with the rule's
    split (min_dim 512), rank 0 also the world-1 references on the same
    batch; "d": world 4 as (data=2, model=2) with FSDP on the small f32
    ``lrw_video`` model, 3 steps, rank 0 also world 1 on the global batch.
    Writes its results to ``out_path.<rank>``. (``device="cpu"`` rehearses
    it without a card.)"""
    import numpy as np
    import torch
    import torch.distributed as dist

    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops import image
    from syncvsr_tpu_torch.parallel import (
        create_mesh,
        resident_bytes,
        shard_batch,
        shard_state,
        state_shardings,
    )
    from syncvsr_tpu_torch.parallel.mesh import seed_dropout
    from syncvsr_tpu_torch.utils import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        kernels.library()                       # built by the parent
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    mesh = create_mesh(model=2, device=dev)
    res, mark = {"seconds": {}}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res["seconds"][name] = round(now - mark[0], 1)
        mark[0] = now

    def on_dev(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()}

    def make(cfg, batch, split, **rule):
        state = create_train_state(cfg, build_model(cfg, device=dev), batch, device=dev)
        if split:
            seed_dropout(state, mesh)
            state = shard_state(mesh, state, **rule)
        return state

    def run(cfg, whole, aug, n, name, rule, tol):
        """The meshed steps on this rank's rows, then (rank 0) world 1 on
        the global batch, and the comparison."""
        batch = shard_batch(mesh, whole)
        state = make(cfg, batch, True, **rule)
        held = resident_bytes(state)
        got, launches, ms = _steps(torch, state, build_train_step(aug, mesh), batch, n)
        flat = _flat(torch, state, moments=False)
        del state
        torch.cuda.empty_cache()
        out = {"metrics": got, "launches_per_step": launches, "resident_bytes": held,
               "step_ms_ranks_one_card": ms}
        if rank == 0:
            state = make(cfg, on_dev(whole), False)
            specs = state_shardings(mesh, state, **rule)
            predicted = sum(p.numel() * p.element_size()
                            // 2 ** (("model" in specs[n]) + ("data" in specs[n]))
                            for n, p in zip(state.names, state.params))
            out.update(world1_resident_bytes=resident_bytes(state), predicted_params=predicted,
                       both_axes=[n for n, sp in specs.items() if "model" in sp and "data" in sp])
            want, _, ms1 = _steps(torch, state, build_train_step(aug), on_dev(whole), n)
            ref = _flat(torch, state, moments=False)
            del state
            torch.cuda.empty_cache()
            lr_sum = sum(m["learning_rate"] for m in want)
            keys = [k for k in ("loss", "loss_word", "loss_ctc", "loss_att", "loss_audio",
                                "grad_norm") if k in want[0]]
            if "param_rtol" in tol:
                bad = _metrics_close(got, want, keys, tol["metric"])
            else:   # bf16: the first step (same params) at TP_TOL
                bad = _metrics_close(got[:1], want[:1], ("loss", "grad_norm"), TP_TOL["loss"],
                                     TP_TOL["grad_norm"])
            excess, leaf = _compare_flat(flat, ref, tol, lr_sum)
            out.update(world1_metrics=want, world1_step_ms=ms1, bad_metrics=bad,
                       param_excess=excess, param_worst_leaf=leaf)
        dist.barrier()
        res[name] = out
        lap(name)

    if job == "ab":
        # (a) lrs3 at full width: 8 x 160 frames, 12 x 768 Conformer, 6 x 768 decoder
        cfg = lrs3_cfg()
        whole = uint8_sentences(cfg, LRS3_FRAMES, LRS3_LABEL_LEN, LRS3_SOURCE, seed=0)
        run(cfg, whole, image.build_sentence_aug(cfg.data), 2, "lrs3_tp2", {}, BF16_TOL)
        # (b) lrw_video at full width, 96 clips
        cfg = lrw_video_cfg()
        run(cfg, uint8_clips(cfg, seed=0), image.build_word_aug(cfg.data), 2,
            "lrw_video_tp2", {}, BF16_TOL)
    else:
        # (d) the small f32 model on (data=2, model=2) with FSDP; deterministic
        # cuDNN, as in the parallel phase (b)
        no_dropout = {"model.encoder.emb_dropout": 0.0, "model.encoder.msa_dropout": 0.0,
                      "model.encoder.mlp_dropout": 0.0, "model.encoder.droppath": 0.0}
        small = lrw_video_cfg().override(**no_dropout, **{
            "model.encoder.layers": 2, "model.encoder.dim": 64, "model.encoder.heads": 2,
            "model.frontend.resnet_width": 16, "model.dtype": "float32",
            "data.batch_size": 8})
        torch.backends.cudnn.deterministic = True
        run(small, uint8_clips(small, seed=0), image.build_word_aug(small.data), 3,
            "small_grid", {"fsdp": True, "fsdp_min_size": TP_MIN_SIZE_SMALL,
                           "min_dim": TP_MIN_DIM_SMALL}, F32_TOL)
    dist.destroy_process_group()
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(res, f)


def run_workers(torch, fn, world, job, timeout):
    """``fn(rank, world, port, out_path, job)`` in ``world`` processes (each
    writes its results as JSON to ``out_path.<rank>``); every rank's
    results and the seconds they took."""
    import os
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="syncvsr_tensor_")
    try:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        res_path = os.path.join(tmp, "res")
        t0 = time.perf_counter()
        ctx = mp.spawn(fn, args=(world, port, res_path, job), nprocs=world, join=False)
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > timeout:
                    raise AssertionError(f"{fn.__name__}: the {world} processes ran past "
                                         f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = []
        for r in range(world):
            with open(f"{res_path}.{r}") as f:
                ranks.append(json.load(f))
        return ranks, time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_tensor_run(ranks, name, want_steps, held=None):
    """One meshed run's checks on every rank's results; its summary."""
    got = ranks[0][name]
    ratio = {k: got["resident_bytes"][k] / got["world1_resident_bytes"][k]
             for k in got["resident_bytes"]}
    predicted = got["predicted_params"] / got["world1_resident_bytes"]["params"]
    log(f"tensor {name}: {len(ranks)} ranks {got['metrics']} against world 1 "
        f"{got['world1_metrics']}; worst parameter excess over the tolerance "
        f"{got['param_excess']:.3e} ({got['param_worst_leaf']}); resident bytes a rank "
        f"{got['resident_bytes']} against world 1's {got['world1_resident_bytes']} "
        f"(x{ratio['params']:.4f} params, x{ratio['moments']:.4f} moments; the specs predict "
        f"x{predicted:.4f}{'' if held is None else f', TP_HELD x{held}'}); launches a step "
        f"{got['launches_per_step']}; {got['step_ms_ranks_one_card']:.2f} ms a step "
        f"({len(ranks)} ranks sharing one card, gloo through the host: correctness and "
        f"memory, not scaling), world 1 {got['world1_step_ms']:.2f} ms")
    if got["bad_metrics"] or got["param_excess"] > 0:
        raise AssertionError(f"tensor {name}: the meshed step is not world 1's: "
                             f"{got['bad_metrics']}, {got['param_worst_leaf']}")
    for r in ranks:
        if r[name]["launches_per_step"] != {k: float(v) for k, v in want_steps.items()}:
            raise AssertionError(f"tensor {name}: launches a step {r[name]['launches_per_step']}")
        if r[name]["metrics"] != got["metrics"]:
            raise AssertionError(f"tensor {name}: the ranks' metrics differ")
        if r[name]["resident_bytes"]["params"] != got["predicted_params"]:
            raise AssertionError(f"tensor {name}: a rank holds {r[name]['resident_bytes']}, "
                                 f"the specs predict {got['predicted_params']} params bytes")
        if r[name]["resident_bytes"]["moments"] != 2 * got["predicted_params"]:
            raise AssertionError(f"tensor {name}: Adam's moments are not split as the params")
    if held is not None and abs(ratio["params"] - held) > 0.01 * held:
        raise AssertionError(f"tensor {name}: a rank holds x{ratio['params']:.4f} of world 1's "
                             f"parameter bytes, not x{held}")
    return {k: got[k] for k in ("metrics", "world1_metrics", "param_excess",
                                "param_worst_leaf", "launches_per_step", "resident_bytes",
                                "world1_resident_bytes", "predicted_params",
                                "step_ms_ranks_one_card", "world1_step_ms")} | {
        "held_params": ratio["params"], "held_moments": ratio["moments"]}


def tensor_cli(torch, np):
    """(c): ``python -m torch.distributed.run --standalone --nproc-per-node 2
    -m syncvsr_tpu_torch.train preset=lrs3 mesh.model=2 mesh.fsdp=true``
    at full width and ``FILES_DEPTH`` ((a) runs the full depth) on
    synthetic data, 2 steps (the two processes share the card over gloo):
    rank 0 holds the bytes the specs predict, and its checkpoint, gathered
    from both ranks, loads at one process with every leaf of the file
    equal."""
    import os
    import shutil
    import tempfile

    from syncvsr_tpu_torch.engine import create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.parallel import Mesh, state_shardings
    from syncvsr_tpu_torch.utils import checkpoint as ckpt

    tmp = tempfile.mkdtemp(prefix="syncvsr_tensor_cli_")
    try:
        ck = os.path.join(tmp, "ck")
        env = dict(os.environ)
        root = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "syncvsr_tpu_torch.train", "preset=lrs3",
               *FILES_DEPTH, "data.dataset=synthetic", "data.batch_size=8", "mesh.model=2",
               "mesh.fsdp=true",
               "optim.total_steps=2", "train.log_every=1", "train.eval_every=1000",
               "train.ckpt_every=1000", f"train.ckpt_dir={ck}"]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                             timeout=CLI_TIMEOUT)
        dt = time.perf_counter() - t0
        tail = "\n".join((out.stdout + out.stderr).strip().splitlines()[-12:])
        log(f"tensor (c): {' '.join(cmd[1:])} -> exit {out.returncode} in {dt:.1f} s\n{tail}")
        if out.returncode != 0:
            raise AssertionError(f"tensor (c) failed (exit {out.returncode})")
        if "mesh data 1 x seq 1 x model 2" not in out.stdout:
            raise AssertionError("tensor (c): the driver did not make a model axis of 2")
        held = int(out.stdout.split("[train] state a rank holds: params ")[1].split(" B")[0])
        path = ckpt.latest_checkpoint(ck)
        records = train_records(ck)
        cfg = lrs3_cfg().override(**FILES_LAYERS)
        dev = torch.device("cuda")
        batch = {"videos": torch.zeros((1, 4, 88, 88, 1), device=dev),
                 "lengths": torch.full((1,), 4, device=dev)}
        state = create_train_state(cfg, build_model(cfg, device=dev), batch, device=dev)
        full = sum(p.numel() * p.element_size() for p in state.params)
        specs = state_shardings(Mesh(size=2, rank=0, device=dev, model=2), state)
        predicted = sum(p.numel() * p.element_size() // (2 if "model" in specs[n] else 1)
                        for n, p in zip(state.names, state.params))
        ckpt.restore_train_state(path, state)
        saved = ckpt.load_msgpack(path)
        loaded = ckpt.state_payload(state)
        unequal = [f"{key}:{k}" for key in ("params", "opt_state", "batch_stats")
                   for k, v in ckpt.flatten(saved[key]).items()
                   if not np.array_equal(v, ckpt.flatten(loaded[key])[k])]
        leaves = sum(len(ckpt.flatten(saved[key])) for key in ("params", "opt_state",
                                                                "batch_stats"))
        del state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ratio = held / full
    log(f"tensor (c): rank 0 held {held} parameter bytes, x{ratio:.4f} of the whole "
        f"{full} (the specs predict {predicted}); its checkpoint step {int(saved['step'])}: "
        f"{leaves} leaves, unequal after the load at one process {unequal}; losses "
        f"{[r['train/loss'] for r in records if 'train/loss' in r]}")
    if unequal or not leaves or int(saved["step"]) != 2:
        raise AssertionError("tensor (c): the checkpoint does not load whole at one process")
    if held != predicted:
        raise AssertionError(f"tensor (c): a rank holds {held} parameter bytes, the specs "
                             f"predict {predicted}")
    return {"seconds": dt, "held_params": ratio, "checkpoint_leaves": leaves}


def tensor_phase(torch, np, summary):
    """The ``tensor`` phase: tensor parallel (``mesh.model=2``) with the
    processes sharing the card over gloo (NCCL takes one rank a device):
    (a) ``lrs3`` and (b) ``lrw_video`` at full width against world 1 on
    the same batch (bf16, ``TP_TOL``; each rank's resident bytes against
    ``TP_HELD``; K1 on each rank's 4 of 8 slots: ``lrs3``'s local head is
    [768, 4 x 320], 2.36 MiB, which the 4 MiB rule gives K1, not K2);
    (c) the train driver under ``torch.distributed.run`` with
    ``mesh.model=2 mesh.fsdp=true`` and its checkpoint at one process;
    (d) four processes as (data=2, model=2) with FSDP on the small f32
    model (``F32_TOL``, the rule at min_dim 16 so a leaf carries both
    axes) against world 1. Step times of ranks sharing a card check
    correctness and memory, not scaling. Returns the phase's summary."""
    t0 = time.perf_counter()
    out, launches = {}, {k: 0 for k in counters()}
    ranks, out["ab_seconds"] = run_workers(torch, tensor_worker, 2, "ab", TENSOR_TIMEOUT)
    log(f"tensor (a), (b): seconds {ranks[0]['seconds']}")
    sent = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0, "bn_stats_fwd": 32, "bn_stats_bwd": 32}
    word = {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0, "bn_stats_fwd": 20, "bn_stats_bwd": 20}
    out["lrs3_tp2"] = check_tensor_run(ranks, "lrs3_tp2", sent, TP_HELD["lrs3"])
    out["lrw_video_tp2"] = check_tensor_run(ranks, "lrw_video_tp2", word,
                                            TP_HELD["lrw_video"])
    out["c"] = tensor_cli(torch, np)
    ranks4, out["d_seconds"] = run_workers(torch, tensor_worker, 4, "d", TENSOR_TIMEOUT)
    small = dict(word, bn_stats_fwd=21, bn_stats_bwd=21)
    out["small_grid"] = check_tensor_run(ranks4, "small_grid", small)
    if not ranks4[0]["small_grid"]["both_axes"]:
        raise AssertionError("tensor (d): no leaf carries both axes")
    log(f"tensor (d): leaves on both axes {ranks4[0]['small_grid']['both_axes'][:6]} ...")
    for rs, runs in ((ranks, (("lrs3_tp2", 2), ("lrw_video_tp2", 2))),
                     (ranks4, (("small_grid", 3),))):
        for r in rs:
            for name, n in runs:
                for k, v in r[name]["launches_per_step"].items():
                    launches[k] += int(round(v * n))
    out["launches"] = launches
    out["per_step"] = {p: out[p]["launches_per_step"] for p in ("lrs3_tp2", "lrw_video_tp2")}
    out["seconds"] = time.perf_counter() - t0
    log(f"tensor: {out['seconds']:.1f} s in all; a two-rank step "
        f"{out['lrs3_tp2']['step_ms_ranks_one_card']:.2f} ms (lrs3), "
        f"{out['lrw_video_tp2']['step_ms_ranks_one_card']:.2f} ms (lrw_video): two ranks "
        "sharing one card over gloo, which stages through the host: correctness and "
        "memory, not scaling")
    return out


# the seq phase: sequence parallel (mesh.seq=2), the processes sharing the card
SEQ_TIMEOUT = 540   # seconds the processes of (a)+(b)+(e), and of (d), may take
# lrs3's K1-K4 launches a step at seq=2: K2 on a rank's frames (the head is
# whole), each BatchNorm once (no remat)
SEQ_SENTENCE = {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1, "bn_stats_fwd": 32,
                "bn_stats_bwd": 32}
SEQ_SMALL_FRAMES = 32    # (d)'s small sentence model: 16 frames a rank
# the full-width runs of (a), (b) and (e), two ranks each
SEQ_AB = ("lrs3_1800_sp2", "lrs3_sp2", "lrs3_audio_sp2")
# (d)'s f32 tolerances: tests/test_spmd.py's for its (data=4, seq=2) step,
# metrics rtol 1e-5 and params rtol 1e-4 / atol 1e-5 (splitting time
# re-associates f32 reductions, here the stem conv's weight gradient summed
# over two half clips, and Adam turns the noise of its near-zero elements
# into updates of either sign up to the rate: 1.4e-6 apart at 1e-6 rates
# on an H100)
SEQ_F32_TOL = {"metric": 1e-5, "param_rtol": 1e-4, "param_atol": 1e-5}


def small_sentence_cfg():
    """(d)'s small f32 ``lrs3`` model: 2 + 1 layers 64 wide (k = 31 depthwise
    conv, a 15-frame halo), ResNet width 16, 4 clips; dropout 0 (data index
    1 draws its own masks, by design, so (data=2, seq=2) would not be world
    1's)."""
    return lrs3_cfg().override(**{
        "model.encoder.mlp_dropout": 0.0, "model.encoder.msa_dropout": 0.0,
        "model.decoder.dropout": 0.0,
        "model.encoder.layers": 2, "model.encoder.dim": 64, "model.encoder.heads": 2,
        "model.decoder.layers": 1, "model.decoder.dim": 64, "model.decoder.heads": 2,
        "model.decoder.hidden": 128, "model.frontend.resnet_width": 16,
        "model.dtype": "float32", "data.batch_size": 4})


def small_word_cfg(frames):
    """(d)'s small f32 ``lrw_video`` model at ``frames`` frames (40:
    ``lrw1000``'s clip length, split 20 + 20; 29: indivisible, the seq ranks
    repeat the rows), augmentation, CutMix and dropout as the preset."""
    return lrw_video_cfg().override(**{
        "model.encoder.layers": 2, "model.encoder.dim": 64, "model.encoder.heads": 2,
        "model.frontend.resnet_width": 16, "model.dtype": "float32",
        "data.batch_size": 8, "data.num_frames": frames})


def seq_worker(rank, world, port, out_path, job, device="cuda"):
    """One of the processes of the seq phase, all on cuda:0 in a gloo group.
    ``job`` "ab": world 2 as (data=1, seq=2), (a) ``lrs3_1800`` (bf16, 2 x
    1800 frames, no remat) and (b) ``lrs3`` (8 x 160 frames) at full width
    and depth, 2 steps each on the rank's frames, rank 0 also world 1 on the
    same batch; "d": world 4, the small f32 ``lrs3`` model as (data=2,
    seq=2) with FSDP and as (seq=2, model=2), and the small ``lrw_video``
    model at 40 and 29 frames as (seq=2, model=2), 2 steps each against
    world 1. Peak device memory a rank (``max_memory_allocated`` over the
    state and the steps) beside world 1's. Writes its results to
    ``out_path.<rank>``. (``device="cpu"`` rehearses it without a card.)"""
    import numpy as np
    import torch
    import torch.distributed as dist

    from syncvsr_tpu_torch.engine import build_train_step, create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.ops import image
    from syncvsr_tpu_torch.parallel import (
        create_mesh,
        resident_bytes,
        shard_batch,
        shard_state,
    )
    from syncvsr_tpu_torch.parallel.mesh import seed_dropout
    from syncvsr_tpu_torch.utils import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(0)
        kernels.library()                       # built by the parent
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    res, mark = {"seconds": {}}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        res["seconds"][name] = round(now - mark[0], 1)
        mark[0] = now

    def on_dev(b):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in b.items()}

    def peak_from():
        if not cuda:
            return None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def peak_since(base):
        return None if base is None else torch.cuda.max_memory_allocated() - base

    def run(cfg, whole, aug, n, name, mesh, tol, rule=None):
        """The meshed steps on this rank's rows and frames, then (rank 0)
        world 1 on the global batch, and the comparison."""
        base = peak_from()
        model = build_model(cfg, device=dev)
        batch = shard_batch(mesh, whole, model.frontend.frame)   # a waveform by frames
        state = create_train_state(cfg, model, batch, device=dev)
        seed_dropout(state, mesh)
        if rule:
            state = shard_state(mesh, state, **rule)
        got, launches, ms = _steps(torch, state, build_train_step(aug, mesh), batch, n)
        peak = peak_since(base)
        held = resident_bytes(state)
        flat = _flat(torch, state, moments=False)
        zero = zero_gradient_leaves(model)
        del state, model
        if cuda:
            torch.cuda.empty_cache()
        time_split = getattr(batch, "time", None)
        out = {"metrics": got, "launches_per_step": launches, "peak_bytes": peak,
               "resident_bytes": held, "step_ms_ranks_one_card": ms,
               "frames": None if time_split is None else [time_split.start,
                                                          time_split.length]}
        if rank == 0:
            base = peak_from()
            state = create_train_state(cfg, build_model(cfg, device=dev), on_dev(whole),
                                       device=dev)
            want, want_launches, ms1 = _steps(torch, state, build_train_step(aug),
                                              on_dev(whole), n)
            peak1 = peak_since(base)
            ref = _flat(torch, state, moments=False)
            del state
            if cuda:
                torch.cuda.empty_cache()
            lr_sum = sum(m["learning_rate"] for m in want)
            keys = [k for k in ("loss", "loss_word", "loss_ctc", "loss_att", "loss_audio",
                                "grad_norm") if k in want[0]]
            if "param_rtol" in tol:
                bad = _metrics_close(got, want, keys, tol["metric"])
            else:   # bf16: the first step (same params) at TP_TOL
                bad = _metrics_close(got[:1], want[:1], ("loss", "grad_norm"), TP_TOL["loss"],
                                     TP_TOL["grad_norm"])
            excess, leaf = _compare_flat(flat, ref, tol, lr_sum, zero=zero)
            out.update(world1_metrics=want, world1_step_ms=ms1, world1_peak_bytes=peak1,
                       world1_launches_per_step=want_launches, bad_metrics=bad,
                       param_excess=excess, param_worst_leaf=leaf)
        dist.barrier()
        res[name] = out
        lap(name)

    if job == "ab":
        mesh = create_mesh(seq=2, device=dev)
        # (a) lrs3_1800: 2 x 1800 frames, full width and depth, no remat
        cfg = lrs3_1800_cfg(remat=False)
        whole = uint8_sentences(cfg, LRS3_1800_FRAMES, LRS3_1800_LABEL_LEN, LRS3_SOURCE,
                                seed=0)
        run(cfg, whole, image.build_sentence_aug(cfg.data), 2, "lrs3_1800_sp2", mesh,
            BF16_TOL)
        # (b) lrs3 at 8 x 160 frames
        cfg = lrs3_cfg()
        whole = uint8_sentences(cfg, LRS3_FRAMES, LRS3_LABEL_LEN, LRS3_SOURCE, seed=0)
        run(cfg, whole, image.build_sentence_aug(cfg.data), 2, "lrs3_sp2", mesh, BF16_TOL)
        # (e) lrs3_audio at 32 x 102400 samples: each rank takes 51200 (its
        # 80 frames), ResNet1D's convs with halos at every stage
        from syncvsr_tpu_torch.data.synthetic import sentence_batch

        cfg = lrs3_audio_cfg()
        whole = sentence_batch(cfg, num_frames=AUDIO_FRAMES, label_len=AUDIO_LABEL_LEN, seed=0)
        run(cfg, whole, None, 2, "lrs3_audio_sp2", mesh, BF16_TOL)
    else:
        # (d) small f32 models, deterministic cuDNN as in the tensor phase (d)
        if cuda:
            torch.backends.cudnn.deterministic = True
        data_seq = create_mesh(data=2, seq=2, device=dev)
        seq_model = create_mesh(seq=2, model=2, device=dev)
        cfg = small_sentence_cfg()
        whole = uint8_sentences(cfg, SEQ_SMALL_FRAMES, 8, 64, seed=0)
        aug = image.build_sentence_aug(cfg.data)
        run(cfg, whole, aug, 2, "small_data_seq_fsdp", data_seq, SEQ_F32_TOL,
            {"fsdp": True, "fsdp_min_size": TP_MIN_SIZE_SMALL})
        run(cfg, whole, aug, 2, "small_seq_model", seq_model, SEQ_F32_TOL,
            {"min_dim": TP_MIN_DIM_SMALL})
        for frames in (40, 29):
            cfg = small_word_cfg(frames)
            run(cfg, uint8_clips(cfg, seed=0), image.build_word_aug(cfg.data), 2,
                f"small_word{frames}_seq_model", seq_model, SEQ_F32_TOL,
                {"min_dim": TP_MIN_DIM_SMALL})
    dist.destroy_process_group()
    with open(f"{out_path}.{rank}", "w") as f:
        json.dump(res, f)


def check_seq_run(ranks, name, want_steps=None):
    """One seq run's checks on every rank's results; its summary. Launches
    a step: ``want_steps``, or where None world 1's (K3/K4 alike, K1 + K2
    one call a sync head)."""
    got = ranks[0][name]
    peak, peak1 = got["peak_bytes"], got["world1_peak_bytes"]
    share = None if not (peak and peak1) else peak / peak1
    log(f"seq {name}: {len(ranks)} ranks (frames {[r[name]['frames'] for r in ranks]}) "
        f"{got['metrics']} against world 1 {got['world1_metrics']}; worst parameter excess "
        f"over the tolerance {got['param_excess']:.3e} ({got['param_worst_leaf']}); peak "
        f"device memory a rank {[r[name]['peak_bytes'] for r in ranks]} B against world 1's "
        f"{peak1} B (x{share}); launches a step {got['launches_per_step']} (world 1 "
        f"{got['world1_launches_per_step']}); {got['step_ms_ranks_one_card']:.2f} ms a step "
        f"({len(ranks)} ranks sharing one card, gloo through the host: correctness and "
        f"memory, not scaling), world 1 {got['world1_step_ms']:.2f} ms")
    if got["bad_metrics"] or got["param_excess"] > 0:
        raise AssertionError(f"seq {name}: the meshed step is not world 1's: "
                             f"{got['bad_metrics']}, {got['param_worst_leaf']}")
    w1 = got["world1_launches_per_step"]
    for r in ranks:
        have = r[name]["launches_per_step"]
        if want_steps is not None:
            ok = have == {k: float(v) for k, v in want_steps.items()}
        else:
            ok = (all(have[k] == w1[k] for k in ("bn_stats_fwd", "bn_stats_bwd"))
                  and have["sync_ce_fwd"] + have["sync_ce_split_fwd"]
                  == w1["sync_ce_fwd"] + w1["sync_ce_split_fwd"])
        if not ok:
            raise AssertionError(f"seq {name}: launches a step {have}")
        if r[name]["metrics"] != got["metrics"]:
            raise AssertionError(f"seq {name}: the ranks' metrics differ")
    return {k: got[k] for k in ("metrics", "world1_metrics", "param_excess",
                                "param_worst_leaf", "launches_per_step", "peak_bytes",
                                "world1_peak_bytes", "step_ms_ranks_one_card",
                                "world1_step_ms", "frames")} | {"peak_share": share}


# (c)'s tree: one clip a bucket of the lrs3 recipe (160 ... 1800 frames, each
# even, so every batch splits over seq=2), read from the pkls
SEQ_FILES_TRAIN, SEQ_FILES_VAL = [150, 300, 600, 1100, 1700], [120]


def seq_cli(torch, np):
    """(c): ``python -m torch.distributed.run --standalone --nproc-per-node 2
    -m syncvsr_tpu_torch.train preset=lrs3 mesh.seq=2`` at full width and
    ``FILES_DEPTH`` with ``model.remat`` (its recompute replays the
    frames' collectives) over a synthetic LRS3 tree's bucket schedule
    (one clip a bucket, 160 to 1800 frames, at most ``FILES_MBF`` frames a
    batch), an epoch; its checkpoint loads at one process with every leaf
    of the file equal."""
    import os
    import shutil
    import tempfile

    from syncvsr_tpu_torch.data.synthetic_tree import write_lrs_tree
    from syncvsr_tpu_torch.engine import create_train_state
    from syncvsr_tpu_torch.models import build_model
    from syncvsr_tpu_torch.utils import checkpoint as ckpt

    tmp = tempfile.mkdtemp(prefix="syncvsr_seq_cli_")
    try:
        root = os.path.join(tmp, "files")
        write_lrs_tree(root, "LRS3", {"train": SEQ_FILES_TRAIN, "val": SEQ_FILES_VAL},
                       seed=8)
        ck = os.path.join(tmp, "ck")
        env = dict(os.environ)
        here = os.path.dirname(os.path.abspath(__file__))
        env["PYTHONPATH"] = os.pathsep.join(p for p in (here, env.get("PYTHONPATH")) if p)
        steps = len(SEQ_FILES_TRAIN)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc-per-node", "2", "-m", "syncvsr_tpu_torch.train", "preset=lrs3",
               *FILES_DEPTH, "data.dataset=lrs3", f"data.root={root}", "mesh.seq=2",
               f"data.max_batch_frames={FILES_MBF}", "model.remat=true",
               f"optim.total_steps={steps}", "train.log_every=1", "train.eval_every=1000",
               "train.ckpt_every=1000", f"train.ckpt_dir={ck}"]
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                             timeout=CLI_TIMEOUT)
        dt = time.perf_counter() - t0
        tail = "\n".join((out.stdout + out.stderr).strip().splitlines()[-12:])
        log(f"seq (c): {' '.join(cmd[1:])} -> exit {out.returncode} in {dt:.1f} s\n{tail}")
        if out.returncode != 0:
            raise AssertionError(f"seq (c) failed (exit {out.returncode})")
        if "mesh data 1 x seq 2 x model 1" not in out.stdout:
            raise AssertionError("seq (c): the driver did not make a seq axis of 2")
        path = ckpt.latest_checkpoint(ck)
        records = train_records(ck)
        cfg = lrs3_cfg().override(**FILES_LAYERS)
        dev = torch.device("cuda")
        batch = {"videos": torch.zeros((1, 4, 88, 88, 1), device=dev),
                 "lengths": torch.full((1,), 4, device=dev)}
        state = create_train_state(cfg, build_model(cfg, device=dev), batch, device=dev)
        ckpt.restore_train_state(path, state)
        saved = ckpt.load_msgpack(path)
        loaded = ckpt.state_payload(state)
        unequal = [f"{key}:{k}" for key in ("params", "opt_state", "batch_stats")
                   for k, v in ckpt.flatten(saved[key]).items()
                   if not np.array_equal(v, ckpt.flatten(loaded[key])[k])]
        leaves = sum(len(ckpt.flatten(saved[key])) for key in ("params", "opt_state",
                                                                "batch_stats"))
        del state
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    loss = [r["train/loss"] for r in records if "train/loss" in r]
    log(f"seq (c): its checkpoint step {int(saved['step'])}: {leaves} leaves, unequal "
        f"after the load at one process {unequal}; losses {loss}; launches a step "
        f"{[{k.split('/')[-1]: v for k, v in r.items() if '/launches/' in k} for r in records if 'train/loss' in r]}")
    if unequal or not leaves or int(saved["step"]) != steps:
        raise AssertionError("seq (c): the checkpoint does not load whole at one process")
    if not (len(loss) >= steps - 1 and all(math.isfinite(v) for v in loss)):
        raise AssertionError(f"seq (c): the driver's losses {loss}")
    check_launches([r for r in records if "train/launches/sync_ce_fwd" in r],
                   {"sync_ce_fwd": 0, "sync_ce_split_fwd": 1, "bn_stats_fwd": 44,
                    "bn_stats_bwd": 22}, "seq (c)")
    return {"seconds": dt, "checkpoint_leaves": leaves, "losses": loss}


def seq_phase(torch, np, summary):
    """The ``seq`` phase: sequence parallel (``mesh.seq=2``), each rank on
    its frames of every clip, with the processes sharing the card over gloo
    (NCCL takes one rank a device): (a) ``lrs3_1800`` (2 x 1800 frames, no
    remat) and (b) ``lrs3`` (8 x 160) at full width and depth against world
    1 on the same batch (bf16: the first step's loss and grad norm at
    ``TP_TOL``, the parameters at ``BF16_TOL`` after 2 steps), K2/K3/K4 on
    a rank's frames, a rank's peak device memory beside world 1's; (c) the
    train driver under ``torch.distributed.run`` with ``mesh.seq=2`` over a
    bucket schedule from files and its checkpoint at one process, while
    (d) runs in four processes: a small f32 ``lrs3`` model as (data=2, seq=2) with FSDP and
    as (seq=2, model=2), and a small ``lrw_video`` model at 40 and 29
    frames (the fallback) as (seq=2, model=2), against world 1
    (``SEQ_F32_TOL``). Step times of ranks sharing a card check correctness
    and memory, not scaling. Returns the phase's summary."""
    t0 = time.perf_counter()
    out, launches = {}, {k: 0 for k in counters()}
    ranks, out["ab_seconds"] = run_workers(torch, seq_worker, 2, "ab", SEQ_TIMEOUT)
    log(f"seq (a), (b): seconds {ranks[0]['seconds']}")
    for name in SEQ_AB:
        out[name] = check_seq_run(ranks, name, SEQ_SENTENCE)
    audio = out["lrs3_audio_sp2"]
    if not (audio["peak_share"] and audio["peak_share"] < 1.0):
        raise AssertionError(f"seq (e): a rank's peak {audio['peak_bytes']} B is not below "
                             f"world 1's {audio['world1_peak_bytes']} B")
    if audio["frames"] != [0, AUDIO_FRAMES // 2]:
        raise AssertionError(f"seq (e): rank 0 held frames {audio['frames']} of the waveform")
    from concurrent.futures import ThreadPoolExecutor

    # (c) beside (d): (d)'s small models leave the card and the host room
    with ThreadPoolExecutor(1) as pool:
        c = pool.submit(seq_cli, torch, np)
        ranks4, out["d_seconds"] = run_workers(torch, seq_worker, 4, "d", SEQ_TIMEOUT)
        out["c"] = c.result()
    log(f"seq (d): seconds {ranks4[0]['seconds']}")
    small = ("small_data_seq_fsdp", "small_seq_model", "small_word40_seq_model",
             "small_word29_seq_model")
    for name in small:
        out[name] = check_seq_run(ranks4, name)
    if out["small_word29_seq_model"]["frames"] is not None:
        raise AssertionError("seq (d): 29 frames were split over seq=2")
    for rs, names in ((ranks, SEQ_AB), (ranks4, small)):
        for r in rs:
            for name in names:
                for k, v in r[name]["launches_per_step"].items():
                    launches[k] += int(round(v * 2))
    out["launches"] = launches
    out["per_step"] = {p: out[p]["launches_per_step"] for p in SEQ_AB}
    out["seconds"] = time.perf_counter() - t0
    a = out["lrs3_1800_sp2"]
    log(f"seq: {out['seconds']:.1f} s in all; lrs3_1800 at seq=2: a rank's peak "
        f"{a['peak_bytes'] / 2**30:.2f} GiB against world 1's "
        f"{a['world1_peak_bytes'] / 2**30:.2f} GiB; a two-rank step "
        f"{a['step_ms_ranks_one_card']:.2f} ms (lrs3_1800), "
        f"{out['lrs3_sp2']['step_ms_ranks_one_card']:.2f} ms (lrs3): two ranks sharing one "
        "card over gloo, which stages through the host: correctness and memory, not scaling")
    return out


# the tools phase: each measurement tool (syncvsr_tpu_torch/tools/) once on
# the card at toy widths (``--tiny``), all in one process (a chain of the CLI
# phase; every mode runs in tests/test_torch_tools.py on the CPU), and, with
# ``--tools-full``, every mode at full size, a process each, one at a time,
# alone, for their numbers. ``profile_step`` comes last: a process that
# torch.profiler has traced pays more host time a launch afterwards
TOOL_RUNS = [
    ("bench_loader", ["--tiny", "--threads", "2"]),
    ("bench_decode", ["beam", "--tiny", "--frames", "40"]),
    ("bench_beam_parts", ["100", "40", "--steps", "10", "--tiny"]),
    ("bench_stem", ["--tiny", "--iters", "3"]),
    ("bench_bn", ["micro", "--tiny", "--iters", "5"]),
    ("bench_aux_workloads", ["--tiny", "--steps", "2"]),
    ("bisect_bs16", ["att", "2", "--tiny", "--steps", "2"]),
    ("profile_step", ["lrs3", "--tiny", "--steps", "2"]),
]
TOOL_RUNS_FULL = [
    ("bench_loader", []), ("bench_loader", ["--sentence"]),
    ("bench_decode", ["beam"]), ("bench_decode", ["greedy"]),
    ("bench_decode", ["train1800"]), ("bench_decode", ["testset"]),
    ("bench_decode", ["trained"]), ("bench_beam_parts", []), ("bench_stem", []),
    ("profile_step", ["lrw"]), ("profile_step", ["lrs3"]),
    ("bench_bn", ["micro"]), ("bench_bn", ["step"]), ("bench_aux_workloads", []),
] + [("bisect_bs16", [v]) for v in ("frontend", "encoder", "model", "ctc", "att", "sync",
                                      "dec", "lsm", "modelmetrics", "full")]
TOOLS_TIMEOUT = 600   # seconds a tool may take
# runs each (name, arguments) of argv[1] (JSON) through the tool's ``main``,
# its standard output captured: one JSON list of {seconds, stdout, error}
TOOLS_RUNNER = """
import contextlib, importlib, io, json, sys, time, traceback
done = []
for name, args in json.loads(sys.argv[1]):
    buf, err, t0 = io.StringIO(), None, time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            importlib.import_module("syncvsr_tpu_torch.tools." + name).main(args)
    except Exception:
        err = traceback.format_exc()
    done.append({"seconds": time.perf_counter() - t0, "stdout": buf.getvalue(), "error": err})
print(json.dumps(done))
"""


def run_tools(runs):
    """The tools of ``runs`` in one process (``TOOLS_RUNNER``) from the
    repository's root: each run's (seconds, JSON line), which must come
    from the card (``device`` cuda, the card's name and power limit), or
    raises with the end of its output."""
    import os

    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-c", TOOLS_RUNNER, json.dumps(runs)]
    out = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                         timeout=TOOLS_TIMEOUT * len(runs))
    try:
        done = json.loads(out.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        tail = "\n".join((out.stdout + out.stderr).strip().splitlines()[-12:])
        raise AssertionError(f"tools: {[r[0] for r in runs]} -> exit {out.returncode}:\n{tail}")
    got = []
    for (name, args), d in zip(runs, done):
        lines = d["stdout"].strip().splitlines()
        try:
            line = json.loads(lines[-1])
        except (IndexError, ValueError):
            line = None
        if (d["error"] or not isinstance(line, dict) or line.get("tool") != name
                or not str(line.get("device")).startswith("cuda") or not line.get("card")):
            tail = "\n".join((d["stdout"] + (d["error"] or "")).strip().splitlines()[-12:])
            raise AssertionError(f"tools: {' '.join([name] + args)} in {d['seconds']:.1f} s, "
                                 f"no JSON line from the card:\n{tail}")
        got.append((d["seconds"], line))
    return got


def tools_chain(tmp):
    """The ``tools`` phase as one more chain of the CLI phase
    (``cli_files``): ``TOOL_RUNS`` in one process, beside the CLIs' chains
    (their processes wait on the host most of the time)."""
    return {"tools": tools_phase(TOOL_RUNS, together=True)}


def tools_phase(runs, together):
    """The ``tools`` phase: every measurement tool of the port once on the
    card (``runs``), in one process if ``together``, else a process each,
    one at a time, each line parsed and checked (``run_tools``);
    ``bench_aux_workloads``' steps must launch K1 once a ``lrw_landmark``
    step, and K2 (at full size; K1 at toy widths) once and K3/K4 under
    every BatchNorm a ``lrs3_audio`` step. Returns {run: {"seconds",
    "line"}}."""
    t0 = time.perf_counter()
    done = (run_tools(runs) if together
            else [got for run in runs for got in run_tools([run])])
    out = {}
    for (name, args), (dt, line) in zip(runs, done):
        key = " ".join([name] + args)
        out[key] = {"seconds": dt, "line": line}
        log(f"tools {key}: {dt:.1f} s: {json.dumps(line)}")
        if name == "bench_aux_workloads":
            # each path's kernels a step: K1 (the toy heads are under K2's
            # 4 MiB) or K2 at full size, and K3/K4 under every BatchNorm
            # (ResNet1D's 20 and the Conformer's, one a layer)
            full = "--tiny" not in args
            bn = 32 if full else 21
            want = {"lrw_landmark": {"sync_ce_fwd": 1, "sync_ce_split_fwd": 0,
                                     "bn_stats_fwd": 0, "bn_stats_bwd": 0},
                    "lrs3_audio": {"sync_ce_fwd": int(not full), "sync_ce_split_fwd": int(full),
                                   "bn_stats_fwd": bn, "bn_stats_bwd": bn}}
            for path, counts in want.items():
                if line[path]["launches_per_step"] != counts:
                    raise AssertionError(f"tools {key}: {path} launched "
                                         f"{line[path]['launches_per_step']} a step")
    log(f"tools: {len(runs)} runs in {time.perf_counter() - t0:.1f} s")
    return out


def main():
    import argparse
    import atexit
    import shutil
    import tempfile

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="after each train phase, profile 3 steps and write the table to DIR")
    ap.add_argument("--tools-full", action="store_true",
                    help="only build the kernels and run each measurement tool at full size, "
                         "one at a time (TOOL_RUNS_FULL); no ok line")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs only on a GPU")
        return 1
    from syncvsr_tpu_torch.utils import kernels

    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}; {card}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # each phase's seconds, for the time limit
    seconds, mark = {}, [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        seconds[name] = round(now - mark[0], 1)
        mark[0] = now

    lib, build_log = kernels.build(force=True)
    log(f"build: {lib} in {time.perf_counter() - mark[0]:.1f} s\n{build_log}")
    kernels.library()
    lap("build")
    if args.tools_full:
        log(f"tools (full size): {json.dumps(tools_phase(TOOL_RUNS_FULL, False))} on {card}")
        return 0

    # the fairseq checkpoints of the in-step codec, removed at exit
    codec_dir = tempfile.mkdtemp(prefix="syncvsr_codec_")
    atexit.register(shutil.rmtree, codec_dir, True)
    write_codecs(codec_dir)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # every profiler window runs after every timing: once torch.profiler has
    # traced a process, its later launches can cost the host more
    later = []
    entries = [check_sync(torch, dev, "mono", later), check_sync(torch, dev, "split", later)]
    bn_entries, retime_k4 = check_bn(torch, dev, later)
    past = check_bn_past_int32(torch, dev)
    for e, kind in zip(bn_entries, ("fwd", "bwd")):
        e["past_int32"] = {"n": past["n"], "c": past["c"], **past[kind]}
    entries += bn_entries
    lap("kernels")
    for path in PATH_KERNELS:
        check_reference(torch, np, path)
    decode_ref = check_decode_reference(torch, np)
    lap("references")
    torch.backends.cudnn.benchmark = True     # the warm-up steps absorb the autotuning
    summary, per_step, windows = {}, {}, []
    launches = {k: 0 for k in counters()}
    for path in PATH_KERNELS:
        run = {"lrs3_1800": train_1800, "lrs3_instep": train_instep}.get(path, train_full_width)
        got, summary[path], window = run(torch, np, path, args.profile)
        launches = {k: launches[k] + got[k] for k in launches}
        per_step[path] = summary[path]["launches_per_step"]
        if window:
            windows.append(window)
    lap("train")
    summary["decode"], decode_window = decode_full_width(torch, np, card, args.profile)
    summary["decode"]["reference"] = decode_ref
    per_step["decode"] = {k: 0 for k in counters()}
    lap("decode")
    torch.cuda.empty_cache()      # room for the CLI processes on the card
    summary["cli"] = cli_phase(summary)
    summary["tools"] = summary["cli"].pop("tools")
    lap("cli")
    summary["parallel"] = parallel_phase(torch, np, summary)
    lap("parallel")
    launches = {k: launches[k] + summary["parallel"]["launches"][k] for k in launches}
    per_step.update(summary["parallel"]["per_step"])
    summary["tensor"] = tensor_phase(torch, np, summary)
    lap("tensor")
    launches = {k: launches[k] + summary["tensor"]["launches"][k] for k in launches}
    per_step.update(summary["tensor"]["per_step"])
    summary["seq"] = seq_phase(torch, np, summary)
    lap("seq")
    launches = {k: launches[k] + summary["seq"]["launches"][k] for k in launches}
    per_step.update(summary["seq"]["per_step"])
    # the kernels' windows first: after the steps' windows, torch.profiler
    # traced no kernel of theirs (run on an H100, PyTorch 2.11)
    for job in later + windows + [decode_window]:
        job()
    lap("profiler windows")
    summary["phase_seconds"] = seconds
    log(f"phase seconds: {seconds}")
    log(f"K4 at the Conformer's BatchNorm shape: {retime_k4():.5f} ms a call after the "
        f"profiler windows, {entries[-1]['paths']['lrs3']['shapes'][-1]['ms']:.5f} before them")
    for e in entries:
        # launches over every path's timed steps, and per step of each path
        e["launches"] = launches[e["name"]]
        e["launches_per_step"] = {p: per_step[p][e["name"]] for p in per_step}
        # and a train step of each CLI run (the driver's metrics.jsonl)
        e["cli_launches_per_step"] = {p: c["launches_per_step"][e["name"]]
                                      for p, c in summary["cli"].items()
                                      if "launches_per_step" in c}
    log(f"decode: {json.dumps(summary['decode'])}")
    log(f"cli: {json.dumps(summary['cli'])}")
    log(f"parallel: {json.dumps(summary['parallel'])}")
    log(f"tensor: {json.dumps(summary['tensor'])}")
    log(f"seq: {json.dumps(summary['seq'])}")
    log(f"tools: {json.dumps(summary['tools'])}")
    log(f"summary: {json.dumps(summary)} on {card}")
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
