"""PyTorch port: tensor parallel (``mesh.model=2``) over two gloo processes
on the CPU against the port's one-process step, for each model family:
the word transformer over the video ResNet (CutMix, zero-weight rows,
masked sync slots), the DC-TCN and a multibranch TCN with depthwise convs
(mixup, lambda injected), and the Conformer + decoder (also under
``model.remat``, whose recompute gathers again); and a sync head of 3
slots, which does not split over two ranks (its weight is gathered). The rule runs at
``min_dim`` 16, as ``tests/test_spmd.py`` runs JAX's, so it splits a leaf
of every layer kind (the test asserts which): Dense and FFN columns, head
projections, attention outputs, pointwise and depthwise convs, the ResNet
convs and the stem, the embeddings, the position biases, the TCN convs
and SE layers, and the sync head (on each rank's 4 of 8 slots).

The tolerances are ``tests/test_spmd.py``'s (metrics rtol 1e-5; params,
statistics and moments rtol 1e-4, atol 1e-6; atol 1e-5 for the sentence
model), and the two ranks' gathered states are bitwise alike. A conv bias
that a train-mode BatchNorm follows has a true gradient of 0: both steps
hold f32 noise there, which Adam turns into an update of either sign up to
the rate, so those leaves are held to the summed rates
(``test_torch_dctcn.py::_zero_gradient``)."""

import jax
import numpy as np
import pytest
import torch

from syncvsr_tpu_torch import config as tcfg
from syncvsr_tpu_torch.data.synthetic import word_batch
from syncvsr_tpu_torch.models import build_model
from syncvsr_tpu_torch.parallel import Mesh, state_shardings
from syncvsr_tpu_torch.utils.bridge import to_flax
from syncvsr_tpu_torch.ops.image import sample_train_aug
from test_torch_dctcn import _zero_gradient, dctcn_configs
from test_torch_parallel import (
    RATIO,
    SENTENCE_METRICS,
    START,
    WORD_METRICS,
    _leaves,
    assert_ranks_equal,
)
from test_torch_parallel_sentence import DCTCN_METRICS, LAM, dctcn_batch
from test_torch_sentence_step import FRAMES, _uint8_batch
from test_torch_tensor_parallel import _Shapes
from torch_multiproc import spawn, train_steps
from torch_parity import TINY, close, configs, sentence_configs, uint8_batch
import torch_threads  # noqa: F401  (one torch thread a test process)

STEPS = 2
# seconds for the file's two-process group: 3x the most measured (30.5 s), at least 60
SPAWN_TIMEOUT = 90
MIN_DIM = 16

MSTCN = dict(TINY, **{"data.batch_size": 4, "model.encoder.kind": "mstcn",
                      "model.encoder.tcn_channels": (24, 24),
                      "model.encoder.tcn_kernel_sizes": (3, 5),
                      "model.encoder.tcn_dwpw": True})

# a leaf of each layer kind the family splits at MIN_DIM (flax-free torch names)
SPLIT = {
    "word": ("frontend.stem_conv_kernel", "frontend.resnet.layer4_1.conv2.weight",
             "frontend.resnet.layer2_0.downsample_conv.weight",
             "encoder.block_0.attn.wq.weight", "encoder.block_0.attn.wq.bias",
             "encoder.block_1.ff.wi_gate.weight", "audio_classifier.weight"),
    "sentence": ("encoder.embed.weight", "encoder.block_0.ff_macaron.w1.weight",
                 "encoder.block_0.attn.wo.weight", "encoder.block_0.attn.pos_bias_u",
                 "encoder.block_0.attn.linear_pos.weight", "encoder.block_1.conv.pw1.weight",
                 "encoder.block_1.conv.dw.weight", "encoder.block_1.conv.pw2.weight",
                 "decoder.embed.embedding", "decoder.block_0.ff.w1.weight",
                 "decoder.block_0.src_attn.wo.weight", "proj_decoder.weight",
                 "audio_classifier.weight"),
    "dctcn": ("encoder.transition0.conv.weight", "encoder.transition1.conv.weight",
              "encoder.block0_layer1.se_0.Dense_1.weight",
              "encoder.block0_layer0.conv0_2.conv.weight",
              "encoder.block1_layer0.conv1_0.conv.weight", "audio_classifier.weight"),
    "odd": ("audio_classifier.weight",),
    "mstcn": ("encoder.block_0.branch1_1.dw.weight", "encoder.block_1.branch0_0.dw.weight",
              "encoder.block_0.downsample.weight", "audio_classifier.weight"),
}


def _drawn(cfg, batch, sentence=False):
    """The augmentation's draws for the whole batch, from the port's sampler
    (the word recipe, or ``build_sentence_aug``'s with the clips' lengths):
    both sides of a comparison apply the same values."""
    key = "videos" if sentence else "inputs"
    b, t, h, w, _ = batch[key].shape
    d, gen = cfg.data, torch.Generator().manual_seed(7)
    if sentence:
        drawn = sample_train_aug(gen, b, t, h, w, (0.7, 1.0), hflip_prob=0.5,
                                 time_mask_span=10, time_mask_n=2,
                                 lengths=torch.as_tensor(batch["lengths"]))
    else:
        drawn = sample_train_aug(gen, b, t, h, w, tuple(d.rrc_scale),
                                 hflip_prob=d.hflip_prob, time_mask_span=d.time_mask_window,
                                 time_mask_n=d.time_mask_stride)
    return {k: v.numpy() for k, v in drawn.items()}


def word_case():
    """``test_torch_parallel.word_case``'s tiny lrw_video batch (CutMix on,
    row 0 of weight 0, masked sync slots in row 1) and its draws."""
    _, cfg = configs(**{"data.batch_size": 4, "data.use_cutmix": True})
    batch = uint8_batch(cfg)
    batch["sample_weight"] = np.array([0.0, 1.0, 1.0, 1.0], np.float32)
    batch["audio_tokens"][1, :5] = -1
    return cfg, batch, _drawn(cfg, batch)


def _cases():
    """(config, job, metrics) of each family; the initial weights are the
    port's seeded init."""
    cases = {}
    cfg, batch, drawn = word_case()
    cases["word"] = (cfg, {"batch": batch, "aug": drawn, "cutmix": (RATIO, START)},
                     WORD_METRICS)
    _, cfg = dctcn_configs()
    cfg = cfg.override(**{"model.encoder.tcn_growth_rates": (48, 48)})  # 16-wide branches
    cases["dctcn"] = (cfg, {"batch": dctcn_batch(cfg), "lam": LAM, "no_dropout": True},
                      DCTCN_METRICS)
    cfg = tcfg.lrw_video_config().override(**MSTCN)
    cases["mstcn"] = (cfg, {"batch": dctcn_batch(cfg), "lam": LAM, "no_dropout": True},
                      DCTCN_METRICS)
    # test_torch_fsdp's sentence case: a clip with one label, ragged lengths
    _, cfg = sentence_configs(**{"optim.lr": 1e-4, "data.batch_size": 4})
    batch = _uint8_batch(cfg)
    batch["labels"][0, 1:] = -1
    batch["lengths"] = np.array([FRAMES, 7, FRAMES, FRAMES - 1], np.int32)
    cases["sentence"] = (cfg, {"batch": batch, "aug": _drawn(cfg, batch, sentence=True),
                               "aug_dtype": "float32"}, SENTENCE_METRICS)
    # 3 slots of 14 tokens: the head's 42 columns split in two, its slots do
    # not, so the weight is gathered and the loss runs whole
    odd = tcfg.lrw_video_config().override(**dict(TINY, **{
        "data.batch_size": 4, "model.codec.audio_alignment": 3, "model.codec.vq_groups": 1,
        "model.codec.audio_vocab_size": 14}))
    cases["odd_slots"] = (odd, {"batch": word_batch(odd)}, WORD_METRICS)
    # model.remat: the gathers and the gradients' sums run again in the recompute
    cases["sentence_remat"] = (cfg.override(**{"model.remat": True}),
                               dict(cases["sentence"][1]), SENTENCE_METRICS)
    out = {}
    for name, (cfg, extra, metrics) in cases.items():
        params, stats = to_flax(build_model(cfg, device="cpu").state_dict())
        job = dict({"kind": "train", "config": cfg.to_dict(), "params": params,
                    "batch_stats": stats, "steps": STEPS}, **extra)
        out[name] = (cfg, job, metrics)
    return out


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every family's one-process steps, and the same jobs in one group of
    two processes on a (data=1, model=2) mesh."""
    cases = _cases()
    names = sorted(cases)
    jobs = [dict(cases[n][1], model=2, min_dim=MIN_DIM) for n in names]
    two = spawn(jobs, 2, tmp_path_factory.mktemp("tp"), timeout=SPAWN_TIMEOUT)
    return {n: (cases[n], train_steps(cases[n][1]), t) for n, t in zip(names, two)}


def assert_tp_close(got, want, metrics, atol, lr_sum):
    """``tests/test_spmd.py``'s tolerances (``atol`` for the leaves); a
    zero-gradient conv bias within the summed rates."""
    for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
        for k in metrics:
            close(g[k], w[k], 1e-5, 1e-7, f"step {i + 1} {k}")
    for key in ("params", "batch_stats", "mu", "nu"):
        leaves = _leaves(want[key])
        assert len(leaves) == len(jax.tree_util.tree_leaves(got[key]))
        for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got[key])):
            if _zero_gradient(path) and key != "batch_stats":
                if key == "params":
                    close(g, w, 0.0, 2 * lr_sum, key + jax.tree_util.keystr(path))
                continue
            close(g, w, 1e-4, atol, key + jax.tree_util.keystr(path))


@pytest.mark.parametrize("family", ["word", "odd_slots", "dctcn", "mstcn", "sentence",
                                    "sentence_remat"])
def test_tensor_parallel_step_matches_one_process(tp_runs, family):
    (cfg, job, metrics), one, two = tp_runs[family]
    specs = state_shardings(Mesh(size=2, rank=0, device=torch.device("cpu"), model=2),
                            _Shapes(build_model(cfg, device="cpu")), min_dim=MIN_DIM)
    for name in SPLIT[family.split("_")[0]]:
        assert "model" in specs[name], name
    assert_ranks_equal(two)
    lr_sum = sum(m["learning_rate"] for m in one["metrics"])
    assert_tp_close(two[0], one, metrics, 1e-5 if family.startswith("sentence") else 1e-6,
                    lr_sum)
    # each rank held half of every split leaf, and Adam's moments with it
    split = sum(int(np.prod(p.shape)) * 4 for n, p in build_model(cfg, device="cpu")
                .named_parameters() if "model" in specs[n])
    full = sum(p.numel() * 4 for p in build_model(cfg, device="cpu").parameters())
    for r in range(2):
        assert two[r]["resident"] == {"params": full - split // 2,
                                      "moments": 2 * (full - split // 2)}
