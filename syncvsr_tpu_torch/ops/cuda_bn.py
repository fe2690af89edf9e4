"""Train-mode BatchNorm over channels-last activations, with CUDA statistics.

Port of ``syncvsr_tpu/ops/pallas_bn.py`` (default math only):

* statistics are per-channel f32 (sum x, sum x^2) over the free ``[N, C]``
  view of a contiguous channels-last tensor, from kernel K3
  (``csrc/bn_stats.cu::bn_stats_fwd``, replacing ``_stats_kernel``; one
  launch);
* variance in the E[x^2] - E[x]^2 form, clamped at 0, biased; eps 1e-5;
  ``y = x * a + b`` in the compute dtype with ``a = inv * scale`` and
  ``b = bias - mean * inv * scale``;
* the analytic backward ``dx = k * gy - (c1 + (x - mean) * c2)`` over
  (sum g, sum g * xhat) from kernel K4 (``bn_stats_bwd``, replacing
  ``_bwd_kernel``; one launch); the dx elementwise pass stays in
  PyTorch, as it stays in XLA in the JAX package;
* running stats ``ra = 0.9 * ra + 0.1 * batch`` with the biased variance
  (flax's convention; ``nn.BatchNorm``'s momentum and unbiased running
  variance differ, so it is not used); eval mode is the plain affine.

Each statistics wrapper runs its kernel on a CUDA tensor and its plain
PyTorch version on a CPU tensor; there is no other fallback. Both kernels
keep their partials in a per-device scratch and take per-device ticket
counters, so each runs on one stream at a time; their results are slices of
a per-device arena.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import nn

from syncvsr_tpu_torch.utils import kernels

Tensor = torch.Tensor

_SMS = 132           # H100 SXM streaming multiprocessors
# strips of K3 and K4: at most `max_strips` blocks, >= `strip_elems`
# elements a strip where the shape has them, and a block on every SM where
# the rows give each one a row group
_FWD_MAX_STRIPS = 2 * _SMS
_FWD_STRIP_ELEMS = 131072
_BWD_MAX_STRIPS = 2 * _SMS       # one wave at K4's register use
_BWD_STRIP_ELEMS = 65536
_GROUP = 16           # strips a group of the kernels' first fold holds


def _scratch_floats(strips: int, c: int) -> int:
    """The partials of ``strips`` strips and of their groups' sums."""
    return (strips + -(-strips // _GROUP)) * 2 * c


_SCRATCH_FLOATS = _scratch_floats(max(_FWD_MAX_STRIPS, _BWD_MAX_STRIPS), 256 * 8)


def _geometry(n: int, c: int, elem_size: int, max_strips: int, strip_elems: int) -> dict:
    tpr = c // (16 // elem_size)
    rpi = max(1, 256 // tpr)
    want = min(max_strips, max(-(-n * c // strip_elems), min(_SMS, -(-n // rpi))))
    rows = max(1, n // max(want, 1))      # floor: at least ``want`` strips
    strips = max(1, min(max_strips, -(-n // rows)))
    return {"threads": rpi * tpr, "rows_per_iter": rpi, "strips": strips,
            "rows": -(-n // strips), "scratch_floats": _scratch_floats(strips, c)}


@functools.lru_cache(maxsize=None)
def fwd_geometry(n: int, c: int, elem_size: int) -> dict:
    """K3's launch, as ``csrc/bn_stats.cu::bn_stats_fwd`` makes it from the
    strips chosen here: ``threads`` = whole row groups of C / VEC threads
    (``rows_per_iter`` of them, at most 256 threads), ``strips`` blocks of
    ``rows`` rows each (the last one ragged), and the scratch its partials
    take. The strips fill the 132 SMs where the rows allow, and are capped
    at 2 blocks a SM with >= 128K elements each at the large shapes."""
    return _geometry(n, c, elem_size, _FWD_MAX_STRIPS, _FWD_STRIP_ELEMS)


@functools.lru_cache(maxsize=None)
def bwd_geometry(n: int, c: int, elem_size: int) -> dict:
    """K4's launch (``bn_stats_bwd``), as ``fwd_geometry`` says for K3, at
    most 2 blocks a SM with >= 64K elements each at the large shapes."""
    return _geometry(n, c, elem_size, _BWD_MAX_STRIPS, _BWD_STRIP_ELEMS)


def _launch(geometry, n: int, c: int, dtype: torch.dtype) -> Optional[Tuple[int, int, int]]:
    """(strips, scratch floats, is_bf16) of a kernel at [n, c] in ``dtype``,
    or None where the kernels do not take that dtype or C (``_check_2d``
    says why)."""
    if dtype not in (torch.bfloat16, torch.float32):
        return None
    size = 2 if dtype == torch.bfloat16 else 4
    if c % (16 // size) or c // (16 // size) > 256:
        return None
    geo = geometry(n, c, size)
    return geo["strips"], geo["scratch_floats"], int(size == 2)


# the small shapes cost the host more than the device, so what depends only
# on the shape is worked out once
@functools.lru_cache(maxsize=None)
def _fwd_launch(n: int, c: int, dtype: torch.dtype) -> Optional[Tuple[int, int, int]]:
    return _launch(fwd_geometry, n, c, dtype)


@functools.lru_cache(maxsize=None)
def _bwd_launch(n: int, c: int, dtype: torch.dtype) -> Optional[Tuple[int, int, int]]:
    return _launch(bwd_geometry, n, c, dtype)


def _stats_out(device: int, c: int) -> Tuple[int, Tensor, Tensor]:
    """A kernel's result: (address, first sum, second sum), two f32 [c]
    slices of the per-device arena (``kernels.result``)."""
    out, buf = kernels.result(device, 2 * c)
    return out, buf[:c], buf[c:]


def _partials(device: int, floats: int) -> int:
    """The address of the kernels' partials, one buffer a device shared by
    K3 and K4 (both run on the train step's stream, one after the other)."""
    return kernels.scratch("bn_partials", device, max(floats, _SCRATCH_FLOATS))[1]


def _check_2d(name: str, *ts: Tensor) -> None:
    """The kernels' contract: matching contiguous, 16-byte aligned [N, C]
    views of one dtype, bf16 or f32, each thread loading 16 bytes (VEC
    channels), one row group at most the 256 threads of a block."""
    if ts[0].dim() != 2:
        raise ValueError(f"{name}: expected an [N, C] view, got {tuple(ts[0].shape)}")
    n, c = ts[0].shape
    dtype = ts[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: bf16 or f32 inputs, got {dtype}")
    vec = 16 // ts[0].element_size()
    if c % vec or c // vec > 256:
        raise ValueError(f"{name}: C={c} must be a multiple of {vec} and at most "
                         f"{256 * vec}")
    for t in ts:
        if t.shape != ts[0].shape or t.dtype != dtype:
            raise ValueError(f"{name}: inputs disagree: {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the [N, C] view must be contiguous "
                             "(channels-last activation)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: input is not 16-byte aligned")


def bn_stats_plain(x2d: Tensor) -> Tuple[Tensor, Tensor]:
    """[N, C] -> per-channel f32 (sum x, sum x^2)."""
    x32 = x2d.float()
    return x32.sum(0), (x32 * x32).sum(0)


def bn_stats(x2d: Tensor, strips: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """K3: per-channel f32 (sum x, sum x^2) of a contiguous [N, C] tensor,
    one launch. ``strips`` overrides ``fwd_geometry``'s choice (a test of
    the kernel's fold at other grid sizes). Its small shapes cost the host
    more than the device, so the checks that pass are kept cheap."""
    if not x2d.is_cuda:
        return bn_stats_plain(x2d)
    if x2d.dim() != 2:
        _check_2d("bn_stats", x2d)
    n, c = x2d.shape
    xp = x2d.data_ptr()
    launch = _fwd_launch(n, c, x2d.dtype)
    if not (launch and x2d.is_contiguous() and xp % 16 == 0):
        _check_2d("bn_stats", x2d)   # raises with the reason
    if strips is None:
        strips, floats, is_bf16 = launch
    else:
        floats, is_bf16 = _scratch_floats(strips, c), launch[2]
    device = x2d.get_device()
    out, s1, s2 = _stats_out(device, c)
    status = kernels.library().bn_stats_fwd(
        xp, _partials(device, floats), out, n, c, strips, is_bf16,
        kernels.current_stream(device))
    if status:
        kernels.check(status, "bn_stats_fwd")
    bn_stats.launches += 1
    return s1, s2


bn_stats.launches = 0


def bn_bwd_stats_plain(g2d: Tensor, x2d: Tensor, mean: Tensor, inv: Tensor
                       ) -> Tuple[Tensor, Tensor]:
    """Per-channel f32 (sum g, sum g * xhat), xhat = (x - mean) * inv."""
    g32 = g2d.float()
    xhat = (x2d.float() - mean) * inv
    return g32.sum(0), (g32 * xhat).sum(0)


def bn_bwd_stats(g2d: Tensor, x2d: Tensor, mean: Tensor, inv: Tensor,
                 strips: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """K4: per-channel f32 (sum g, sum g * xhat) in one pass over g and x,
    one launch. ``strips`` overrides ``bwd_geometry``'s choice (a test of
    the kernel's fold at other grid sizes). Its small shapes cost the host
    more than the device, so the checks that pass are kept cheap."""
    if not g2d.is_cuda:
        return bn_bwd_stats_plain(g2d, x2d, mean, inv)
    if g2d.dim() != 2:
        _check_2d("bn_bwd_stats", g2d, x2d)
    n, c = g2d.shape
    gp, xp = g2d.data_ptr(), x2d.data_ptr()
    launch = _bwd_launch(n, c, g2d.dtype)
    if not (launch and x2d.shape == g2d.shape and x2d.dtype == g2d.dtype
            and g2d.is_contiguous() and x2d.is_contiguous() and (gp | xp) % 16 == 0):
        _check_2d("bn_bwd_stats", g2d, x2d)   # raises with the reason
    if not (mean.shape == inv.shape == (c,) and mean.is_cuda and inv.is_cuda):
        raise ValueError(f"bn_bwd_stats: mean and inv must be [{c}] tensors on the GPU")
    if not (mean.dtype == inv.dtype == torch.float32 and mean.is_contiguous()
            and inv.is_contiguous()):
        mean = mean.float().contiguous()
        inv = inv.float().contiguous()
    if strips is None:
        strips, floats, is_bf16 = launch
    else:
        floats, is_bf16 = _scratch_floats(strips, c), launch[2]
    device = g2d.get_device()
    partials = _partials(device, floats)
    out, s1, s2 = _stats_out(device, c)
    status = kernels.library().bn_stats_bwd(
        gp, xp, mean.data_ptr(), inv.data_ptr(), partials, out, n, c, strips, is_bf16,
        kernels.current_stream(device))
    if status:
        kernels.check(status, "bn_stats_bwd")
    bn_bwd_stats.launches += 1
    return s1, s2


bn_bwd_stats.launches = 0


class _BatchNormTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps, dtype):
        c = x.shape[-1]
        x2d = x.view(-1, c)
        m = x2d.shape[0]
        s, s2 = bn_stats(x2d)
        mean = s / m
        var = torch.clamp(s2 / m - mean * mean, min=0.0)
        inv = torch.rsqrt(var + eps)
        a = (inv * scale).to(dtype)
        b = (bias - mean * inv * scale).to(dtype)
        y = x.to(dtype) * a + b
        ctx.save_for_backward(x, scale, mean, inv)
        ctx.dtype = dtype
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        # cotangents of the batch statistics (running stats) are not propagated
        x, scale, mean, inv = ctx.saved_tensors
        dtype = ctx.dtype
        c = x.shape[-1]
        gy = gy.contiguous()
        n = x.numel() // c
        s1, s2 = bn_bwd_stats(gy.view(n, c), x.view(n, c), mean, inv)
        k = (inv * scale).to(dtype)
        c1 = (inv * scale * s1 / n).to(dtype)
        c2 = (inv * inv * scale * s2 / n).to(dtype)
        xc = x.to(dtype) - mean.to(dtype)
        dx = gy.to(dtype) * k - (c1 + xc * c2)
        return dx, s2, s1, None, None


def batch_norm_train(x: Tensor, scale: Tensor, bias: Tensor, eps: float,
                     dtype: torch.dtype) -> Tuple[Tensor, Tensor, Tensor]:
    """Train-mode BN over all but the last axis of a contiguous tensor.
    Returns (y, mean, var); mean and var carry no gradient."""
    return _BatchNormTrain.apply(x, scale, bias, eps, dtype)


class FastBatchNorm(nn.Module):
    """BatchNorm with flax ``nn.BatchNorm`` semantics over the last axis;
    ``weight``/``bias`` and ``running_mean``/``running_var`` map to flax's
    ``scale``/``bias`` and ``batch_stats`` ``mean``/``var``."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32,
                 momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.dtype = dtype
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: Tensor, train: bool) -> Tensor:
        if not train:
            inv = torch.rsqrt(self.running_var + self.eps)
            a = (inv * self.weight).to(self.dtype)
            b = (self.bias - self.running_mean * inv * self.weight).to(self.dtype)
            return x.to(self.dtype) * a + b
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps, self.dtype)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        return y
