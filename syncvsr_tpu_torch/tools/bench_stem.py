"""The video stem conv's forward, input gradient and weight gradient (the
port's counterpart of ``syncvsr_tpu/tools/bench_stem.py``).

    python -m syncvsr_tpu_torch.tools.bench_stem [--tiny] [--device cpu]

At ``lrw_video``'s stem (clips [96, 29, 96, 96, 1], kernel [64, 1, 5, 7,
7], stride (1, 2, 2), output [96, 29, 48, 48, 64]) it times, in bf16 and
f32, ``ops/stem.py::stem_conv3d`` (one ``conv3d`` on the channels-last-3d
layout, the port's) beside the plain formulation (``conv3d`` on the
contiguous NCDHW layout): the forward (``fwd_ms``), the gradient of the
clips (``grad_x_ms``) and of the kernel (``grad_w_ms``), each with the
forward's bound (its multiply-adds at the dtype's peak, or its bytes).
``--tiny``: a [2, 8, 16, 16, 1] clip and 8 channels (a smoke of the tool).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from syncvsr_tpu_torch.ops.stem import stem_conv3d
from syncvsr_tpu_torch.utils.benchmark import (
    PEAK_BF16_FLOPS,
    PEAK_F32_FLOPS,
    bound_ms,
    emit,
    time_ms,
    tool_device,
    tool_parser,
)


def plain_stem(x: torch.Tensor, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The same conv as ``stem_conv3d`` on the contiguous NCDHW layout."""
    xc = x.to(dtype).permute(0, 4, 1, 2, 3).contiguous()
    y = F.conv3d(xc, weight.to(dtype), stride=(1, 2, 2), padding=(2, 3, 3))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def time_forms(shape, channels: int, dtype: torch.dtype, device: torch.device,
               iters: int) -> dict:
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(*shape, device=device, generator=gen).to(dtype)
    w = torch.randn(channels, 1, 5, 7, 7, device=device, generator=gen) * 0.1
    b, t, h, wd, _ = shape
    g = torch.randn(b, t, -(-h // 2), -(-wd // 2), channels, device=device,
                    generator=gen).to(dtype)
    flops = 2 * g.numel() * 5 * 7 * 7
    bound, by = bound_ms(flops, PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS,
                         (x.numel() + g.numel()) * x.element_size() + w.numel() * 4)
    out = {"forward_bound_ms": bound, "forward_bound_by": by}
    for name, fn in (("stem_conv3d", stem_conv3d), ("plain_conv3d", plain_stem)):
        xg = x.detach().requires_grad_(True)
        wg = w.detach().requires_grad_(True)
        out[name] = {
            "fwd_ms": time_ms(lambda: fn(x, w, dtype), device, iters),
            "grad_x_ms": time_ms(lambda: torch.autograd.grad(fn(xg, w, dtype), xg, g),
                                 device, iters),
            "grad_w_ms": time_ms(lambda: torch.autograd.grad(fn(x, wg, dtype), wg, g),
                                 device, iters)}
    return out


def main(argv=None) -> dict:
    ap = tool_parser(__doc__.split("\n")[0])
    ap.add_argument("--tiny", action="store_true", help="a toy clip and 8 channels")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    device = tool_device(args)
    shape, channels = ((2, 8, 16, 16, 1), 8) if args.tiny else ((96, 29, 96, 96, 1), 64)
    res = {str(dt).split(".")[1]: time_forms(shape, channels, dt, device, args.iters)
           for dt in (torch.bfloat16, torch.float32)}
    return emit("bench_stem", device, clips=list(shape), channels=channels, **res)


if __name__ == "__main__":
    main()
