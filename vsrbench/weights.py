"""The benchmark's weights, made on the device from the seed and handed to
both the program and the reference.

The leaves are the plain reference's (names and shapes of its model, built
on the meta device). One ``normal_`` call fills a flat f32 buffer at std
0.02 (the port's default Dense init); biases are then zeroed and the
one-dimensional weights (norm and BatchNorm scales) set to 1, in two
``_foreach`` calls. BatchNorm running statistics start at mean 0, var 1.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

STD = 0.02


def leaves(model: nn.Module) -> List[Tuple[str, torch.Size]]:
    return [(n, p.shape) for n, p in model.named_parameters()]


def make(spec: List[Tuple[str, torch.Size]], seed: int, device: torch.device
         ) -> Dict[str, torch.Tensor]:
    """name -> f32 tensor on ``device``, views of one buffer."""
    sizes = [s.numel() for _, s in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(0.0, STD, generator=gen)
    views = [v.view(s) for v, (_, s) in zip(flat.split(sizes), spec)]
    out = dict(zip((n for n, _ in spec), views))
    zeros = [v for (n, _), v in zip(spec, views) if n.endswith("bias")]
    ones = [v for (n, s), v in zip(spec, views) if not n.endswith("bias") and len(s) == 1]
    if zeros:
        torch._foreach_zero_(zeros)
    if ones:
        torch._foreach_zero_(ones)
        torch._foreach_add_(ones, 1.0)
    return out


def load(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters, which must have the
    same names and shapes; reset its BatchNorm running statistics."""
    params = dict(model.named_parameters())
    mine = {n: tuple(p.shape) for n, p in params.items()}
    given = {n: tuple(w.shape) for n, w in weights.items()}
    if mine != given:
        diff = sorted(set(mine.items()) ^ set(given.items()))[:8]
        raise ValueError(f"the model's leaves differ from the benchmark's weights: {diff}")
    with torch.no_grad():
        names = list(weights)
        torch._foreach_copy_([params[n] for n in names], [weights[n] for n in names])
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.zero_()
            elif name.endswith("running_var"):
                buf.fill_(1.0)
