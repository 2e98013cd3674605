"""Seeded weights for the detector and CLIP, made on the device.

The benchmark makes every weight itself, so that the program and the
reference start from the same numbers and neither takes weights the other
made.  Each model's state dict is filled from one draw of a generator on the
model's device, seeded from the run's seed and a stream number: the entries
in sorted name order take consecutive slices of one standard normal vector,
scaled by their kind (below).  A state dict with the same names and shapes
gets the same tensors whatever module holds it.

  * floating tensors of two or more dims: N(0, 1/fan_in), fan_in the product
    of every dim but the first (PyTorch's (out, in, ...) layout);
  * `*bias` vectors: N(0, 0.02) (not zero, so that every bias takes a
    gradient the check can compare);
  * other vectors whose name says norm (`ln`, `norm`, `bn`) or ending in
    `.weight`: 1 + N(0, 0.02);
  * other vectors (CLIP's class embedding): N(0, 0.02);
  * BatchNorm's running mean 0, running variance 1, counters 0;
  * a 0-d `logit_scale`: log 100, as the program's random CLIP holds it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

DETECTOR, CLIP = 1, 2  # stream numbers


def generator(seed: int, stream: int, device) -> torch.Generator:
    state = np.random.SeedSequence([int(seed), int(stream)]).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(int(state[0]) << 32 | int(state[1]))


def _kind(name: str, t: torch.Tensor) -> str:
    if not t.is_floating_point():
        return "zero"
    if name.endswith("running_mean"):
        return "zero"
    if name.endswith("running_var"):
        return "one"
    if t.dim() == 0:
        return "logit_scale" if name.endswith("logit_scale") else "small"
    if t.dim() >= 2:
        return "fan_in"
    if name.endswith("bias"):
        return "small"
    leaf = name.rsplit(".", 2)
    if name.endswith(".weight") or any(k in "".join(leaf) for k in ("ln", "norm", "bn")):
        return "norm"
    return "small"


def make_state(shapes: dict, seed: int, stream: int, device) -> dict:
    """{name: tensor} for `shapes` ({name: (shape, dtype)}), drawn as the
    module docstring says, on `device`."""
    names = sorted(shapes)
    floats = [n for n in names if shapes[n][1].is_floating_point]
    total = sum(math.prod(shapes[n][0]) for n in floats)
    draw = torch.randn(total, generator=generator(seed, stream, device), device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for n in names:
        shape, dtype = shapes[n]
        if not dtype.is_floating_point:
            out[n] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        size = math.prod(shape)
        x = draw[at:at + size].reshape(shape)
        at += size
        kind = _kind(n, torch.empty(shape, dtype=dtype, device="meta"))
        if kind == "zero":
            x = torch.zeros_like(x)
        elif kind == "one":
            x = torch.ones_like(x)
        elif kind == "logit_scale":
            x = torch.full_like(x, math.log(100.0))
        elif kind == "fan_in":
            x = x / math.sqrt(math.prod(shape[1:]))
        elif kind == "norm":
            x = 1.0 + 0.02 * x
        else:
            x = 0.02 * x
        out[n] = x.to(dtype)
    return out


def shapes_of(module: torch.nn.Module) -> dict:
    return {n: (tuple(t.shape), t.dtype) for n, t in module.state_dict().items()}


@torch.no_grad()
def load_seeded(module: torch.nn.Module, seed: int, stream: int) -> None:
    """Fill every entry of `module`'s state dict from the seed, in place."""
    sd = module.state_dict()
    device = next(iter(sd.values())).device
    state = make_state(shapes_of(module), seed, stream, device)
    for n, t in sd.items():
        t.copy_(state[n])
