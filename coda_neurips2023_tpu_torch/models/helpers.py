"""Building blocks (PyTorch, channels-last) and `GenericMLP`.

Counterpart of coda_neurips2023_tpu/models/helpers.py.  Parameters carry the
reference state-dict names and layouts (a Conv1d weight is (O, I, 1), a
Conv2d weight (O, I, 1, 1), a Linear weight (O, I)), so `load_state_dict`
takes reference-format weights as they are; the layers apply them
channels-last, over the last axis of (..., C), with `F.linear`.

BatchNorm and dropout follow flax in training mode (`train()`):
  * BatchNorm normalizes with the biased batch variance over every axis but
    the channel, computed as flax 0.12 does (use_fast_variance):
    max(E[x^2] - E[x]^2, 0), eps 1e-5; the running statistics move to
    0.9 * old + 0.1 * batch with that same variance (torch.nn.BatchNorm
    would store the unbiased one), under no_grad.  In eval mode it
    normalizes with the running statistics.
  * Dropout keeps an element with probability 1 - rate and scales it by
    1 / (1 - rate), drawing its mask from the explicit `torch.Generator`
    the forward is given (the default generator when None).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

EPS = 1e-5
ACT = {"relu": nn.ReLU}


class Dense(nn.Module):
    """Channels-last linear map holding a reference Linear/Conv weight:
    (out, in) followed by `kernel_dims` unit dimensions."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 kernel_dims: int = 0, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty((out_dim, in_dim) + (1,) * kernel_dims, device=device)
        )
        self.bias = nn.Parameter(torch.empty(out_dim, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return F.linear(x, w, self.bias)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax nn.Dropout: where(keep, x / keep_prob, 0); identity at eval or rate 0."""
    if not training or rate <= 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


class Dropout(nn.Module):
    """`dropout` as a module; forward(x, generator) draws from `generator`."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.rate, self.training, generator)


class BatchNorm(nn.Module):
    """Channels-last BatchNorm: (x - mean) * (scale / sqrt(var + eps)) + bias,
    with batch statistics in training mode and running ones at eval."""

    MOMENTUM = 0.9

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))
        self.register_buffer("running_mean", torch.empty(dim, device=device))
        self.register_buffer("running_var", torch.empty(dim, device=device))
        self.register_buffer(
            "num_batches_tracked", torch.zeros((), dtype=torch.int64, device=device)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            mul = torch.rsqrt(self.running_var + EPS) * self.weight
            return (x - self.running_mean) * mul + self.bias
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1.0 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + EPS) * self.weight
        return (x - mean) * mul + self.bias


class LayerNorm(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, device=device))
        self.bias = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, EPS)


class GenericMLP(nn.Module):
    """Stack of 1x1 convs with optional bn1d / activation / dropout, laid out
    as the reference's `layers` Sequential so the state-dict indices match
    (e.g. a head with bn1d and dropout: conv 0, bn 1, relu 2, dropout 3,
    conv 4, bn 5, relu 6, dropout 7, conv 8)."""

    def __init__(
        self,
        input_dim: int,
        hidden_dims: Sequence[int],
        output_dim: int,
        norm: Optional[str] = None,  # "bn1d" | None
        activation: str = "relu",
        dropout: Optional[float] = None,
        hidden_use_bias: bool = False,
        output_use_bias: bool = True,
        output_use_activation: bool = False,
        output_use_norm: bool = False,
        device=None,
    ):
        super().__init__()
        if norm not in (None, "bn1d"):
            raise ValueError(f"norm {norm!r} is not ported")
        act = ACT[activation]
        layers = []
        prev = input_dim
        for h in hidden_dims:
            layers.append(Dense(prev, h, bias=hidden_use_bias, kernel_dims=1, device=device))
            if norm:
                layers.append(BatchNorm(h, device=device))
            layers.append(act())
            if dropout is not None:  # a rate of 0 keeps the slot: state-dict indices
                layers.append(Dropout(dropout))
            prev = h
        layers.append(Dense(prev, output_dim, bias=output_use_bias, kernel_dims=1, device=device))
        if output_use_norm and norm:
            layers.append(BatchNorm(output_dim, device=device))
        if output_use_activation:
            layers.append(act())
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (..., input_dim) -> (..., output_dim); `generator` feeds dropout."""
        for layer in self.layers:
            x = layer(x, generator) if isinstance(layer, Dropout) else layer(x)
        return x


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from `generator` (on the module's device).

    Matrices ~ N(0, 1/fan_in), biases ~ N(0, 0.02^2), norm scales 1, running
    statistics (0, 1), `gauss_B` ~ N(0, 1) as the JAX package initialises it.
    """
    for name, p in module.named_parameters():
        if p.dim() >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    for name, b in module.named_buffers():
        if name.endswith("running_mean") or name.endswith("num_batches_tracked"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
        elif name.endswith("gauss_B"):
            b.normal_(0.0, 1.0, generator=generator)
    return module
