"""Building blocks (PyTorch, channels-last) and `GenericMLP`.

Counterpart of coda_neurips2023_tpu/models/helpers.py.  Parameters carry the
reference state-dict names and layouts (a Conv1d weight is (O, I, 1), a
Conv2d weight (O, I, 1, 1), a Linear weight (O, I)), so `load_state_dict`
takes reference-format weights as they are; the layers apply them
channels-last, over the last axis of (..., C), with `F.linear`.

BatchNorm runs at eval only, from its running statistics: the port is
inference only so far, and a module left in training mode raises.
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


class BatchNorm(nn.Module):
    """Channels-last BatchNorm at eval: (x - mean) * (scale / sqrt(var + eps)) + bias."""

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
        if self.training:
            raise NotImplementedError("training is not ported yet; call .eval()")
        mul = torch.rsqrt(self.running_var + EPS) * self.weight
        return (x - self.running_mean) * mul + self.bias


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
            if dropout:
                layers.append(nn.Dropout(dropout))
            prev = h
        layers.append(Dense(prev, output_dim, bias=output_use_bias, kernel_dims=1, device=device))
        if output_use_norm and norm:
            layers.append(BatchNorm(output_dim, device=device))
        if output_use_activation:
            layers.append(act())
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., input_dim) -> (..., output_dim)."""
        return self.layers(x)


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
