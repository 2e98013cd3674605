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
    normalizes with the running statistics.  Over several ranks
    (parallel/ddp.py) the batch is the global batch, as under the JAX
    package's sharded jit: the mean and E[x^2] come from a differentiable
    all-reduce of (sum x, sum x^2, count), so the running statistics move
    alike on every rank.
  * Dropout keeps an element with probability 1 - rate and scales it by
    1 / (1 - rate), drawing its mask from the explicit `torch.Generator`
    the forward is given (the default generator when None).

A compute dtype (`dtype`, bf16 for --compute_dtype bf16) follows flax's
`dtype`: `Dense` casts its input and weight at use, rounds the product and
then adds the bias in that dtype, and its parameters stay fp32, so a
checkpoint of an fp32 run evaluates under bf16 unchanged.  BatchNorm runs in
fp32 on the fp32-cast input (JAX helpers.py:48-57, pointnet.py:36-45).
`LayerNorm` with bf16 weights (the bf16 CLIP tower) is flax's LayerNorm
with bf16 params: fp32 statistics E[x^2] - E[x]^2, the scale and shift in
fp32, one rounding at the output.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from coda_neurips2023_tpu_torch.parallel import dist as pdist

EPS = 1e-5
ACT = {"relu": nn.ReLU}


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax's Dense at compute dtype `dtype`: in fp32 one fused product; in
    bf16 the input and weight cast, the product rounded to bf16, then the
    bias added in bf16 (flax's two roundings)."""
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = torch.matmul(x.to(dtype), weight.to(dtype).t())
    return y if bias is None else y + bias.to(dtype)


class Dense(nn.Module):
    """Channels-last linear map holding a reference Linear/Conv weight:
    (out, in) followed by `kernel_dims` unit dimensions.  `weight_init`
    names the flax kernel initializer `reset_parameters` draws it from:
    "lecun_normal" (flax's nn.Dense default) or "xavier_uniform".  `dtype`
    is the compute dtype (`linear`); the parameters stay fp32."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True,
                 kernel_dims: int = 0, device=None, weight_init: str = "lecun_normal",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight_init = weight_init
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty((out_dim, in_dim) + (1,) * kernel_dims, device=device)
        )
        self.bias = nn.Parameter(torch.empty(out_dim, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], self.weight.shape[1])
        return linear(x, w, self.bias, self.dtype)


def rounded(value: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to `dtype`, as JAX rounds a weakly typed
    scalar to the array's dtype before an elementwise op (PyTorch would
    apply it unrounded to a bf16 tensor)."""
    return float(torch.tensor(value, dtype=dtype))


def flax_softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax at x's own (low-precision) dtype: exp(x - max)
    rounded, its sum taken in fp32 and rounded, then the quotient."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.float().sum(-1, keepdim=True).to(x.dtype)


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
        x = x.to(torch.promote_types(x.dtype, torch.float32))  # at least fp32
        if not self.training:
            mul = torch.rsqrt(self.running_var + EPS) * self.weight
            return (x - self.running_mean) * mul + self.bias
        axes = tuple(range(x.dim() - 1))
        if pdist.is_distributed():
            count = x.new_full((1,), x.numel() // x.shape[-1])
            sums = pdist.differentiable_global_sum(torch.cat([x.sum(axes), (x * x).sum(axes), count]))
            mean, mean_sq = (sums[:-1] / sums[-1]).chunk(2)
        else:
            mean, mean_sq = x.mean(axes), (x * x).mean(axes)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
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
        if self.weight.dtype in (torch.float32, torch.float64):
            return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, EPS)
        # flax LayerNorm with low-precision params (normalization._normalize)
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + EPS) * self.weight.float()
        return ((x32 - mean) * mul + self.bias.float()).to(self.weight.dtype)


class GenericMLP(nn.Module):
    """Stack of 1x1 convs with optional bn1d / activation / dropout, laid out
    as the reference's `layers` Sequential so the state-dict indices match
    (e.g. a head with bn1d and dropout: conv 0, bn 1, relu 2, dropout 3,
    conv 4, bn 5, relu 6, dropout 7, conv 8).  With a bf16 `dtype` the
    convs run in bf16 and each BatchNorm in fp32 (its output, and so the
    next conv's input, fp32); the output is in the last layer's dtype."""

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
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if norm not in (None, "bn1d"):
            raise ValueError(f"norm {norm!r} is not ported")
        act = ACT[activation]
        layers = []
        prev = input_dim
        for h in hidden_dims:
            layers.append(Dense(prev, h, bias=hidden_use_bias, kernel_dims=1, device=device,
                                dtype=dtype))
            if norm:
                layers.append(BatchNorm(h, device=device))
            layers.append(act())
            if dropout is not None:  # a rate of 0 keeps the slot: state-dict indices
                layers.append(Dropout(dropout))
            prev = h
        layers.append(Dense(prev, output_dim, bias=output_use_bias, kernel_dims=1, device=device,
                            dtype=dtype))
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


# flax's truncated_normal variance scaling divides the standard deviation by
# the standard deviation of a unit normal cut at +-2
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(p: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """flax `lecun_normal`: a normal of std sqrt(1/fan_in) / 0.8796, cut at
    +-2 of that std."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    return nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def xavier_uniform_(p: torch.Tensor, fan_in: int, fan_out: int,
                    generator: torch.Generator) -> torch.Tensor:
    """flax `xavier_uniform`: U(-b, b), b = sqrt(6 / (fan_in + fan_out))."""
    bound = (6.0 / (fan_in + fan_out)) ** 0.5
    return p.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random detector weights drawn from `generator` (on the module's
    device), each from the initializer of its flax counterpart in the JAX
    package, with flax's fans of the flax kernel:

      * a `Dense` kernel (flax (in, out)): `lecun_normal`, fan_in = in, or
        with weight_init "xavier_uniform" (the transformer's linear1,
        linear2 and out_proj) `xavier_uniform`, fans in and out;
      * an attention's `in_proj_weight` (3C, C_in): flax MHA's query, key
        and value DenseGeneral kernels (C_in, H, D), which flax initialises
        as (C_in, H * D): `xavier_uniform` with fans C_in and C each;
      * biases and norm shifts 0, norm scales 1; BatchNorm statistics
        (0, 1); the fourier embedding's `gauss_B` ~ N(0, 1), gauss_scale 1.

    The JAX package's fused masked-attention layer, which it takes only on a
    TPU at 1024 tokens or more, initialises its unflattened (C_in, H, D)
    kernel instead (fans H * C_in and D * C_in); on any other backend it
    takes flax's MHA, whose fans are the ones above.
    """
    dense_init = {id(m.weight): m.weight_init for m in module.modules() if isinstance(m, Dense)}
    for name, p in module.named_parameters():
        if name.endswith("in_proj_weight"):
            xavier_uniform_(p, p.shape[1], p.shape[0] // 3, generator)
        elif p.dim() >= 2:
            fan_in, fan_out = p[0].numel(), p.shape[0]
            if dense_init.get(id(p)) == "xavier_uniform":
                xavier_uniform_(p, fan_in, fan_out, generator)
            else:
                lecun_normal_(p, fan_in, generator)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    for name, b in module.named_buffers():
        if name.endswith("running_mean") or name.endswith("num_batches_tracked"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
        elif name.endswith("gauss_B"):
            b.normal_(0.0, 1.0, generator=generator)
    return module
