"""CLIP ViT-B/16 (image and text towers) in PyTorch.

Counterpart of coda_neurips2023_tpu/models/clip.py: `quick_gelu`,
`ResidualAttentionBlock`, `Transformer`, `VisionTransformer`,
`TextTransformer` (the plain-token path) and `CLIP` with `encode_image`,
`encode_text` and `logit_scale`.  Parameter names and layouts are OpenAI's
CLIP state dict's (`visual.conv1.weight`, `visual.transformer.resblocks.{i}.
attn.in_proj_weight`, `token_embedding.weight`, `text_projection`, ...), so
an OpenAI checkpoint loads with `load_state_dict(strict=True)`; as in
OpenAI's module, the text tower's parameters sit at the top level of `CLIP`.

The image tower takes (B, H, W, 3) CLIP-normalized images, the JAX layout,
and its attention goes through `ops.vit_attention` (kernel E on a CUDA
tensor).  The text tower's attention is causal and stays plain matmul +
softmax, as the JAX package leaves it to stock flax.  Everything is fp32;
the bf16 tower of the JAX package is not ported yet.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coda_neurips2023_tpu_torch.models.helpers import LayerNorm
from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention

IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MultiheadSelfAttention(nn.Module):
    """Self-attention with torch.nn.MultiheadAttention's parameter layout:
    in_proj_weight (3W, W), in_proj_bias (3W,), out_proj (W -> W)."""

    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width, device=device))
        self.out_proj = nn.Linear(width, width, device=device)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, s, w = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        qkv = qkv.view(b, s, 3, self.heads, w // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = (t.contiguous() for t in qkv)  # (B, H, S, D) each
        if causal:
            scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
            allowed = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~allowed, torch.finfo(scores.dtype).min)
            out = torch.matmul(torch.softmax(scores, dim=-1), v)
        else:
            out = vit_attention(q, k, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, w))


class MLP(nn.Module):
    def __init__(self, width: int, device=None):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width, device=device)
        self.c_proj = nn.Linear(4 * width, width, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(quick_gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(width, device=device)
        self.attn = MultiheadSelfAttention(width, heads, device=device)
        self.ln_2 = LayerNorm(width, device=device)
        self.mlp = MLP(width, device=device)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, device=None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, device=device) for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, causal)
        return x


class VisionTransformer(nn.Module):
    def __init__(self, input_resolution: int = 224, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 512, device=None):
        super().__init__()
        self.patch_size = patch_size
        n_tok = (input_resolution // patch_size) ** 2 + 1
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False, device=device)
        self.class_embedding = nn.Parameter(torch.empty(width, device=device))
        self.positional_embedding = nn.Parameter(torch.empty(n_tok, width, device=device))
        self.ln_pre = LayerNorm(width, device=device)
        self.transformer = Transformer(width, layers, heads, device=device)
        self.ln_post = LayerNorm(width, device=device)
        self.proj = nn.Parameter(torch.empty(width, output_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) preprocessed -> (B, output_dim)."""
        b, hgt, wid, c = x.shape
        p = self.patch_size
        # the stride-p patch convolution as one matmul over (c, ky, kx) patches
        patches = x.reshape(b, hgt // p, p, wid // p, p, c).permute(0, 1, 3, 5, 2, 4)
        patches = patches.reshape(b, (hgt // p) * (wid // p), c * p * p)
        weight = self.conv1.weight
        x = torch.matmul(patches, weight.reshape(weight.shape[0], -1).t())
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return torch.matmul(self.ln_post(x[:, 0, :]), self.proj)


class TextTransformer(nn.Module):
    """The causal text tower; pools at the argmax token id (EOT has the
    highest id in CLIP's BPE).  Its parameters carry OpenAI's top-level
    names, so `CLIP` extends it."""

    def __init__(self, context_length: int = 77, vocab_size: int = 49408, width: int = 512,
                 layers: int = 12, heads: int = 8, output_dim: int = 512, device=None):
        super().__init__()
        self.context_length = context_length
        self.vocab_size = vocab_size
        self.token_embedding = nn.Embedding(vocab_size, width, device=device)
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width, device=device))
        self.transformer = Transformer(width, layers, heads, device=device)
        self.ln_final = LayerNorm(width, device=device)
        self.text_projection = nn.Parameter(torch.empty(width, output_dim, device=device))

    def encode_text(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, context_length) integer -> (B, output_dim)."""
        x = self.token_embedding(tokens) + self.positional_embedding
        x = self.ln_final(self.transformer(x, causal=True))
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return torch.matmul(pooled, self.text_projection)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.encode_text(tokens)


class CLIP(TextTransformer):
    """The two towers and logit_scale; vision heads = vision_width // 64."""

    def __init__(self, embed_dim: int = 512, image_resolution: int = 224,
                 vision_patch_size: int = 16, vision_width: int = 768, vision_layers: int = 12,
                 text_width: int = 512, text_layers: int = 12, text_heads: int = 8,
                 context_length: int = 77, vocab_size: int = 49408, device=None):
        super().__init__(context_length, vocab_size, text_width, text_layers, text_heads,
                         embed_dim, device=device)
        self.visual = VisionTransformer(
            image_resolution, vision_patch_size, vision_width, vision_layers,
            max(vision_width // 64, 1), embed_dim, device=device,
        )
        self.logit_scale = nn.Parameter(torch.empty((), device=device))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        img = self.encode_image(images)
        txt = self.encode_text(tokens)
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        scale = self.logit_scale.exp()
        return scale * img @ txt.t(), scale * txt @ img.t()


@torch.no_grad()
def init_clip_parameters(model: CLIP, generator: torch.Generator) -> CLIP:
    """Random CLIP weights from `generator`: matrices and embeddings
    ~ N(0, 1/fan), biases ~ N(0, 0.02^2), LayerNorm scales 1,
    logit_scale log(1/0.07) as OpenAI initialises it."""
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif name.endswith("weight"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=generator)
    model.logit_scale.fill_(math.log(1 / 0.07))
    return model
