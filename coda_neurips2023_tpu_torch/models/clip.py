"""CLIP ViT-B/16 (image and text towers) in PyTorch.

Counterpart of coda_neurips2023_tpu/models/clip.py: `quick_gelu`,
`ResidualAttentionBlock`, `Transformer`, `VisionTransformer`,
`TextTransformer` (with its learned-prompt path, `_insert_prompt_embeddings`),
`CLIP` with `encode_image`, `encode_text`,
`encode_text_with_prompt_embedding` and `logit_scale`, and
`preprocess_images`.  Parameter names and layouts are OpenAI's CLIP state
dict's (`visual.conv1.weight`, `visual.transformer.resblocks.{i}.
attn.in_proj_weight`, `token_embedding.weight`, `text_projection`, ...), so
an OpenAI checkpoint loads with `load_state_dict(strict=True)`; as in
OpenAI's module, the text tower's parameters sit at the top level of `CLIP`.

The image tower takes (B, H, W, 3) CLIP-normalized images, the JAX layout,
and its attention goes through `ops.vit_attention` (kernel E, or E-bf16, on
a CUDA tensor).  In fp32 its blocks' four linear layers go through
`ops.tower_gemm.tower_linear` (kernel H on a CUDA tensor), with the bias,
QuickGELU and the residual adds in the product's epilogue and qkv written
in kernel E's layout; `quick_gelu` is defined there, beside that plain
epilogue.  The text tower's attention is causal and stays plain
matmul + softmax, as the JAX package leaves it to stock flax, and its
linear layers stay `helpers.linear`.

The towers compute in their weights' dtype (`CLIP.dtype`): fp32, or bf16
once the module is cast (`.to(torch.bfloat16)`), as StageContext casts the
frozen tower for --clip_dtype bf16 and --compute_dtype bf16 (JAX
stages.py:86-97), which is the JAX CLIP(dtype=bfloat16) with its variables
cast.  In bf16, as flax runs it: the input is cast at entry; the patch
matmul, the positional-embedding add, the projections, `c_fc`,
`quick_gelu` and `c_proj` run in bf16, each Dense rounding its product
before the bias; the image tower's attention is kernel E-bf16's numerics
(the JAX Pallas kernel's: fp32 scores, p rounded to bf16); the text tower's
causal attention is flax's stock bf16 attention (bf16 scores, masked with
finfo(bf16).min, a bf16 softmax); LayerNorms are flax's with bf16 params
(fp32 statistics, one rounding); both towers return fp32 features.

On a tensor-parallel grid (parallel/tp.py) each block's attention runs its
local heads (kernel E at heads / mp) and its MLP its local hidden units;
under the teacher's no_grad that is one all-reduce after out_proj and one
after c_proj.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from coda_neurips2023_tpu_torch.models.helpers import LayerNorm, flax_softmax, linear, rounded
from coda_neurips2023_tpu_torch.ops.tower_gemm import quick_gelu, tower_linear
from coda_neurips2023_tpu_torch.ops.vit_attention import vit_attention
from coda_neurips2023_tpu_torch.parallel import tp

IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


class MultiheadSelfAttention(nn.Module):
    """Self-attention with torch.nn.MultiheadAttention's parameter layout:
    in_proj_weight (3W, W), in_proj_bias (3W,), out_proj (W -> W).  On a
    tensor-parallel grid (`grid`, parallel/tp.py) it runs its heads / mp
    local heads at the global head width W / heads, out_proj row-parallel.
    `forward` returns the attention of x added to `residual` (the block's
    stream).  With `tower_gemm` (the image tower's blocks), in fp32 and off
    a grid, both projections are kernel H (`ops.tower_gemm.tower_linear`):
    qkv written straight into q, k and v's (B, H, S, D), the residual added
    in out_proj's epilogue."""

    def __init__(self, width: int, heads: int, device=None, tower_gemm: bool = False):
        super().__init__()
        self.heads = heads
        self.grid = None
        self.tower_gemm = tower_gemm
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width, device=device))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * width, device=device))
        self.out_proj = nn.Linear(width, width, device=device)

    def forward(self, x: torch.Tensor, residual: torch.Tensor,
                causal: bool = False) -> torch.Tensor:
        b, s, w = x.shape
        d = w // self.heads
        h = self.heads // (self.grid.mp if self.grid is not None else 1)
        dt = self.in_proj_weight.dtype
        fused = self.tower_gemm and self.grid is None and dt == torch.float32
        if fused:
            q, k, v = tower_linear(x, self.in_proj_weight, self.in_proj_bias, "qkv", heads=h)
        else:
            (x,) = tp.copy_to_mp(x, grid=self.grid)
            qkv = linear(x, self.in_proj_weight, self.in_proj_bias, dt)
            qkv = qkv.view(b, s, 3, h, d).permute(2, 0, 3, 1, 4)
            q, k, v = (t.contiguous() for t in qkv)  # (B, H, S, D) each
        if causal:
            allowed = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
            if dt == torch.float32:
                scores = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
                scores = scores.masked_fill(~allowed, torch.finfo(scores.dtype).min)
                out = torch.matmul(torch.softmax(scores, dim=-1), v)
            else:  # flax's stock attention in bf16: q scaled first, bf16 scores
                scores = torch.matmul(q / rounded(math.sqrt(q.shape[-1]), dt), k.transpose(-1, -2))
                scores = scores.masked_fill(~allowed, torch.finfo(dt).min)
                out = torch.matmul(flax_softmax(scores), v)
        else:
            out = vit_attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, s, h * d)
        if fused:
            return tower_linear(out, self.out_proj.weight, self.out_proj.bias, "residual",
                                residual)
        if self.grid is not None:
            return residual + tp.row_parallel(out, self.out_proj.weight, self.out_proj.bias, dt,
                                              self.grid)
        return residual + linear(out, self.out_proj.weight, self.out_proj.bias, dt)


class MLP(nn.Module):
    """c_fc, quick_gelu, c_proj, added to `residual` (the block's stream);
    on a tensor-parallel grid (`grid`) c_fc column-parallel and c_proj
    row-parallel over the local hidden units.  With `tower_gemm`, in fp32
    and off a grid, both are kernel H, QuickGELU in c_fc's epilogue and the
    residual in c_proj's."""

    def __init__(self, width: int, device=None, tower_gemm: bool = False):
        super().__init__()
        self.grid = None
        self.tower_gemm = tower_gemm
        self.c_fc = nn.Linear(width, 4 * width, device=device)
        self.c_proj = nn.Linear(4 * width, width, device=device)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        dt = self.c_fc.weight.dtype
        if self.tower_gemm and self.grid is None and dt == torch.float32:
            y = tower_linear(x, self.c_fc.weight, self.c_fc.bias, "gelu")
            return tower_linear(y, self.c_proj.weight, self.c_proj.bias, "residual", residual)
        (x,) = tp.copy_to_mp(x, grid=self.grid)
        y = quick_gelu(linear(x, self.c_fc.weight, self.c_fc.bias, dt))
        if self.grid is not None:
            return residual + tp.row_parallel(y, self.c_proj.weight, self.c_proj.bias, dt,
                                              self.grid)
        return residual + linear(y, self.c_proj.weight, self.c_proj.bias, dt)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, device=None, tower_gemm: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width, device=device)
        self.attn = MultiheadSelfAttention(width, heads, device=device, tower_gemm=tower_gemm)
        self.ln_2 = LayerNorm(width, device=device)
        self.mlp = MLP(width, device=device, tower_gemm=tower_gemm)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        x = self.attn(self.ln_1(x), x, causal)
        return self.mlp(self.ln_2(x), x)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, device=None,
                 tower_gemm: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, device=device, tower_gemm=tower_gemm)
            for _ in range(layers)
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
        self.transformer = Transformer(width, layers, heads, device=device, tower_gemm=True)
        self.ln_post = LayerNorm(width, device=device)
        self.proj = nn.Parameter(torch.empty(width, output_dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) preprocessed -> (B, output_dim) fp32."""
        b, hgt, wid, c = x.shape
        p = self.patch_size
        weight = self.conv1.weight
        x = x.to(weight.dtype)  # the tower's dtype from its entry on
        # the stride-p patch convolution as one matmul over (c, ky, kx) patches
        patches = x.reshape(b, hgt // p, p, wid // p, p, c).permute(0, 1, 3, 5, 2, 4)
        patches = patches.reshape(b, (hgt // p) * (wid // p), c * p * p)
        x = torch.matmul(patches, weight.reshape(weight.shape[0], -1).t())
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.transformer(self.ln_pre(x))
        return torch.matmul(self.ln_post(x[:, 0, :]), self.proj).float()


def _insert_prompt_embeddings(x_ori: torch.Tensor, tokens: torch.Tensor, former=None,
                              later=None) -> torch.Tensor:
    """Each row's token embeddings rearranged to [SOT, former, name tokens,
    later, EOT, padding] (JAX clip.py:243-279, reference CLIP/clip/model.py:
    1095-1114): x_ori (B, L, W), tokens (B, L), former (Lf, W) and later
    (Ll, W) learned prompt embeddings or None.  The tail takes x_ori's rows
    from lt + lf + ll on unshifted (the reference drops the lf + ll
    displaced padding embeddings)."""
    lf = 0 if former is None else former.shape[0]
    ll = 0 if later is None else later.shape[0]
    if lf == 0 and ll == 0:
        return x_ori
    seq_len = x_ori.shape[1]
    dev = x_ori.device
    lt = (tokens.argmax(-1) + 1)[:, None]  # (B, 1) the row's length with SOT and EOT
    p = torch.arange(seq_len, device=dev)[None, :]  # (1, L)
    in_former = (p >= 1) & (p <= lf)
    in_later = (p >= lf + lt - 1) & (p <= lf + lt - 2 + ll)
    src = torch.where(p == 0, 0, torch.where(
        p <= lf + lt - 2, p - lf, torch.where(p == lf + ll + lt - 1, p - lf - ll, p)))
    src = torch.clamp(src, 0, seq_len - 1).expand(x_ori.shape[0], seq_len)
    out = torch.gather(x_ori, 1, src[..., None].expand(-1, -1, x_ori.shape[2]))
    if lf:
        fvals = former[torch.clamp(p - 1, 0, lf - 1)].to(out.dtype)  # (1, L, W)
        out = torch.where(in_former[..., None], fvals, out)
    if ll:
        lvals = later[torch.clamp(p - (lf + lt - 1), 0, ll - 1)].to(out.dtype)  # (B, L, W)
        out = torch.where(in_later[..., None], lvals, out)
    return out


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

    def encode_text(self, tokens: torch.Tensor, prompt_former=None,
                    prompt_later=None) -> torch.Tensor:
        """tokens (B, context_length) integer -> (B, output_dim) fp32.

        With prompt_former / prompt_later ((Lf, W) / (Ll, W) learned prompt
        embeddings) the token embeddings are rearranged by
        `_insert_prompt_embeddings`; the pooling still gathers at the
        original argmax position of the token ids, a reference quirk the
        JAX package keeps (clip.py:293-305, 319-320): the shifted
        sequence's EOT sits Lf + Ll later."""
        x = self.token_embedding(tokens)
        x = _insert_prompt_embeddings(x, tokens, prompt_former, prompt_later)
        x = x + self.positional_embedding
        x = self.ln_final(self.transformer(x, causal=True))
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
        return torch.matmul(pooled, self.text_projection).float()

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

    @property
    def dtype(self) -> torch.dtype:
        """The towers' compute dtype: their weights'."""
        return self.visual.conv1.weight.dtype

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_text_with_prompt_embedding(self, tokens: torch.Tensor, prompt_former=None,
                                          prompt_later=None) -> torch.Tensor:
        """Learned-prompt text encoding (JAX clip.py:373-377, reference
        CLIP/clip/model.py:1084), for the prompt-tuning losses."""
        return self.encode_text(tokens, prompt_former, prompt_later)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor):
        img = self.encode_image(images)
        txt = self.encode_text(tokens)
        img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
        scale = self.logit_scale.exp()
        return scale * img @ txt.t(), scale * txt @ img.t()


def _resize_matrix(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """(out, in) weights of jax.image.resize(method="cubic") along one axis
    (jax._src.image.scale.compute_weight_mat with translation 0 and
    antialias): Keys' cubic with a = -0.5, widened by in/out when it
    shrinks, normalized over the taps inside the image, in fp32."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]).abs()
    x = x / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).t()


def preprocess_images(images: torch.Tensor, resolution: int = 224) -> torch.Tensor:
    """CLIP's tensor preprocessing (JAX clip.py:388-405, reference
    clip.py:95-101): images (B, H, W, 3) in [0, 255] -> the short side
    resized to `resolution` by jax.image.resize's antialiased cubic
    (`_resize_matrix`, not F.interpolate's a = -0.75 bicubic), a centre
    crop of resolution x resolution, / 255 and CLIP's mean and std."""
    images = images.to(torch.float32)
    _, h, w, _ = images.shape
    if h <= w:
        nh, nw = resolution, max(int(round(w * resolution / h)), resolution)
    else:
        nh, nw = max(int(round(h * resolution / w)), resolution), resolution
    dev = images.device
    ry = _resize_matrix(h, nh, dev) if nh != h else None
    rx = _resize_matrix(w, nw, dev) if nw != w else None
    top, left = (nh - resolution) // 2, (nw - resolution) // 2
    # only the rows and columns the crop keeps
    if ry is not None:
        images = torch.einsum("oh,bhwc->bowc", ry[top:top + resolution], images)
    else:
        images = images[:, top:top + resolution]
    if rx is not None:
        images = torch.einsum("pw,bowc->bopc", rx[left:left + resolution], images)
    else:
        images = images[:, :, left:left + resolution]
    mean = torch.from_numpy(IMAGE_MEAN).to(dev)
    std = torch.from_numpy(IMAGE_STD).to(dev)
    return (images / 255.0 - mean) / std


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
