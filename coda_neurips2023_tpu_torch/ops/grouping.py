"""Ball query and grouping (PyTorch + kernels B, C, F and G).

Counterparts of coda_neurips2023_tpu/ops/grouping.py:
  * `ball_query`: for each centre, the first `nsample` point indices, in
    index order, with squared distance < radius^2; trailing slots are filled
    with the first hit, and a row with no hit is all zeros.  On a CUDA tensor
    it launches kernel B (csrc/ball_query.cu) or kernel G
    (csrc/ball_query_tile.cu), picked as the JAX package picks its Pallas
    kernel (`ball_query_kernel`); on a CPU tensor it takes the plain version
    below, whatever the environment says, as the JAX package's CPU path does.
  * `group_points`: the batched gather out[b, m, k] = features[b, idx[b, m, k]].
    Kernel C (csrc/gather.cu) on CUDA, bit-equal to `torch.gather` on the
    CPU; it offsets inside a batch row in 32 bits, so M*K*C and N*C must lie
    below 2^31 and B at most 65535.  Where features need a gradient it runs
    as an autograd Function: the backward is the scatter-add of the JAX
    package's custom VJP (grouping.py:169-178), in plain PyTorch
    (`index_add_`).
  * `ball_query_group`: both in one pass, `ball_query` then `group_points` of
    the coordinates.  Kernel F (csrc/ball_query_group.cu) on CUDA.
  * `query_and_group`: the above, re-centred and radius-normalized; it takes
    `ball_query_group` under the JAX package's gate (`fused_gather`),
    otherwise `ball_query` then `group_points`.

The environment is read at call time, as in the JAX package
(grouping.py:73-124, 223-230):
  * CODA_BQ_MXU=1 with nsample == 64: kernel G (the MXU kernel's row);
  * else CODA_BQ_ALGO: "sorted" (the default) or "window" -> kernel B (the
    sorted kernel for N >= 4096, v3 below it: one function, one kernel);
    "adaptive" -> kernel G; any other value raises ValueError;
  * CODA_BQ_FUSED_GATHER=1 -> kernel F, only with CODA_BQ_MXU != 1,
    CODA_BQ_ALGO == "sorted", N >= 4096 and nsample % 128 != 0.

Distances are written out as ((dx*dx + dy*dy) + dz*dz), elementwise, in the
kernel's order, so the plain version and kernels B, F and G agree bit for
bit.  (The JAX package's CPU path uses |a|^2 + |b|^2 - 2ab instead, which can
flip a hit lying exactly on the radius; see its grouping.py:22-27.)

Indices are int32 in and out, as in the JAX package.  Point coordinates take
no gradient: B, F and G refuse inputs that require one.  A CUDA call launches
the kernel it is routed to or raises: no size gate of the TPU kernels is
carried over, and nothing falls back to the plain version.
"""

from __future__ import annotations

import os

import torch

from coda_neurips2023_tpu_torch import _kernels


def _check_points(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.float32 or t.dim() != 3 or t.shape[-1] != 3:
        raise ValueError(f"{name}: expected float32 (B, N, 3), got {t.dtype} {tuple(t.shape)}")


def _check_query(nsample: int, xyz, new_xyz) -> None:
    _check_points("xyz", xyz)
    _check_points("new_xyz", new_xyz)
    if new_xyz.shape[0] != xyz.shape[0] or xyz.device != new_xyz.device:
        raise ValueError("xyz and new_xyz must share batch size and device")
    if nsample < 1:
        raise ValueError(f"nsample must be >= 1, got {nsample}")
    if xyz.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ball query: unsupported device {xyz.device}")
    if xyz.device.type == "cuda" and not (xyz.is_contiguous() and new_xyz.is_contiguous()):
        raise ValueError("ball query: inputs must be contiguous")


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (..., 3), b (..., 3) broadcast -> ((dx*dx + dy*dy) + dz*dz)."""
    d = a - b
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def _r2(radius: float) -> torch.Tensor:
    # r^2 as the f32 of the Python float, as the Pallas kernels take it
    return torch.tensor(float(radius) ** 2, dtype=torch.float32)


def ball_query_plain(radius: float, nsample: int, xyz, new_xyz) -> torch.Tensor:
    """Plain PyTorch version of `ball_query`, on any device."""
    r2 = _r2(radius).to(xyz.device)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    out = torch.zeros((b, m, nsample), dtype=torch.int32, device=xyz.device)
    iota = torch.arange(n, device=xyz.device)
    kk = min(nsample, n)
    slot = torch.arange(kk, device=xyz.device)
    for bi in range(b):  # one scene at a time bounds the (M, N) buffer
        hit = _sq_dist(new_xyz[bi, :, None, :], xyz[bi, None, :, :]) < r2
        # hits keep their index, misses go after every hit: the kk smallest
        # keys are the first hits in index order
        key = torch.where(hit, iota, iota + n)
        first_k = torch.topk(key, kk, dim=1, largest=False, sorted=True).indices
        cnt = hit.sum(dim=1, keepdim=True)
        first = first_k[:, :1]
        row = torch.where(slot < cnt, first_k, first)
        row = torch.cat([row, first.expand(m, nsample - kk)], dim=1)
        out[bi] = torch.where(cnt > 0, row, 0).to(torch.int32)
    return out


_BQ_ALGOS = ("window", "adaptive", "sorted")


def ball_query_kernel(nsample: int) -> str:
    """The C entry point a CUDA `ball_query` launches, from the environment
    as it stands (the JAX package's choice of Pallas kernel, grouping.py:78-124):
    "coda_ball_query_tile" (G) for CODA_BQ_MXU=1 with nsample 64 and for
    CODA_BQ_ALGO=adaptive, "coda_ball_query" (B) for "sorted" at any N (its
    sorted kernel above 4096 points, v3 below) and for "window"."""
    if os.environ.get("CODA_BQ_MXU") == "1" and nsample == 64:
        return "coda_ball_query_tile"
    algo = os.environ.get("CODA_BQ_ALGO", "sorted")
    if algo not in _BQ_ALGOS:
        # a mistyped variable must not quietly pick another kernel
        raise ValueError(
            f"CODA_BQ_ALGO={algo!r}: expected 'window', 'adaptive' or"
            " 'sorted' (MXU variant is selected via CODA_BQ_MXU=1)"
        )
    return "coda_ball_query_tile" if algo == "adaptive" else "coda_ball_query"


def fused_gather(nsample: int, n: int) -> bool:
    """Whether `query_and_group` takes `ball_query_group` (kernel F): the JAX
    package's four-part gate (grouping.py:223-230) on CODA_BQ_FUSED_GATHER=1."""
    return (
        os.environ.get("CODA_BQ_FUSED_GATHER", "0") == "1"
        and os.environ.get("CODA_BQ_MXU") != "1"
        and os.environ.get("CODA_BQ_ALGO", "sorted") == "sorted"
        and n >= 4096
        and nsample % 128 != 0
    )


def _launch_ball_query(fn: str, radius: float, nsample: int, xyz, new_xyz) -> torch.Tensor:
    _kernels.check_no_grad("ball_query", xyz, new_xyz)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    out = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    _kernels.launch(fn, xyz, new_xyz, out, b, n, m, nsample, float(_r2(radius)))
    return out


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz: (B, N, 3) points, new_xyz: (B, M, 3) centres -> (B, M, nsample) int32."""
    _check_query(nsample, xyz, new_xyz)
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    return _launch_ball_query(ball_query_kernel(nsample), radius, nsample, xyz, new_xyz)


def ball_query_tile(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """`ball_query` through kernel G whatever the environment says (the plain
    version on a CPU tensor): for holding G against B and the plain version."""
    _check_query(nsample, xyz, new_xyz)
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    return _launch_ball_query("coda_ball_query_tile", radius, nsample, xyz, new_xyz)


def group_points_plain(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `group_points`, on any device."""
    b, m, k = idx.shape
    c = features.shape[-1]
    flat = idx.reshape(b, m * k, 1).long().expand(-1, -1, c)
    return torch.gather(features, 1, flat).reshape(b, m, k, c)


def _gather_kernel(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    b, n, c = features.shape
    _, m, k = idx.shape
    # kernel C offsets inside a batch row in 32 bits
    if m * k * c >= 2 ** 31 or n * c >= 2 ** 31:
        raise ValueError(f"group_points: a batch row of {m * k} x {c} outputs or {n} x {c}"
                         " features needs offsets of 2^31 or more")
    if b > 65535 or (n == 0 and m * k > 0):
        raise ValueError(f"group_points: B={b} (at most 65535) or N={n} (at least 1) out of range")
    out = torch.empty((b, m, k, c), dtype=torch.float32, device=features.device)
    _kernels.launch("coda_gather", features, idx, out, b, n, m * k, c)
    return out


def scatter_add_grouped(grad: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Backward of `group_points`: grad (B, M, K, C) summed into (B, N, C) at
    the gathered rows (the JAX package's `.at[...].add`, grouping.py:169-178)."""
    b, m, k, c = grad.shape
    rows = (idx.long() + n * torch.arange(b, device=idx.device)[:, None, None]).reshape(-1)
    out = torch.zeros((b * n, c), dtype=grad.dtype, device=grad.device)
    out.index_add_(0, rows, grad.reshape(b * m * k, c))
    return out.reshape(b, n, c)


def _group_forward(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if features.device.type == "cpu":
        return group_points_plain(features, idx)
    return _gather_kernel(features, idx)


class GroupPoints(torch.autograd.Function):
    """Forward: kernel C on a CUDA tensor, the plain gather on a CPU one.
    Backward: the scatter-add, on either.  idx takes no gradient."""

    @staticmethod
    def forward(ctx, features, idx):
        ctx.save_for_backward(idx)
        ctx.n = features.shape[1]
        return _group_forward(features, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return scatter_add_grouped(grad, idx, ctx.n), None


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features: (B, N, C) float32, idx: (B, M, K) int32 -> (B, M, K, C)."""
    if features.dtype != torch.float32 or features.dim() != 3:
        raise ValueError(f"features: expected float32 (B, N, C), got {features.dtype} {tuple(features.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 3 or idx.shape[0] != features.shape[0]:
        raise ValueError(f"idx: expected int32 (B, M, K), got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != features.device:
        raise ValueError("features and idx must share a device")
    if features.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_points: unsupported device {features.device}")
    if features.device.type == "cuda" and not (features.is_contiguous() and idx.is_contiguous()):
        raise ValueError("group_points: inputs must be contiguous")
    if not (torch.is_grad_enabled() and features.requires_grad):
        return _group_forward(features, idx)  # no gradient wanted: no autograd node
    return GroupPoints.apply(features, idx)


def ball_query_group_plain(radius: float, nsample: int, xyz, new_xyz):
    """Plain PyTorch version of `ball_query_group`: `ball_query_plain`, then
    `group_points_plain` of the coordinates."""
    idx = ball_query_plain(radius, nsample, xyz, new_xyz)
    return idx, group_points_plain(xyz, idx)


def ball_query_group(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor):
    """xyz (B, N, 3), new_xyz (B, M, 3) -> (idx (B, M, nsample) int32,
    grouped (B, M, nsample, 3) = xyz gathered at idx)."""
    _check_query(nsample, xyz, new_xyz)
    b, n, _ = xyz.shape
    if n < 1:
        raise ValueError("ball_query_group: needs N >= 1 (a row with no hit takes point 0)")
    if xyz.device.type == "cpu":
        return ball_query_group_plain(radius, nsample, xyz, new_xyz)
    _kernels.check_no_grad("ball_query_group", xyz, new_xyz)
    m = new_xyz.shape[1]
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    grouped = torch.empty((b, m, nsample, 3), dtype=torch.float32, device=xyz.device)
    _kernels.launch(
        "coda_ball_query_group", xyz, new_xyz, idx, grouped, b, n, m, nsample,
        float(_r2(radius)),
    )
    return idx, grouped


def query_and_group(radius: float, nsample: int, xyz, new_xyz, normalize_xyz: bool = False):
    """Ball query + grouped, re-centred xyz (reference QueryAndGroup, xyz only:
    grouping point features is not ported yet).

    Returns (new_features, grouped_xyz), both (B, M, nsample, 3): without
    point features the two are the same tensor, as in the JAX package.
    """
    if fused_gather(nsample, xyz.shape[1]):
        _, grouped = ball_query_group(radius, nsample, xyz, new_xyz)
    else:
        grouped = group_points(xyz, ball_query(radius, nsample, xyz, new_xyz))
    grouped_xyz = grouped - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    return grouped_xyz, grouped_xyz
