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
  * `query_and_group`: the above, re-centred and radius-normalized, with
    the point features grouped at the same indices; it takes
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

Kernels B and F search a spatial cell grid, so a centre tests only the points
of the cells near it (`ball_query_grid_plain` is their algorithm in tensor
ops).  Each scene's bounding box is cut into cubes of side at least the
widened radius r_w = r * (1 + GRID_WIDEN); the side doubles until the scene
has at most `grid_cap(N)` cells.  A point's cell on each axis is
floor((x - lo) * inv_side), clamped into the grid, and a centre reads the
cells from that of nextafter(c - r_w, -inf) to that of nextafter(c + r_w,
+inf).  Why no hit is missed: a hit's f32 distance is below f32(r^2), so on
each axis |c - p| < r * (1 + 2^-23 + ...) < r_w, and the rounded-outward
bounds hold c - r_w <= p <= c + r_w exactly; the cell function is monotone
(each rounding step is) and is the same for points and bounds, so p's cell
lies in the range.  A far point lands in a border cell and a far centre reads
a border cell: both are tested, never dropped.  The hits are then reduced to
the k smallest original indices, which are the first k in index order
whatever order the candidates came in (the JAX sorted kernel's extraction by
minimum original index, pallas_ball_query_sorted.py:26-30).

Kernel G serves a tile of nearby centres at once on the same grid
(`ball_query_tile_grid_plain` is its algorithm in tensor ops).  The build's
one sort also orders each scene's centres by the Morton key of their own
cell (`_tile_keys_plain`); a block takes TILE_SIZE consecutive centres of
that order, stages the rows of cells its centres read, one contiguous run
of slots a row (`_tile_union_rows`), into shared memory by asynchronous
copies, and each centre tests its own cells among the staged points.  The
union holds all of a centre's cells, so no hit is missed, and the k
smallest indices are taken as in B; each result goes back to its centre's
own row.

Indices are int32 in and out, as in the JAX package.  Point coordinates take
no gradient: B, F and G refuse inputs that require one.  A CUDA call launches
the kernel it is routed to or raises: no size gate of the TPU kernels is
carried over, and nothing falls back to the plain version.
"""

from __future__ import annotations

import math
import os
import struct

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


def _f32(x: float) -> float:
    """x rounded to the nearest f32, as a Python float."""
    return struct.unpack("f", struct.pack("f", x))[0]


def _first_hits(key: torch.Tensor, cnt: torch.Tensor, nsample: int) -> torch.Tensor:
    """key (M, W): each hit's original index, each miss a larger value; cnt
    (M, 1) hits -> (M, nsample) int32: the smallest hit indices ascending,
    trailing slots the first hit, a row without hit zeros."""
    m, w = key.shape
    kk = min(nsample, w)
    first_k = torch.topk(key, kk, dim=1, largest=False, sorted=True).values
    first = first_k[:, :1]
    row = torch.where(torch.arange(kk, device=key.device) < cnt, first_k, first)
    row = torch.cat([row, first.expand(m, nsample - kk)], dim=1)
    return torch.where(cnt > 0, row, 0).to(torch.int32)


def ball_query_plain(radius: float, nsample: int, xyz, new_xyz) -> torch.Tensor:
    """Plain PyTorch version of `ball_query`, on any device."""
    r2 = _r2(radius).to(xyz.device)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    out = torch.zeros((b, m, nsample), dtype=torch.int32, device=xyz.device)
    iota = torch.arange(n, device=xyz.device)
    for bi in range(b):  # one scene at a time bounds the (M, N) buffer
        hit = _sq_dist(new_xyz[bi, :, None, :], xyz[bi, None, :, :]) < r2
        # hits keep their index, misses go after every hit
        key = torch.where(hit, iota, iota + n)
        out[bi] = _first_hits(key, hit.sum(dim=1, keepdim=True), nsample)
    return out


# The grid of kernels B and F (see the module docstring).  The kernels take
# these as arguments, so they and the plain version below cannot drift.
GRID_WIDEN = 8 * 2.0 ** -23  # r_w = r * (1 + GRID_WIDEN): the JAX sorted kernel's 8 ulp
GRID_SIDE_FACTOR = 1.5  # the first cell side tried, in widened radii (won the sweep of PERF.md)
GRID_CELLS_PER_POINT = 4  # a scene has at most max(4 N, GRID_MIN_CELLS) cells
GRID_MIN_CELLS = 4096
GRID_DOUBLINGS = 64  # a side that still gives too many cells: one cell
GRID_AXIS_CELLS = 2 ** 20  # an axis's count saturates here (inf or NaN extents)
GRID_LAUNCHES = 3  # kernel launches a call of B or F: cells, pack, query
GRID_MAX_SAMPLES = 8192  # min(nsample, N), rounded up to 32, that the query takes


def grid_radius(radius: float) -> float:
    return float(radius) * (1.0 + GRID_WIDEN)


def grid_cap(n: int) -> int:
    return max(GRID_CELLS_PER_POINT * n, GRID_MIN_CELLS)


def grid_side(radius: float, side_factor: float = GRID_SIDE_FACTOR) -> float:
    """The first cell side tried, as the f32 the kernels receive."""
    return _f32(side_factor * grid_radius(radius))


def grid_params_plain(xyz: torch.Tensor, side: float, cap: int):
    """Per scene (lo (B, 3) f32, inv_side (B,) f32, dims (B, 3) int64): the
    bounding box's low corner, the inverse of the first side of side * 2^j
    (f32 doublings, exact) whose grid has at most `cap` cells, and the cells
    a side; after GRID_DOUBLINGS sides, one cell at the first side."""
    lo, hi = xyz.amin(1), xyz.amax(1)
    ext = hi - lo
    j = torch.arange(GRID_DOUBLINGS, device=xyz.device)
    sides = torch.tensor(side, dtype=torch.float32, device=xyz.device) * (2.0 ** j).float()
    inv = 1.0 / sides  # (J,)
    t = torch.floor(ext[:, None, :] * inv[None, :, None])  # (B, J, 3)
    dims = torch.where(t < GRID_AXIS_CELLS, t, GRID_AXIS_CELLS).long() + 1
    ok = dims.prod(-1) <= cap
    first = ok.int().argmax(1)  # 0 where none fits
    dims = torch.where(ok.any(1)[:, None], dims[torch.arange(len(first)), first], 1)
    return lo, inv[first], dims


def _cell_coord(x, lo, inv, dims):
    """The cell of coordinate x on its axis: floor((x - lo) * inv), clamped
    into [0, dims - 1] (NaN to 0), as the kernels compute it."""
    t = torch.floor((x - lo) * inv)
    top = (dims - 1).float()
    return torch.where(t >= top, top, torch.where(t >= 0, t, 0.0)).long()


def _grid_plain(radius: float, xyz, side_factor: float):
    """The sorted grid of each scene: (lo (B, 1, 3), inv (B, 1, 1), dims
    (B, 1, 3), perm (B, N) the point order by (cell, original index),
    starts (B, cells + 1) each cell's first slot in that order)."""
    b, n, _ = xyz.shape
    lo, inv, dims = grid_params_plain(xyz, grid_side(radius, side_factor), grid_cap(n))
    lo, inv, dims = lo[:, None, :], inv[:, None, None], dims[:, None, :]
    pc = _cell_coord(xyz, lo, inv, dims)  # (B, N, 3)
    cells = (pc[..., 2] * dims[..., 1] + pc[..., 1]) * dims[..., 0] + pc[..., 0]
    scells, perm = torch.sort(cells, dim=1, stable=True)
    ncells = int(dims.prod(-1).max())
    every_cell = torch.arange(ncells + 1, device=xyz.device).expand(b, -1).contiguous()
    return lo, inv, dims, perm, torch.searchsorted(scells, every_cell)


def _centre_boxes(radius: float, new_xyz, lo, inv, dims):
    """Each centre's range of cells on each axis, (B, M, 3) from and to
    (inclusive): those of its widened box's bounds, rounded outward."""
    rw = torch.tensor(grid_radius(radius), dtype=torch.float32, device=new_xyz.device)
    inf = torch.tensor(math.inf, device=new_xyz.device)
    return (_cell_coord(torch.nextafter(new_xyz - rw, -inf), lo, inv, dims),
            _cell_coord(torch.nextafter(new_xyz + rw, inf), lo, inv, dims))


def _grid_spans_plain(radius: float, xyz, new_xyz, side_factor: float):
    """The sorted grid and every centre's candidate rows: (perm (B, N) the
    point order by (cell, original index), beg and length (B, M, R) of each
    row of cells a centre reads, contiguous in that order)."""
    lo, inv, dims, perm, starts = _grid_plain(radius, xyz, side_factor)
    c0, c1 = _centre_boxes(radius, new_xyz, lo, inv, dims)
    w = c1 - c0 + 1
    nrows = w[..., 1] * w[..., 2]  # (B, M): rows of cells along x
    r = torch.arange(int(nrows.max()), device=xyz.device)
    valid = r < nrows[..., None]
    y = c0[..., 1:2] + r % w[..., 1:2]
    z = c0[..., 2:3] + r // w[..., 1:2]
    base = torch.where(valid, (z * dims[..., 1:2] + y) * dims[..., :1], 0)
    beg = torch.gather(starts, 1, (base + c0[..., :1]).flatten(1)).view_as(base)
    end = torch.gather(starts, 1, (base + c1[..., :1] + 1).flatten(1)).view_as(base)
    return perm, beg, torch.where(valid, end - beg, 0)


def ball_query_grid_plain(radius: float, nsample: int, xyz, new_xyz,
                          side_factor: float = GRID_SIDE_FACTOR) -> torch.Tensor:
    """Kernels B's and F's algorithm in plain PyTorch, on any device: the
    cell grid, each centre's candidates, the distance test, the k smallest
    original indices among the hits, filled as `ball_query`.  Bit-equal to
    `ball_query_plain` (the module docstring says why)."""
    r2 = _r2(radius).to(xyz.device)
    b, n, _ = xyz.shape
    perm, beg, length = _grid_spans_plain(radius, xyz, new_xyz, side_factor)
    out = torch.zeros((b, new_xyz.shape[1], nsample), dtype=torch.int32, device=xyz.device)
    for bi in range(b):
        p = torch.arange(max(int(length[bi].max()), 1), device=xyz.device)
        valid = p < length[bi, ..., None]  # (M, R, L)
        slot = torch.where(valid, beg[bi, ..., None] + p, 0)
        idx = perm[bi][slot]
        hit = valid & (_sq_dist(new_xyz[bi, :, None, None, :], xyz[bi][idx]) < r2)
        key = torch.where(hit, idx, n).flatten(1)
        out[bi] = _first_hits(key, hit.flatten(1).sum(1, keepdim=True), nsample)
    return out


def ball_query_grid_candidates(radius: float, xyz, new_xyz,
                               side_factor: float = GRID_SIDE_FACTOR) -> torch.Tensor:
    """(B, M) int64: the points each centre tests on the grid."""
    return _grid_spans_plain(radius, xyz, new_xyz, side_factor)[2].sum(-1)


# Kernel G (see the module docstring): B's grid, with a block for a tile of
# TILE_SIZE centres that lie close together.  Each scene's centres are
# ordered by the Morton key of their own cell (`_tile_keys_plain`) in the
# build's one sort; a tile is TILE_SIZE consecutive centres in that order.
TILE_SIZE = 8  # centres a block of G (PERF.md: the chip sweep of 8, 16, 32, 64)
TILE_SIZES = (8, 16, 32, 64)  # the tile sizes the kernel is built for
TILE_SIDE_FACTOR = 1.0  # G's first cell side, in widened radii (PERF.md)
TILE_LAUNCHES = 3  # kernel launches a call of G: cells, pack, query
TILE_MAX_SAMPLES = 512  # min(nsample, N), rounded up to 32, that G's query takes


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """The bit length of each entry of a non-negative integer tensor below 2^31."""
    return (v[..., None] >= 2 ** torch.arange(31, device=v.device)).sum(-1)


def _tile_key_bits(dims: torch.Tensor, stride: int):
    """(bits, shift), both (B, 3): how many low bits of each axis's cell
    coordinate, shifted right by `shift`, the Morton key of a scene with
    `dims` cells a side takes, so that every key lies below `stride` (the
    scene's key range in the build's sort): while the axes' bit lengths add
    up to more than floor(log2(stride)), the longest (x before y before z)
    gives up its lowest bit."""
    full = _bit_length(dims - 1)
    bits = full.clone()
    budget = int(_bit_length(torch.tensor(stride))) - 1
    rows = torch.arange(bits.shape[0], device=dims.device)
    while True:
        over = bits.sum(-1) > budget
        if not over.any():
            return bits, full - bits
        bits[rows[over], bits[over].argmax(-1)] -= 1


def _tile_keys_plain(cells: torch.Tensor, bits: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """cells (B, M, 3) int64 -> (B, M) int64 Morton keys: the shifted
    coordinates' bits interleaved from the lowest, x, y, z in turn, an axis
    dropping out once its `bits` are spent (so a long axis orders the
    coarsest level).  Kernel G's cells kernel computes the same."""
    q = cells >> shift[:, None, :]
    key = torch.zeros(cells.shape[:-1], dtype=torch.int64, device=cells.device)
    pos = torch.zeros_like(key)
    for j in range(int(bits.max()) if bits.numel() else 0):
        for a in range(3):
            take = (j < bits[:, None, a]).long()
            key |= (((q[..., a] >> j) & 1) * take) << pos
            pos += take
    return key


def tile_order_plain(radius: float, xyz, new_xyz, side_factor: float = TILE_SIDE_FACTOR):
    """(B, M) int64: each scene's centres in kernel G's order, by the Morton
    key of their cell and then by index (a stable sort)."""
    lo, inv, dims = grid_params_plain(xyz, grid_side(radius, side_factor), grid_cap(xyz.shape[1]))
    cells = _cell_coord(new_xyz, lo[:, None], inv[:, None, None], dims[:, None])
    bits, shift = _tile_key_bits(dims, grid_cap(xyz.shape[1]) + 1)
    return torch.sort(_tile_keys_plain(cells, bits, shift), dim=1, stable=True).indices


def _tile_union_rows(c0, c1, dims, starts, tile: int):
    """One scene's tiles: c0, c1 (M, 3) the centres' cell ranges in tile
    order, dims (3,), starts (cells + 1,) -> (beg, length) (T, R), u0 (T,
    3), wy (T,): each (y, z) row r = (z - u0_z) * wy + (y - u0_y) of a
    tile's bounding box of rows, as one run of slots from the least to the
    greatest x cell the tile's centres that read the row read on it (length
    0 where none does)."""
    m = c0.shape[0]
    nt = -(-m // tile)
    pad = nt * tile - m
    big = torch.iinfo(torch.int64).max
    # a padding centre reads nothing: its range is empty on every axis
    c0 = torch.cat([c0, c0.new_full((pad, 3), big)]).view(nt, tile, 3)
    c1 = torch.cat([c1, c1.new_full((pad, 3), -1)]).view(nt, tile, 3)
    u0, u1 = c0.amin(1), c1.amax(1)  # (T, 3)
    wy = u1[:, 1] - u0[:, 1] + 1
    nrows = wy * (u1[:, 2] - u0[:, 2] + 1)
    r = torch.arange(int(nrows.max()), device=c0.device)
    y = u0[:, 1:2] + r % wy[:, None]  # (T, R)
    z = u0[:, 2:3] + r // wy[:, None]
    reads = ((c0[:, None, :, 1] <= y[..., None]) & (y[..., None] <= c1[:, None, :, 1])
             & (c0[:, None, :, 2] <= z[..., None]) & (z[..., None] <= c1[:, None, :, 2]))
    xmin = torch.where(reads, c0[:, None, :, 0], big).amin(-1)
    xmax = torch.where(reads, c1[:, None, :, 0], -1).amax(-1)
    used = reads.any(-1) & (r < nrows[:, None])
    base = torch.where(used, (z * dims[1] + y) * dims[0], 0)
    beg = starts[base + torch.where(used, xmin, 0)]
    end = starts[base + torch.where(used, xmax + 1, 0)]
    return beg, torch.where(used, end - beg, 0), u0, wy


def _tile_candidates_plain(radius: float, xyz, new_xyz, tile: int, side_factor: float, order):
    """Per scene, the centres in tile order: (order (M,), slot and valid
    (M, R, L): the grid slots of a centre's own cells on each of its rows,
    cut to that row's run in its tile's union, union (M,): the points its
    tile stages), with perm (B, N)."""
    lo, inv, dims, perm, starts = _grid_plain(radius, xyz, side_factor)
    c0, c1 = _centre_boxes(radius, new_xyz, lo, inv, dims)
    if order is None:
        order = tile_order_plain(radius, xyz, new_xyz, side_factor)
    scenes = []
    for bi in range(xyz.shape[0]):
        o = order[bi]
        a0, a1 = c0[bi, o], c1[bi, o]
        beg, length, u0, wy = _tile_union_rows(a0, a1, dims[bi, 0], starts[bi], tile)
        t = torch.arange(len(o), device=xyz.device) // tile  # each centre's tile
        w = a1 - a0 + 1
        nrows = w[:, 1] * w[:, 2]
        rr = torch.arange(int(nrows.max()), device=xyz.device)
        y = a0[:, 1:2] + rr % w[:, 1:2]
        z = a0[:, 2:3] + rr // w[:, 1:2]
        ur = (z - u0[t, 2:3]) * wy[t, None] + (y - u0[t, 1:2])  # (M, R): rows of the union
        ok = rr < nrows[:, None]
        ur = torch.where(ok, ur, 0)
        # the centre's own cells on the row, cut to the row's staged run
        base = torch.where(ok, (z * dims[bi, 0, 1] + y) * dims[bi, 0, 0], 0)
        run = beg[t[:, None], ur]
        lo = torch.maximum(starts[bi][base + a0[:, :1]], run)
        hi = torch.minimum(starts[bi][base + a1[:, :1] + 1], run + length[t[:, None], ur])
        n_ = torch.where(ok, (hi - lo).clamp(min=0), 0)
        p = torch.arange(max(int(n_.max()), 1), device=xyz.device)
        valid = p < n_[..., None]
        scenes.append((o, torch.where(valid, lo[..., None] + p, 0), valid, length.sum(-1)[t]))
    return perm, scenes


def ball_query_tile_grid_plain(radius: float, nsample: int, xyz, new_xyz,
                               tile: int = TILE_SIZE, side_factor: float = TILE_SIDE_FACTOR,
                               order=None) -> torch.Tensor:
    """Kernel G's algorithm in plain PyTorch, on any device: B's cell grid;
    the centres in `order` ((B, M), by default `tile_order_plain`), cut
    into tiles of `tile`; each tile stages the rows of its union
    (`_tile_union_rows`), and each centre tests its own cells in the staged
    runs of its rows; the k smallest original indices among the hits,
    filled as `ball_query`, go back to each centre's own row.  Bit-equal to
    `ball_query_plain` for any order and tile (its tile's union holds all
    of a centre's cells)."""
    r2 = _r2(radius).to(xyz.device)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    out = torch.zeros((b, m, nsample), dtype=torch.int32, device=xyz.device)
    if m == 0 or n == 0:
        return out
    perm, scenes = _tile_candidates_plain(radius, xyz, new_xyz, tile, side_factor, order)
    for bi, (o, slot, valid, _) in enumerate(scenes):
        idx = perm[bi][slot]  # (M, R, L) original indices
        hit = valid & (_sq_dist(new_xyz[bi, o][:, None, None], xyz[bi][idx]) < r2)
        key = torch.where(hit, idx, n).flatten(1)
        out[bi, o] = _first_hits(key, hit.flatten(1).sum(-1, keepdim=True), nsample)
    return out


def ball_query_tile_candidates(radius: float, xyz, new_xyz, tile: int = TILE_SIZE,
                               side_factor: float = TILE_SIDE_FACTOR, order=None):
    """(tested, staged), both (B, M) int64 at each centre's own row: the
    points a centre tests in kernel G (its own cells, as in B), and the
    points its tile stages (the union)."""
    b, m = new_xyz.shape[:2]
    tested = torch.zeros((b, m), dtype=torch.int64, device=xyz.device)
    staged = torch.zeros_like(tested)
    if m == 0 or xyz.shape[1] == 0:
        return tested, staged
    _, scenes = _tile_candidates_plain(radius, xyz, new_xyz, tile, side_factor, order)
    for bi, (o, _, valid, union) in enumerate(scenes):
        tested[bi, o] = valid.flatten(1).sum(-1)
        staged[bi, o] = union
    return tested, staged


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


def grid_build(radius: float, xyz: torch.Tensor, side_factor: float = GRID_SIDE_FACTOR,
               count_as: str = "ball_query", centres: torch.Tensor | None = None):
    """Kernels B's and F's grid of a CUDA (B, N, 3): (pts (B, N, 4) the
    points ordered by (cell, original index) with the index's bits in the
    fourth lane, starts (B, grid_cap(N) + 1) int32 each cell's first slot in
    that order, fparams (B, 4) f32 the low corner and inverse side, iparams
    (B, 4) int32 the cells a side and in all).  Two launches, counted under
    `count_as`, around a stable `torch.sort` of the keys scene * (cap + 1) +
    cell as one array (one sort over the card, not one a scene).  With
    `centres` (B, M, 3) (kernel G) the same launches and sort also order
    each scene's centres by the Morton key of their cell (keys (B + scene)
    * (cap + 1) + `_tile_keys_plain`, after every point's), and a fifth
    tensor follows: (B, M, 4) f32, the centres in that order with the bits
    of their row scene * M + index in the fourth lane."""
    b, n, _ = xyz.shape
    m = 0 if centres is None else centres.shape[1]
    stride = grid_cap(n) + 1
    ranges = 2 * b if centres is not None else b  # the centres' keys take a second range
    if ranges * stride >= 2 ** 31:
        raise ValueError(f"{count_as}: {ranges} * (grid_cap(N) + 1) = {ranges * stride} keys "
                         "need 2^31 or more")
    # one allocation, cut where each part stays 16-byte aligned: pts,
    # fparams, iparams (16 bytes a row), the sorted centres, starts, keys
    sizes = (4 * b * n, 4 * b, 4 * b, 4 * b * m, b * stride, b * (n + m))
    parts = torch.empty(sum(sizes), dtype=torch.int32, device=xyz.device).split(sizes)
    pts, fparams = parts[0].view(torch.float32).view(b, n, 4), parts[1].view(torch.float32)
    iparams, ctr = parts[2], parts[3].view(torch.float32).view(b, m, 4)
    starts, keys = parts[4].view(b, stride), parts[5]
    _kernels.launch("coda_bq_grid_cells", xyz, centres, fparams, iparams, keys, b, n, m,
                    grid_side(radius, side_factor), stride - 1, count_as=count_as)
    skeys, perm = torch.sort(keys, stable=True)
    _kernels.launch("coda_bq_grid_pack", xyz, centres, skeys, perm, iparams, pts, starts, ctr,
                    b, n, m, stride, count_as=count_as)
    grid = (pts, starts, fparams.view(b, 4), iparams.view(b, 4))
    return grid if centres is None else grid + (ctr,)


def grid_query(radius: float, nsample: int, xyz, new_xyz, grouped: bool = False,
               side_factor: float = GRID_SIDE_FACTOR):
    """Kernel B (or F with `grouped`) on CUDA tensors: the grid build, then
    the query.  Returns idx, or (idx, grouped xyz)."""
    name = "ball_query_group" if grouped else "ball_query"
    _kernels.check_no_grad(name, xyz, new_xyz)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if n < 1:
        raise ValueError(f"{name}: needs N >= 1 (a row with no hit takes point 0)")
    if -(-min(nsample, n) // 32) * 32 > GRID_MAX_SAMPLES:
        raise ValueError(f"{name}: min(nsample, N) = {min(nsample, n)} above the query's "
                         f"{GRID_MAX_SAMPLES}")
    grid = grid_build(radius, xyz, side_factor, name)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    tail = (b, n, m, nsample, grid[1].shape[1], _f32(float(radius) ** 2), grid_radius(radius))
    if not grouped:
        _kernels.launch("coda_ball_query", *grid, new_xyz, idx, *tail)
        return idx
    out = torch.empty((b, m, nsample, 3), dtype=torch.float32, device=xyz.device)
    _kernels.launch("coda_ball_query_group", *grid, new_xyz, xyz, idx, out, *tail)
    return idx, out


def tile_query(radius: float, nsample: int, xyz, new_xyz, tile: int = TILE_SIZE,
               side_factor: float = TILE_SIDE_FACTOR) -> torch.Tensor:
    """Kernel G on CUDA tensors: the grid build with the centres' order,
    then the query, TILE_LAUNCHES launches.  It refuses, before anything is
    built or launched, inputs needing a gradient (RuntimeError), N = 0,
    min(nsample, N) above TILE_MAX_SAMPLES, more than 65535 scenes, a tile
    it is not built for and a cell side below the widened radius
    (ValueError), and `grid_build` key ranges past 2^31."""
    _kernels.check_no_grad("ball_query_tile", xyz, new_xyz)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if n < 1:
        raise ValueError("ball_query_tile: needs N >= 1 (a row with no hit takes point 0)")
    if -(-min(nsample, n) // 32) * 32 > TILE_MAX_SAMPLES:
        raise ValueError(f"ball_query_tile: min(nsample, N) = {min(nsample, n)} above the "
                         f"query's {TILE_MAX_SAMPLES}")
    if b > 65535:
        raise ValueError(f"ball_query_tile: B = {b} scenes, at most 65535")
    if tile not in TILE_SIZES:
        raise ValueError(f"ball_query_tile: a tile of {tile} centres, not one of {TILE_SIZES}")
    if not side_factor >= 1.0:  # a centre then reads at most 4 x 4 rows, a lane each
        raise ValueError(f"ball_query_tile: a cell side of {side_factor} widened radii, below 1")
    *grid, ctr = grid_build(radius, xyz, side_factor, "ball_query_tile", centres=new_xyz)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=xyz.device)
    _kernels.launch("coda_ball_query_tile", *grid, ctr, idx, b, n, m, nsample,
                    grid[1].shape[1], _f32(float(radius) ** 2), grid_radius(radius), tile)
    return idx


def _launch_ball_query(fn: str, radius: float, nsample: int, xyz, new_xyz) -> torch.Tensor:
    if fn == "coda_ball_query":
        return grid_query(radius, nsample, xyz, new_xyz)
    return tile_query(radius, nsample, xyz, new_xyz)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz: (B, N, 3) points, new_xyz: (B, M, 3) centres -> (B, M, nsample) int32."""
    _check_query(nsample, xyz, new_xyz)
    if xyz.device.type == "cpu":
        return ball_query_plain(radius, nsample, xyz, new_xyz)
    return _launch_ball_query(ball_query_kernel(nsample), radius, nsample, xyz, new_xyz)


def ball_query_tile(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """`ball_query` through kernel G whatever the environment says (the plain
    version on a CPU tensor): for holding G against B and the plain version.
    On a CUDA tensor G refuses what `tile_query` lists."""
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
    if xyz.shape[1] < 1:
        raise ValueError("ball_query_group: needs N >= 1 (a row with no hit takes point 0)")
    if xyz.device.type == "cpu":
        return ball_query_group_plain(radius, nsample, xyz, new_xyz)
    return grid_query(radius, nsample, xyz, new_xyz, grouped=True)


def query_and_group(radius: float, nsample: int, xyz, new_xyz, features=None,
                    normalize_xyz: bool = False):
    """Ball query + grouped, re-centred xyz, and the point features grouped
    with the same indices (reference QueryAndGroup, use_xyz).

    features (B, N, C) float32 or None.  Returns (new_features (B, M,
    nsample, 3 + C), grouped_xyz (B, M, nsample, 3)): without features the
    two are the same tensor, as in the JAX package.  The features go through
    kernel C (`group_points`) with the indices of whichever ball-query
    kernel ran, F's included.
    """
    if fused_gather(nsample, xyz.shape[1]):
        idx, grouped = ball_query_group(radius, nsample, xyz, new_xyz)
    else:
        idx = ball_query(radius, nsample, xyz, new_xyz)
        grouped = group_points(xyz, idx)
    grouped_xyz = grouped - new_xyz[:, :, None, :]
    if normalize_xyz:
        grouped_xyz = grouped_xyz / radius
    if features is None:
        return grouped_xyz, grouped_xyz
    return torch.cat([grouped_xyz, group_points(features, idx)], dim=-1), grouped_xyz
