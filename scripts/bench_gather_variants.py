#!/usr/bin/env python3
"""Time the gather layouts of scripts/gather_variants.cu against kernel C and
torch.gather on the card: the xyz layouts at the SA's shape (B = 32 and 8
scenes of 20000 points, 2048 centres x 64 neighbours), the wide layouts at
the masked encoder's interim set abstraction (32 scenes of 2048 points with
C = 64, 128 and 256 features, 1024 centres x 32 neighbours, indices padded
as the ball query pads them), with the bytes bound of each wide shape.

    python3 scripts/bench_gather_variants.py [--parent DIR]

With --parent DIR (an earlier checkout), its csrc/gather.cu is built beside
this tree's and the two `coda_gather`s are timed in turns (parent, this,
this, parent) on chip_smoke.py phase 3's xyz rows (32 synthetic scenes of
20000 points, seed 0, 2048 FPS centres, ball query r = 0.2, k = 64) and on
the C = 256 interim shape, through their C interface.

Each variant is first checked bit for bit against the plain gather; times
are CUDA events around 20 back-to-back calls, median of 20, the functions
timed in turns twice.  Needs a GPU and nvcc; builds into build/.
"""
import argparse
import ctypes
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from coda_neurips2023_tpu_torch.ops.grouping import group_points, group_points_plain  # noqa: E402

parser = argparse.ArgumentParser()
parser.add_argument("--parent", help="an earlier checkout whose kernel C is timed beside this one")
args = parser.parse_args()
here = os.path.dirname(os.path.abspath(__file__))
root = os.path.dirname(here)
build = os.path.join(root, "build")
os.makedirs(build, exist_ok=True)
NVCC = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"), "-gencode",
        "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]


def build_so(src, name):
    so = os.path.join(build, name)
    subprocess.run(NVCC + ["-o", so, src], check=True)
    return ctypes.CDLL(so)


print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())
lib = build_so(os.path.join(here, "gather_variants.cu"), "gather_variants.so")
lib.gv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
lib.gw.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
HBM_RATE = 3.35e12  # bytes/s, NVIDIA's H100 SXM data sheet


def time_ms(fn, reps=20, inner=20):
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


g = torch.Generator(device="cuda").manual_seed(0)
for (b, n, m, k) in ((32, 20000, 2048, 64), (8, 20000, 2048, 64)):
    xyz = torch.randn((b, n, 3), device="cuda", generator=g)
    idx = torch.randint(0, n, (b, m, k), device="cuda", generator=g, dtype=torch.int32)
    want = group_points_plain(xyz, idx)
    out = torch.empty_like(want)
    st = torch.cuda.current_stream().cuda_stream
    fns = {}
    for w in (2, 6, 8, 9, 10):
        def f(w=w):
            lib.gv(w, xyz.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m * k, st)
        f()
        torch.cuda.synchronize()
        assert torch.equal(out, want), w
        fns[f"v{w}"] = f
    fns["kernelC"] = lambda: group_points(xyz, idx)
    flat = idx.reshape(b, -1, 1).long().expand(-1, -1, 3)
    fns["torch.gather"] = lambda: torch.gather(xyz, 1, flat)
    res = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            res[name].append(time_ms(fn))
    print(f"B={b}", {name: round(statistics.fmean(v), 4) for name, v in res.items()})


def padded_indices(b, n, m, k, gen):
    """(b, m, k) int32 in [0, n): each row's first h slots drawn, h in [1, k],
    the rest repeating the first, as the ball query pads a row."""
    idx = torch.randint(0, n, (b, m, k), device="cuda", generator=gen, dtype=torch.int32)
    hits = torch.randint(1, k + 1, (b, m, 1), device="cuda", generator=gen)
    slot = torch.arange(k, device="cuda")
    return torch.where(slot < hits, idx, idx[..., :1])


WIDE = {"w0 thread a row": 0, "w1 tile b8 stcs": 1, "w2 tile b8 plain": 2, "w3 tile b4 stcs": 3,
        "w4 tile b16 stcs": 4}
for (b, n, m, k, c) in ((32, 2048, 1024, 32, 64), (32, 2048, 1024, 32, 128),
                        (32, 2048, 1024, 32, 256)):
    feats = torch.randn((b, n, c), device="cuda", generator=g)
    idx = padded_indices(b, n, m, k, g)
    want = group_points_plain(feats, idx)
    out = torch.empty_like(want)
    st = torch.cuda.current_stream().cuda_stream
    fns = {}
    for name, w in WIDE.items():
        def f(w=w):
            err = lib.gw(w, feats.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n, m * k, c, st)
            assert err == 0, err
        out.zero_()
        f()
        torch.cuda.synchronize()
        assert torch.equal(out, want), name
        fns[name] = f
    assert torch.equal(group_points(feats, idx), want)
    fns["kernelC"] = lambda: group_points(feats, idx)
    flat = idx.reshape(b, -1, 1).long().expand(-1, -1, c)
    fns["torch.gather"] = lambda: torch.gather(feats, 1, flat)
    res = {name: [] for name in fns}
    for _ in range(2):
        for name, fn in fns.items():
            res[name].append(time_ms(fn))
    bound_ms = 4 * (feats.numel() + idx.numel() + want.numel()) / HBM_RATE * 1e3
    print(f"B={b} N={n} M={m} K={k} C={c} bound_ms={bound_ms!r}",
          {name: round(statistics.fmean(v), 4) for name, v in res.items()})


if args.parent:
    from coda_neurips2023_tpu_torch.datasets.config import SunrgbdAnonymousConfig
    from coda_neurips2023_tpu_torch.datasets.synthetic import SyntheticDetectionDataset, make_batch
    from coda_neurips2023_tpu_torch.ops.grouping import ball_query
    from coda_neurips2023_tpu_torch.ops.sampling import furthest_point_sample, gather_points

    csrc = "coda_neurips2023_tpu_torch/csrc/gather.cu"
    libs = {"parent": build_so(os.path.join(args.parent, csrc), "gather_parent.so"),
            "this": build_so(os.path.join(root, csrc), "gather_this.so")}
    for one in libs.values():
        one.coda_gather.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    ds = SyntheticDetectionDataset(SunrgbdAnonymousConfig(), num_scenes=32, num_points=20000, seed=0)
    xyz = torch.from_numpy(make_batch(ds, 0, 32)["point_clouds"][..., :3].copy()).cuda().contiguous()
    centres = gather_points(xyz, furthest_point_sample(xyz, 2048))
    cases = {"xyz B=32 N=20000 M=2048 K=64 C=3": (xyz, ball_query(0.2, 64, xyz, centres))}
    feats = torch.randn((32, 2048, 256), device="cuda", generator=g)
    cases["interim B=32 N=2048 M=1024 K=32 C=256"] = (feats, padded_indices(32, 2048, 1024, 32, g))
    for label, (f, idx) in cases.items():
        b, n, c = f.shape
        want = group_points_plain(f, idx)
        outs = {name: torch.empty_like(want) for name in libs}
        st = torch.cuda.current_stream().cuda_stream
        fns = {}
        for name, one in libs.items():
            def call(one=one, out=outs[name]):
                err = one.coda_gather(f.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n,
                                      idx.shape[1] * idx.shape[2], c, st)
                assert err == 0, err
            call()
            torch.cuda.synchronize()
            assert torch.equal(outs[name], want), name
            fns[name] = call
        res = {name: [] for name in fns}
        for order in (("parent", "this"), ("this", "parent")):
            for name in order:
                res[name].append(time_ms(fns[name]))
        print(label, {name: [round(t, 4) for t in v] for name, v in res.items()})
