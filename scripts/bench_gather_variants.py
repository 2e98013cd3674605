#!/usr/bin/env python3
"""Time the xyz-gather layouts of scripts/gather_variants.cu against kernel C
and torch.gather on the card, at the SA's shape (B = 32 and 8 scenes of
20000 points, 2048 centres x 64 neighbours).

    python3 scripts/bench_gather_variants.py

Each variant is first checked bit for bit against the plain gather; times
are CUDA events around 20 back-to-back calls, median of 20, the functions
timed in turns twice.  Needs a GPU and nvcc; builds into build/.
"""
import ctypes
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from coda_neurips2023_tpu_torch.ops.grouping import group_points, group_points_plain  # noqa: E402

here = os.path.dirname(os.path.abspath(__file__))
build = os.path.join(os.path.dirname(here), "build")
os.makedirs(build, exist_ok=True)
so = os.path.join(build, "gather_variants.so")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())
subprocess.run([os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                "-Xcompiler", "-fPIC", "-o", so, os.path.join(here, "gather_variants.cu")],
               check=True)
lib = ctypes.CDLL(so)
lib.gv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


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
