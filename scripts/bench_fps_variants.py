#!/usr/bin/env python3
"""Time kernel A (csrc/fps.cu, a thread-block cluster a scene) against its
one-block form (scripts/fps_variants.cu) and the floor of its loop, on the card.

    python3 scripts/bench_fps_variants.py

At 32 x 20000 -> 2048 (the detector eval's first FPS), 32 x 2048 -> 128
(its second), 8 x 20000 -> 2048 (the training steps') and 8 x 40000 -> 2048
(ScanNet's point count): both kernels are first checked bit for bit against
the plain version, then timed in turns twice (CUDA events around 5
back-to-back calls, median of 7): the one-block kernel, kernel A at the
cluster size its policy picks, kernel A at every other cluster size that
takes the scene, and at each cluster size the floor, kernel A's loop with
the points' work taken out (its barriers and cross-block merge); and the
host's time a `furthest_point_sample` call takes to return.  Needs a
GPU and nvcc; builds the one-block kernel into build/.
"""
import ctypes
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from coda_neurips2023_tpu_torch import _kernels  # noqa: E402
from coda_neurips2023_tpu_torch.ops import sampling  # noqa: E402
from coda_neurips2023_tpu_torch.utils.device import multi_processor_count  # noqa: E402


def time_ms(fn, reps=7, inner=5):
    for _ in range(2):
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


def main():
    if not torch.cuda.is_available():
        sys.exit("bench_fps_variants: needs a CUDA device")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    so = os.path.join(root, "build", "fps_variants.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(root, "scripts", "fps_variants.cu")],
                   check=True, stdout=subprocess.DEVNULL)
    old = ctypes.CDLL(so).fps_one_block
    old.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib = _kernels.library()
    sms = multi_processor_count("cuda")
    dev = torch.device("cuda")
    resident = {c: sampling.resident_clusters(dev, c) for c in sampling.FPS_CLUSTER_SIZES}
    print(f"SMs {sms}; clusters of kernel A the card runs at once, by size: {resident}")
    g = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for b, n, m in ((32, 20000, 2048), (32, 2048, 128), (8, 20000, 2048), (8, 40000, 2048)):
        xyz = torch.randn((b, n, 3), device="cuda", generator=g) * 3
        xyz[:, 1:50] = 0.0  # invalid points
        out = torch.empty((b, m), dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def one_block():
            err = old(xyz.data_ptr(), out.data_ptr(), b, n, m, stream)
            if err:
                raise RuntimeError(f"fps_one_block: CUDA error {err}")
            return out

        def floor(cs):
            err = lib.coda_fps_barrier_floor(xyz.data_ptr(), out.data_ptr(), b, n, m, cs, stream)
            if err:
                raise RuntimeError(f"coda_fps_barrier_floor: CUDA error {err}")

        want = sampling.furthest_point_sample_plain(xyz, m)
        chosen = sampling.fps_cluster_size(b, n, sms, resident.get)
        sizes = [c for c in sampling.FPS_CLUSTER_SIZES
                 if c * sampling.FPS_THREADS * sampling.FPS_MAX_POINTS_PER_THREAD >= n]
        equal = torch.equal(one_block(), want)
        fns = {"one_block": one_block}
        for cs in sizes:
            equal = equal and torch.equal(sampling._fps_kernel(xyz, m, cs), want)
            fns[f"cluster{cs}"] = lambda cs=cs: sampling._fps_kernel(xyz, m, cs)
            fns[f"floor{cs}"] = lambda cs=cs: floor(cs)
        ok = ok and equal
        times = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                times[name].append(time_ms(fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            sampling.furthest_point_sample(xyz, m)
        host_us = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
        print(f"A B={b} N={n} -> {m}: bit-equal={equal} policy=cluster{chosen} "
              + " ".join(f"{name}_ms={statistics.fmean(t)!r}" for name, t in times.items())
              + f" host_us_a_call={host_us!r}")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
